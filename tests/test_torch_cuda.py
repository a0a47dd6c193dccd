"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without an NVIDIA GPU (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    init_fused_params,
)
from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
from image_super_resolution_tpu_torch.ops.scatter import rdb_params_to_scatter

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a); the CPU tests cover the plain versions")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mats(card):
    spec = DeploySpec(family="sr", depth=1, width=64, scale=4)
    scatter = rdb_params_to_scatter(init_fused_params(spec, seed=0)["rrdb0"]["rdb1"])
    return [t.to(card) for t in k1.scatter_params_to_matmul(scatter)]


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (2, 8, 8), (3, 17, 29), (1, 33, 130),
                                   (1, 9, 25), (2, 24, 24), (1, 7, 200), (1, 96, 128),
                                   (3, 200, 300), (1, 23, 47), (2, 270, 480)])
def test_fused_rdb_matches_plain_version(card, mats, b, h, w):
    """Any batch and any H, W: images smaller than one 24 x 24 rectangle,
    rectangles that straddle both image edges (9 x 25), the serving tile,
    rows much wider than a rectangle, a whole-image sr input, more
    rectangles than SMs (351: each persistent block walks several), a
    ragged bottom and right edge met by every row and column of a
    rectangle's 8 x 8 row tiles (23 x 47), and two frames of the benchmark's
    frame shape (270 x 480). Tolerance:
    KERNEL_ATOL + KERNEL_RTOL|want| (a few bf16 ulps; the two sum each conv
    in another order)."""
    rng = np.random.default_rng(b * 1000 + h * 10 + w)
    x = torch.from_numpy(rng.standard_normal((b, h, w, k1.C), np.float32))
    x = x.to(card, torch.bfloat16)
    before = k1.scatter_rdb.launches
    got = k1.scatter_rdb(x, *mats)
    torch.cuda.synchronize()
    assert k1.scatter_rdb.launches == before + 1
    want = k1.scatter_rdb_reference(x, *mats)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=k1.KERNEL_ATOL,
                               rtol=k1.KERNEL_RTOL)


def test_fused_rdb_counts_rectangles_and_blocks(card, mats):
    """One call at the frames shape: five launches of min(rectangles, SMs)
    persistent blocks, counted beside the one launch."""
    x = torch.zeros(8, 270, 480, k1.C, device=card, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    before = k1.scatter_rdb.launches, k1.scatter_rdb.tiles, k1.scatter_rdb.blocks
    k1.scatter_rdb(x, *mats)
    torch.cuda.synchronize()
    after = k1.scatter_rdb.launches, k1.scatter_rdb.tiles, k1.scatter_rdb.blocks
    assert [a - b for a, b in zip(after, before)] == [1, 5 * 1920, 5 * min(1920, sms)]


def test_fused_rdb_is_deterministic(card, mats):
    """No atomics: two calls on the same input are bitwise equal."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 24, 24, k1.C), np.float32))
    x = x.to(card, torch.bfloat16)
    first = k1.scatter_rdb(x, *mats)
    second = k1.scatter_rdb(x, *mats)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_rdb_rejects_what_it_does_not_take(card, mats):
    x = torch.zeros(1, 4, 4, k1.C, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        k1.scatter_rdb(x.float(), *mats)
    with pytest.raises(ValueError):
        k1.scatter_rdb(torch.zeros(1, 4, 4, 32, device=card, dtype=torch.bfloat16), *mats)
    with pytest.raises(TypeError):
        k1.scatter_rdb(x, mats[0].float(), *mats[1:])
    with pytest.raises(ValueError):
        k1.scatter_rdb(x, *mats[:-1], mats[-1].cpu())


def test_deployed_model_on_card_launches_three_per_rrdb(card):
    """bf16 DeployedModel on the card: every RDB goes through the kernel, and
    the uint8 output stays within BF16_MAX_LSB of the port's fp32 CPU path."""
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB

    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    params = init_fused_params(spec, seed=3)
    x = np.random.default_rng(3).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    before = k1.scatter_rdb.launches
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cuda")(x)
    assert k1.scatter_rdb.launches - before == 3 * spec.depth
    want = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    diff = (got.cpu().int() - want.int()).abs()
    assert got.shape == (2, 96, 80, 3)
    assert diff.max().item() <= BF16_MAX_LSB


@pytest.mark.parametrize("m,dtype", [(2, torch.bfloat16), (4, torch.float32)])
def test_winograd_deployment_on_card_launches_no_k1(card, m, dtype, monkeypatch):
    """``wino_m`` on the card (F(2,3) in bf16, F(4,3) in fp32): no K1 launch;
    within WINO_BF16_MAX_LSB / WINO_FP32_MAX_LSB of the port's fp32 direct
    CPU path, and within 1 LSB of the same Winograd graph on the CPU (the
    card's bf16 products keep fp32 sums through ``bmm``'s ``out_dtype``)."""
    from image_super_resolution_tpu_torch.models.deploy import (WINO_BF16_MAX_LSB,
                                                                WINO_FP32_MAX_LSB)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    params = init_fused_params(spec, seed=3)
    x = np.random.default_rng(3).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    before = k1.scatter_rdb.launches
    got = DeployedModel(spec, params, dtype=dtype, device="cuda", wino_m=m)(x).cpu().int()
    assert k1.scatter_rdb.launches == before
    direct = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x).int()
    same = DeployedModel(spec, params, dtype=dtype, device="cpu", wino_m=m)(x).int()
    bound = WINO_BF16_MAX_LSB if m == 2 else WINO_FP32_MAX_LSB
    assert got.shape == (2, 96, 80, 3)
    assert (got - direct).abs().max().item() <= bound
    assert (got - same).abs().max().item() <= 1


# --------------------------------------------------------------- K2 (matmul) --

from image_super_resolution_tpu_torch.ops.kernels import matmul as k2  # noqa: E402


@pytest.mark.parametrize("m,k,n", [(128, 32, 128), (1, 64, 1), (300, 1152, 130),
                                   (1024, 2048, 1000), (64, 96, 1040)])
def test_matmul_int8_exact_on_card(card, m, k, n):
    """int8 -> int32 equals the integer product exactly, for ragged M, N and
    K against the 128 x 256 x 128 tiles (TMA fills zeros past the edges;
    N % 16 != 0 takes the transpose kernel's masked byte loads)."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(card)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(card)
    before = k2.matmul.launches
    got = k2.matmul(a, b)
    torch.cuda.synchronize()
    assert k2.matmul.launches == before + 1
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, k2.matmul_reference(a, b), rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(256, 512, 128), (77, 48, 33)])
def test_matmul_bf16_on_card(card, m, k, n):
    """bf16 -> fp32 against float64: within BF16_ATOL_PER_K * K * max|a| max|b|
    (fp32 sums of exact products, in another order)."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(card, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(card, torch.bfloat16)
    got = k2.matmul(a, b)
    tol = k2.BF16_ATOL_PER_K * k * float(a.float().abs().max() * b.float().abs().max())
    torch.testing.assert_close(got, k2.matmul_reference(a, b), rtol=0, atol=tol)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 24, 24, 128, 128), (3, 17, 29, 128, 128),
                                            (1, 1, 1, 32, 8), (1, 5, 3, 64, 130),
                                            (2, 48, 48, 128, 128), (1, 93, 93, 128, 128),
                                            (1, 9, 20, 160, 40)])
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("x_kind", ["int8_values", "stream", "int8"])
@pytest.mark.parametrize("out", ["fp32", "int8"])
def test_conv3x3_int8_exact_on_card(card, b, h, w, cin, cout, leaky, x_kind, out):
    """The int8 conv site equals its plain version bit for bit: the same
    requantization of an fp32 input, exact int32 sums, the same fp32
    epilogue, each op rounded once, and for int8 outputs the same
    requantization with out_inv_x. Inputs: every int8 value as fp32 with
    scale 1, the fp32 stream with ties and values past +-127 steps, and
    int8 itself. Shapes: the serving tile, denoise_fast's 48x48 and a
    ragged CLI tile, ragged and tiny images, Cout not a multiple of 128,
    and Cin 160 (K chunks of 32 channels)."""
    rng = np.random.default_rng(b * h * w + cout)
    x8 = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8))
    if x_kind == "stream":
        x = torch.from_numpy(rng.standard_normal((b, h, w, cin), np.float32) * 40)
        x[..., :4] = torch.tensor([0.5, -2.5, 300.0, -1e6]) / 0.25
        x, inv_x = x.to(card), 0.25
    elif x_kind == "int8_values":
        x, inv_x = x8.to(card).float(), 1.0
    else:
        x, inv_x = x8.to(card), None
    out_inv_x = 1.0 if out == "int8" else None
    w_q = torch.from_numpy(rng.integers(-127, 128, (9 * cin, cout), dtype=np.int8)).to(card)
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32)).to(card)
    before = k2.conv3x3_int8.launches
    got = k2.conv3x3_int8(x, w_q, deq, bias, leaky, inv_x, out_inv_x,
                          w_k=k2.weights_k_major(w_q))
    want = k2.conv3x3_int8_reference(x, w_q, deq, bias, leaky, inv_x, out_inv_x)
    torch.cuda.synchronize()
    assert k2.conv3x3_int8.launches == before + 1
    assert got.dtype == want.dtype == (torch.int8 if out == "int8" else torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 24, 24, 128, 128), (2, 17, 29, 128, 128),
                                            (1, 5, 3, 64, 130), (1, 9, 20, 160, 40)])
@pytest.mark.parametrize("x_kind", ["int8", "stream"])
@pytest.mark.parametrize("out", ["fp32", "int8", "both"])
@pytest.mark.parametrize("rate", [0.2, 1.0])
def test_conv3x3_int8_residual_epilogue_exact_on_card(card, b, h, w, cin, cout, x_kind, out,
                                                      rate):
    """The epilogue that finishes a residual block (res + y * rate, then
    fp32, int8 or both stored) equals its plain version bit for bit: whole
    N tiles, H and W not multiples of the 24 x 8 rectangle, Cout not a
    multiple of 128 (130, 40) and K chunks (Cin 160). The residual holds
    values whose int8 copy lands past +-127 steps."""
    rng = np.random.default_rng(b * h * w + cout + int(10 * rate))
    if x_kind == "stream":
        x = torch.from_numpy(rng.standard_normal((b, h, w, cin), np.float32) * 40).to(card)
        inv_x = 0.25
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(card)
        inv_x = None
    res = torch.from_numpy(rng.standard_normal((b, h, w, cout), np.float32) * 4)
    res[..., :2] = torch.tensor([-1e4, 1e4])
    res = res.to(card)
    w_q = torch.from_numpy(rng.integers(-127, 128, (9 * cin, cout), dtype=np.int8)).to(card)
    deq = torch.from_numpy(rng.uniform(1e-5, 1e-4, cout).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32)).to(card)
    kw = dict(out_inv_x=None if out == "fp32" else 2.0, res=res, rate=rate,
              keep_fp32=out == "both")
    before = dict(k2.conv3x3_int8.launches_by_epilogue)
    got = k2.conv3x3_int8(x, w_q, deq, bias, False, inv_x, w_k=k2.weights_k_major(w_q), **kw)
    want = k2.conv3x3_int8_reference(x, w_q, deq, bias, False, inv_x, **kw)
    torch.cuda.synchronize()
    after = k2.conv3x3_int8.launches_by_epilogue
    assert after["residual"] == before.get("residual", 0) + 1
    assert after.get("int8 copy", 0) == before.get("int8 copy", 0) + (out != "fp32")
    got, want = (got, want) if out == "both" else ((got,), (want,))
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype
        torch.testing.assert_close(g, wt, rtol=0, atol=0)


def test_k2_rejects_what_it_does_not_take(card):
    a = torch.zeros(4, 48, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="multiple of 32"):
        k2.matmul(a, torch.zeros(48, 8, dtype=torch.int8, device=card))
    with pytest.raises(TypeError):
        k2.matmul(a.float(), a.float().t())
    x = torch.zeros(1, 4, 4, 16, device=card)
    w_q, zero = torch.zeros(144, 16, dtype=torch.int8, device=card), torch.zeros(16, device=card)
    with pytest.raises(ValueError, match="multiple of 32"):
        k2.conv3x3_int8(x, w_q, zero, zero, True, inv_x=0.5, w_k=w_q)
    x8 = torch.zeros(1, 4, 4, 32, dtype=torch.int8, device=card)
    w_q, zero = torch.zeros(288, 8, dtype=torch.int8, device=card), torch.zeros(8, device=card)
    with pytest.raises(TypeError, match="inv_x"):  # int8 x is taken as it is: no scale
        k2.conv3x3_int8(x8, w_q, zero, zero, True, inv_x=0.5)
    with pytest.raises(ValueError, match="w_k"):  # the K-major copy must be padded to 128
        k2.conv3x3_int8(x8, w_q, zero, zero, True, w_k=w_q.t().contiguous())
    with pytest.raises(ValueError, match="w_k"):  # laid out by the caller, never per call
        k2.conv3x3_int8(x8, w_q, zero, zero, True)


@pytest.mark.parametrize("depth", [2, 14])
def test_int8_fast_on_card_launches_per_site(card, depth):
    """fast x4 int8 on the card: every trunk site goes through the kernel
    (2 * depth + 1 launches per forward: 29 at the served depth 14), with
    the K-major weights laid out once. Block 0's conv0 loads the head's
    fp32 output; every other site is handed int8 by the one before it.
    By variant per forward: block 0's conv0 "fp32 -> int8"; the other
    conv0 sites and the last conv1 "int8 -> int8"; the other conv1 sites
    (fp32 and int8 out) and trunk_conv "int8 -> fp32". By epilogue: the
    depth conv1 sites and trunk_conv add a residual (15 at depth 14), the
    conv1 sites store its int8 copy. The uint8 output stays within
    INT8_CARD_MAX_LSB of the port's int8 CPU path on the same quantized
    params."""
    from image_super_resolution_tpu_torch.models import quantized as q
    from image_super_resolution_tpu_torch.models.quantized import (
        INT8_CARD_MAX_LSB, Int8DeployedFast, quantize_deployed)

    spec = DeploySpec(family="fast", depth=depth, width=128, scale=4)
    params = init_fused_params(spec, seed=4)
    x = np.random.default_rng(4).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    quant = quantize_deployed(DeployedModel(spec, params, device="cuda"), [x])
    assert all(quant.params[s]["w_k"].shape == (128, 9 * 128) for s in q.trunk_sites(depth))
    dtypes = []
    orig = q.quant_site

    def spy(p, h, *args, **kwargs):
        y = orig(p, h, *args, **kwargs)
        dtypes.append((h.dtype, tuple(t.dtype for t in (y if isinstance(y, tuple) else (y,))),
                       kwargs.get("res") is not None))
        return y

    q.quant_site = spy
    try:
        before = k2.conv3x3_int8.launches
        k2.conv3x3_int8.launches_by_variant.clear()
        k2.conv3x3_int8.launches_by_epilogue.clear()
        got = quant(x)
    finally:
        q.quant_site = orig
    assert k2.conv3x3_int8.launches - before == 2 * spec.depth + 1
    assert k2.conv3x3_int8.launches_by_variant == {
        "fp32 -> int8": 1, "int8 -> int8": depth, "int8 -> fp32": depth}
    assert k2.conv3x3_int8.launches_by_epilogue == {"residual": depth + 1, "int8 copy": depth}
    f32, i8 = torch.float32, torch.int8
    conv0 = [(f32, (i8,), False)] + [(i8, (i8,), False)] * (depth - 1)
    conv1 = [(i8, (f32, i8), True)] * (depth - 1) + [(i8, (i8,), True)]
    assert dtypes == [site for pair in zip(conv0, conv1) for site in pair] + [(i8, (f32,), True)]
    cpu = Int8DeployedFast(spec, quant.params, device="cpu")
    diff = (got.cpu().int() - cpu(x).int()).abs()
    assert got.shape == (2, 96, 80, 3)
    assert diff.max().item() <= INT8_CARD_MAX_LSB


# ----------------------------------------------------- training, slice 5 --

def _pixel_state(device, seed=0):
    from image_super_resolution_tpu_torch.models.generator import SRGenerator
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.state import TrainState

    model = init_weights(SRGenerator(depth=2, width=64, scale=2, fused=False,
                                     param_dtype=torch.float32, device=device), seed)
    return TrainState(model, lr=1e-3, total_steps=10, ema_tau=10)


def test_bn_pixel_step_on_card_matches_cpu(card):
    """Three pixel steps of the BN generator (x2, depth 2, width 64) in fp32
    with TF32 off, on the card and on the CPU from the same seed. Each loss
    within 1e-5 relative, each gradient element within 1e-3 of the model's
    largest gradient (cuDNN and the CPU sum in other orders, thousands of
    cancelling terms per weight gradient: 2.1e-4 measured by chip_smoke.py
    on another seed; BN makes some gradients nearly zero but for border
    terms, so a tensor's own largest is no scale). Then the card's
    gradients are replaced by the CPU's, so that the card's optimizer (clip,
    the fused Adam, BN commit, EMA) works on what the CPU's does, which
    test_torch_train.py holds against optax: params and EMA params within
    1e-6 of max(1, |param|) (a no-op or wrong Adam is off by about lr),
    BN running statistics and their EMA within 1e-5."""
    from image_super_resolution_tpu_torch.train.steps import make_pixel_train_step

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    step = make_pixel_train_step(2)
    rng = np.random.default_rng(0)
    card_st, cpu_st = _pixel_state(card), _pixel_state("cpu")
    try:
        for _ in range(3):
            u8 = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
            losses = []
            for st, dev in ((card_st, card), (cpu_st, "cpu")):
                hr, x = step.batch_fn(u8.to(dev))
                loss = step.loss_fn(st.model(x), hr)
                loss.backward()
                losses.append(loss.item())
            assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
            scale = max(p.grad.abs().max().item() for p in cpu_st.params)
            for (name, p_card), p_cpu in zip(card_st.model.named_parameters(), cpu_st.params):
                assert (p_card.grad.cpu() - p_cpu.grad).abs().max().item() <= 1e-3 * scale, name
                p_card.grad.copy_(p_cpu.grad)
            for st in (card_st, cpu_st):
                st.clip_and_adam()
                st.commit_and_ema()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in ((card_st.model.state_dict(), cpu_st.model.state_dict()),
                      (card_st.ema.state_dict(), cpu_st.ema.state_dict())):
        for name, w in want.items():
            diff = (got[name].cpu() - w).abs()
            if "running" in name:
                assert diff.max().item() <= 1e-5, name
            else:
                assert (diff / w.abs().clamp_min(1.0)).max().item() <= 1e-6, name


@pytest.mark.parametrize("family", ["denoise", "denoise_legacy"])
def test_denoise_families_on_card_within_bound(card, family):
    """The x1 denoisers in bf16 on the card against the port's fp32 CPU
    path: within DENOISE_BF16_MAX_LSB (at full width, depth 16 / 8)."""
    from image_super_resolution_tpu_torch.models.deploy import DENOISE_BF16_MAX_LSB

    spec = DeploySpec(family=family, depth=16 if family == "denoise" else 8, width=64)
    params = init_fused_params(spec, seed=5)
    x = np.random.default_rng(5).integers(0, 256, (2, 48, 40, 3), dtype=np.uint8)
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cuda")(x)
    want = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    assert got.shape == (2, 48, 40, 3)
    assert (got.cpu().int() - want.int()).abs().max().item() <= DENOISE_BF16_MAX_LSB


def _gan_states(device):
    """G (BN, x2, depth 2, width 64), D (3, 64, 8, 1024) and VGG19 truncated
    at (1, 2), before its first max-pool, on random features, all fp32 at
    the GAN phase's lr 1e-4, from fixed seeds."""
    from image_super_resolution_tpu_torch.losses.perceptual import PerceptualLoss
    from image_super_resolution_tpu_torch.models.discriminator import Discriminator
    from image_super_resolution_tpu_torch.models.generator import SRGenerator
    from image_super_resolution_tpu_torch.models.vgg import TruncatedVGG19, init_random_vgg
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.state import TrainState

    g = init_weights(SRGenerator(depth=2, width=64, scale=2, fused=False,
                                 param_dtype=torch.float32, device=device), 0)
    d = init_weights(Discriminator(dtype=torch.float32, device=device), 1)
    vgg = init_random_vgg(TruncatedVGG19(1, 2, dtype=torch.float32, device=device))
    return (TrainState(g, lr=1e-4, total_steps=10, ema_tau=10),
            TrainState(d, lr=1e-4, total_steps=10, with_ema=False),
            PerceptualLoss(vgg, feature_norm=True))


def test_gan_step_on_card_matches_cpu(card):
    """Three GAN steps (G as in the pixel test, the full-width D, VGG19 up
    to its first max-pool) in fp32 with TF32 off, on the card and on the CPU
    from the same seeds. Each of the three losses within 1e-4 relative (D's
    logits sum 36 * 512 features through seven BNs: measured 1.95e-5 on an
    H100); G's and then D's gradients, each element within 1e-3 of that
    model's largest gradient but for at most 0.1% of its elements (see
    below), checked where the step's ``mark`` reports them and replaced by
    the CPU's, so that both optimizers take the same gradients: then G's
    params and EMA and D's params within 1e-6, and the BN running statistics
    of both (D's folded from two forwards a step) and G's EMA of them within
    1e-5, each of max(1, |value|).

    A few elements may be off, and VGG stops before its first max-pool,
    because a leaky ReLU's slope and a max-pool's argmax change at a point:
    where a pre-activation lies within the devices' rounding of 0, or two
    inputs of a pool window of each other, the card and the CPU
    back-propagate differently, both right. Measured on an H100: a flipped
    slope in D's block1 moved 225 elements of its kernel gradient (one
    output channel's) by up to 4.8e-3 of D's largest gradient; a flipped
    argmax in VGG (5, 4) moved one input gradient by 1.4e-2 of the largest
    (scripts/torch_gan_card_probe.py). lr is the GAN phase's 1e-4: at 1e-3
    the full-width D saturates within two steps and its BCE and gradients
    shrink to rounding noise."""
    from image_super_resolution_tpu_torch.train.steps import make_gan_train_step

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    card_g, card_d, card_perc = _gan_states(card)
    cpu_g, cpu_d, cpu_perc = _gan_states("cpu")
    want_grads = {}

    def record(part):
        for st, key in ((cpu_g, "G backward"), (cpu_d, "D backward")):
            if part == key:
                want_grads[key] = [p.grad.clone() for p in st.params]

    def check_and_replace(part):
        for st, key in ((card_g, "G backward"), (card_d, "D backward")):
            if part == key:
                scale = max(g.abs().max().item() for g in want_grads[key])
                off = sum(int(((p.grad.cpu() - g).abs() > 1e-3 * scale).sum())
                          for p, g in zip(st.params, want_grads[key]))
                assert off <= 1e-3 * sum(g.numel() for g in want_grads[key]), (key, off)
                for p, g in zip(st.params, want_grads[key]):
                    p.grad.copy_(g)

    try:
        for _ in range(3):
            u8 = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
            want = make_gan_train_step(2, cpu_perc)(cpu_g, cpu_d, u8, record)
            got = make_gan_train_step(2, card_perc)(card_g, card_d, u8.to(card),
                                                    check_and_replace)
            for k, w in want.items():
                assert abs(got[k].item() - w.item()) <= 1e-4 * abs(w.item()), k
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in ((card_g.model.state_dict(), cpu_g.model.state_dict()),
                      (card_g.ema.state_dict(), cpu_g.ema.state_dict()),
                      (card_d.model.state_dict(), cpu_d.model.state_dict())):
        for name, w in want.items():
            rel = ((got[name].cpu() - w).abs() / w.abs().clamp_min(1.0)).max().item()
            assert rel <= (1e-5 if "running" in name else 1e-6), name


def test_discriminator_and_vgg_bf16_on_card_match_fp32(card):
    """The full-width D (train and eval mode) and VGG19 (5, 4) in bf16 on the
    card against fp32 on the CPU, at 2x96x96: D's logits within 3% of the
    largest fp32 logit and VGG's features within 3% of the largest fp32
    feature (the CPU's own bf16 runs: within 1.2% and 1.1%,
    tests/test_torch_gan.py::test_discriminator_and_vgg_bf16_match_fp32)."""
    from image_super_resolution_tpu_torch.models.discriminator import Discriminator
    from image_super_resolution_tpu_torch.models.vgg import TruncatedVGG19, init_random_vgg
    from image_super_resolution_tpu_torch.ops.initializers import init_weights

    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 96, 96, 3),
                                                                  dtype=np.float32))
    d32 = init_weights(Discriminator(dtype=torch.float32, device="cpu"), 0)
    d16 = Discriminator(device=card)
    d16.load_state_dict(d32.state_dict())
    v32 = init_random_vgg(TruncatedVGG19(dtype=torch.float32, device="cpu"))
    v16 = TruncatedVGG19(device=card)
    v16.load_state_dict(v32.state_dict())
    with torch.no_grad():
        for mode in ("train", "eval"):
            want = getattr(d32, mode)()(x)
            got = getattr(d16, mode)()(x.to(card)).cpu()
            assert got.dtype == torch.float32 and got.shape == (2, 1)
            assert (got - want).abs().max().item() <= 0.03 * want.abs().max().item(), mode
        want, got = v32(x), v16(x.to(card)).cpu()
    assert got.shape == want.shape == (2, 6, 6, 512)
    assert (got - want).abs().max().item() <= 0.03 * want.abs().max().item()


def test_build_deployed_launches_k1_and_k2(card, tmp_path):
    """A checkpoint written by training serves through the kernels:
    build_deployed of the BN generator launches K1 three times per RRDB,
    and of the fast generator, quantized, K2 at each of its 2 * depth + 1
    trunk sites, by variant."""
    from image_super_resolution_tpu_torch.models.deploy import build_deployed
    from image_super_resolution_tpu_torch.models.fast import FastSRGenerator
    from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)
    from image_super_resolution_tpu_torch.train.state import TrainState
    from image_super_resolution_tpu_torch.train.steps import make_pixel_train_step

    x = np.random.default_rng(6).integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    u8 = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (4, 96, 96, 3),
                                                            dtype=np.uint8)).to(card)
    sr = _pixel_state(card)
    make_pixel_train_step(2)(sr, u8)
    save_checkpoint(tmp_path / "sr.ckpt", sr, 0, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2))
    model, _ = build_deployed(load_checkpoint(tmp_path / "sr.ckpt"),
                              DeploySpec(family="sr", depth=2, width=64, scale=2))
    before = k1.scatter_rdb.launches
    assert model(x).shape == (2, 48, 48, 3)
    assert k1.scatter_rdb.launches - before == 3 * 2

    fast = TrainState(init_weights(FastSRGenerator(depth=2, width=128, scale=4,
                                                   param_dtype=torch.float32,
                                                   device=card), 1), total_steps=2)
    make_pixel_train_step(4)(fast, u8)
    save_checkpoint(tmp_path / "fast.ckpt", fast, 0, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2))
    model, _ = build_deployed(load_checkpoint(tmp_path / "fast.ckpt"),
                              DeploySpec(family="fast", depth=2, width=128, scale=4))
    quant = quantize_deployed(model, [x])
    before = k2.conv3x3_int8.launches
    k2.conv3x3_int8.launches_by_variant.clear()
    assert quant(x).shape == (2, 96, 96, 3)
    assert k2.conv3x3_int8.launches - before == 5
    assert k2.conv3x3_int8.launches_by_variant == {
        "fp32 -> int8": 1, "int8 -> int8": 2, "int8 -> fp32": 2}


# ------------------------------------------------- eval, video, profiling --

def test_texture_metrics_and_resize_on_card_match_cpu(card):
    """The eval CLI's metrics and resizes on the card against the CPU:
    upscale and the bicubic downscale within 1e-6 (fp32, TF32 off inside);
    sharpness, the hf ratio and per-image PSNR-Y within 1e-5 relative; the
    gradient histograms' distance within 1e-3 (a gradient an ulp apart can
    cross a bin edge)."""
    from image_super_resolution_tpu_torch.data import degrade
    from image_super_resolution_tpu_torch.utils import metrics

    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0, 1, (4, 96, 80, 3)).astype(np.float32))
    b = torch.clamp(a + torch.from_numpy(rng.normal(0, 0.05, a.shape).astype(np.float32)), 0, 1)
    b[:, :40, :40] = 0.5
    for fn in (lambda x: degrade.upscale(x, 4), lambda x: degrade.upscale(x, 3),
               lambda x: degrade.downscale(x, 4, "bicubic"),
               lambda x: degrade.downscale(x, 3, "bicubic", True)):
        torch.testing.assert_close(fn(a.to(card)).cpu(), fn(a), rtol=0, atol=1e-6)
    for name, tol in (("sharpness", 1e-5), ("hf_energy_ratio", 1e-5),
                      ("psnr_y_per_image", 1e-5), ("gradient_hist_distance", 1e-3)):
        fn = getattr(metrics, name)
        args = (a,) if name == "sharpness" else (a, b)
        got = fn(*(t.to(card) for t in args)).cpu()
        want = fn(*args)
        if name == "gradient_hist_distance":
            assert abs(float(got) - float(want)) <= tol
        else:
            torch.testing.assert_close(got, want, rtol=tol, atol=0)
    edges = metrics.histogram_edges(0.5, 32, card).cpu()
    assert torch.equal(edges, metrics.histogram_edges(0.5, 32, "cpu"))


def _sr_engine(card, depth=2, batch_size=8):
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler

    spec = DeploySpec(family="sr", depth=depth, width=64, scale=4)
    deployed = DeployedModel(spec, init_fused_params(spec, seed=3), dtype=torch.bfloat16,
                             device=card)
    return TiledUpscaler(deployed, batch_size=batch_size)


def test_video_pipeline_on_card_equals_the_serial_loop(card):
    """21 frames in batches of 8 (a padded tail) through rs.video_pipeline
    on the card: the frames of a serial loop of upscale_batch, bit for bit,
    and K1 launched 3 * depth times per batch."""
    from image_super_resolution_tpu_torch.cli import rs

    engine = _sr_engine(card)
    frames = np.random.default_rng(12).integers(0, 256, (21, 48, 64, 3), dtype=np.uint8)
    batches = []
    for i in range(0, 21, 8):
        chunk = frames[i:i + 8]
        batches.append((np.concatenate([chunk, np.repeat(chunk[-1:], 8 - len(chunk), 0)]),
                        len(chunk)))
    got = []
    before = k1.scatter_rdb.launches
    assert rs.video_pipeline(engine, iter(batches), got.append) == 21
    assert k1.scatter_rdb.launches - before == 3 * 2 * 3
    serial = [f for b, n in batches for f in engine.upscale_batch(b)[:n]]
    for x, y in zip(got, serial):
        assert x.shape == (192, 256, 3)
        np.testing.assert_array_equal(x, y)


def test_upscale_batch_device_does_not_wait_for_the_device(card):
    """On a large batch the host returns from upscale_batch_device (pinned,
    non-blocking upload; no fetch) while the card is still computing: an
    event recorded right after it is not yet done. And the copy of one
    batch to the host, enqueued right after its compute, completes while
    the next batch still computes (rs._fetch_async)."""
    from image_super_resolution_tpu_torch.cli import rs

    engine = _sr_engine(card, depth=16, batch_size=64)
    x = np.random.default_rng(13).integers(0, 256, (64, 96, 96, 3), dtype=np.uint8)
    for warm in (x[:2], x):  # build the kernel; cache every block (a cudaMalloc may sync)
        engine.upscale_batch(warm)
    torch.cuda.synchronize()
    out, n = engine.upscale_batch_device(x)
    launched = torch.cuda.Event()
    launched.record()
    assert not launched.query(), "upscale_batch_device waited for the device"
    launched.synchronize()
    assert n == 64 and tuple(out.shape) == (64, 384, 384, 3)

    small, _ = engine.upscale_batch_device(x[:2])
    fetch = rs._fetch_async(small)  # enqueued before the next batch launches
    engine.upscale_batch_device(x)
    next_done = torch.cuda.Event()
    next_done.record()
    frames = fetch()
    assert not next_done.query(), "the fetch of batch k-1 waited for batch k"
    np.testing.assert_array_equal(frames, small.cpu().numpy())


# --------------------------------------------------- interop, torch.export --

def _reference_layout():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "reference_layout", Path(__file__).with_name("test_torch_reference_layout.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("polymorphic", [False, True])
def test_k1_op_under_torch_export_on_card(card, tmp_path, polymorphic):
    """export_program of a bf16 sr x4 model on the card: K1 is one
    isr::scatter_rdb node per RDB, the loaded program launches the kernel
    (three per RRDB, counted) and its output equals the eager model's bit
    for bit; the dynamic program at a second shape too."""
    from image_super_resolution_tpu_torch.models.deploy import export_program, load_program

    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    eager = DeployedModel(spec, init_fused_params(spec, seed=4), dtype=torch.bfloat16,
                          device=card)
    export_program(eager, 4, 24, 24, tmp_path / "p.pt2", polymorphic=polymorphic)
    graph = torch.export.load(str(tmp_path / "p.pt2")).graph
    assert sum(n.target is torch.ops.isr.scatter_rdb.default for n in graph.nodes) == 6
    program = load_program(tmp_path / "p.pt2")
    for shape in [(4, 24, 24, 3)] + ([(1, 17, 30, 3)] if polymorphic else []):
        x = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
            0, 256, shape, dtype=np.uint8)).to(card)
        before = k1.scatter_rdb.launches
        got = program(x)
        torch.cuda.synchronize()
        assert k1.scatter_rdb.launches - before == 3 * spec.depth
        assert got.device.type == "cuda" and torch.equal(got, eager(x))


def test_import_torch_smoke_on_card(card, tmp_path):
    """A reference-layout sr x4 artifact through cli.import_torch --smoke on
    the card: K1 launched three times per RRDB, the bf16 output within
    BF16_MAX_LSB of the TorchScript forward in fp32 on the CPU."""
    from image_super_resolution_tpu_torch.cli import import_torch
    from image_super_resolution_tpu_torch.interop import export_generator_state
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB

    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    sd = export_generator_state(init_fused_params(spec, seed=5))
    path = _reference_layout().save_sr_artifact(tmp_path / "g.pt", sd, (0.4, 0.5, 0.6),
                                                (0.2, 0.2, 0.2))
    before = k1.scatter_rdb.launches
    got, (worst, share) = import_torch.main(["--src", str(path), "--out",
                                             str(tmp_path / "g.isr"), "--smoke"])
    assert k1.scatter_rdb.launches - before == 3 * spec.depth
    assert (got.family, got.depth, got.scale) == ("sr", 2, 4)
    assert worst <= BF16_MAX_LSB and 0 <= share < 1


# ------------------------------------------------------- the native loader --

def test_native_batches_through_the_prefetcher_to_the_card(card, tmp_path):
    """PatchLoader's native backend on JPEGs and a PNG, through
    DevicePrefetcher (pinned, non-blocking copies) to the card and back:
    each batch bit-equal to the loader's own, uint8 on the card."""
    import cv2

    from image_super_resolution_tpu_torch import native
    from image_super_resolution_tpu_torch.data.pipeline import (
        DevicePrefetcher, LoaderConfig, PatchLoader)

    if not native.available():
        pytest.skip(f"the C++ loader does not build on this host: {native.build_error()}")
    rng = np.random.default_rng(9)
    paths = []
    for i, (h, w) in enumerate([(120, 160), (97, 131), (64, 70), (150, 99), (40, 44)]):
        p = tmp_path / f"{i}.{'png' if i == 2 else 'jpg'}"
        cv2.imwrite(str(p), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        paths.append(str(p))
    loader = PatchLoader(paths, LoaderConfig(batch_size=2, patch_size=48, backend="native"))
    want = list(loader)
    with DevicePrefetcher(iter(loader), card) as batches:
        got = [b for b in batches]
    assert loader.uses_native and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.cpu().numpy(), w)


# ------------------------------------------------ multi-device serving --

def _devices(n):
    """n devices: the local cards in turn (cuda:0 n times on one card)."""
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def test_data_and_spatial_serving_on_card(card):
    """sr x4 d1 w64 bf16: tiles split over two devices within 1 LSB of one
    device (cuDNN may pick another algorithm at the shard's batch); row
    bands over two devices launch K1 three times per band and stay within
    BF16_MAX_LSB of the CPU's fp32 spatial run."""
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB

    spec = DeploySpec(family="sr", depth=1, width=64, scale=4)
    params = init_fused_params(spec, seed=3)
    dep = DeployedModel(spec, params, dtype=torch.bfloat16, device=card)
    cpu = DeployedModel(spec, params, dtype=torch.float32, device="cpu")
    image = np.random.default_rng(4).integers(0, 256, (70, 52, 3), dtype=np.uint8)
    one = TiledUpscaler(dep, window=32, overlap=8, batch_size=8).upscale_image(image)
    two = TiledUpscaler(dep, window=32, overlap=8, batch_size=8, data_devices=2,
                        devices=_devices(2)).upscale_image(image)
    assert np.abs(one.astype(int) - two.astype(int)).max() <= 1
    before = k1.scatter_rdb.launches
    got = TiledUpscaler(dep, overlap=16, spatial_devices=2,
                        devices=_devices(2)).upscale_image(image)
    torch.cuda.synchronize()
    assert k1.scatter_rdb.launches == before + 2 * 3
    want = TiledUpscaler(cpu, overlap=16, spatial_devices=2).upscale_image(image)
    assert got.shape == want.shape == (280, 208, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= BF16_MAX_LSB


def test_int8_data_axis_and_tp_on_card(card):
    """fast x4 d2 w128: int8 frames split over two devices launch K2 five
    times per shard and stay within 1 LSB of one device; TP over two and
    four devices in bf16 within 1 LSB of the single-device graph."""
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8
    from image_super_resolution_tpu_torch.parallel.tensor import TPFastUpscaler

    spec = DeploySpec(family="fast", depth=2, width=128, scale=4)
    dep = DeployedModel(spec, init_fused_params(spec, seed=4), dtype=torch.bfloat16,
                        device=card)
    x = np.random.default_rng(5).integers(0, 256, (6, 24, 24, 3), dtype=np.uint8)
    quant = quantize_deployed(dep, [x])
    before = conv3x3_int8.launches
    two = TiledUpscaler(quant, data_devices=2, devices=_devices(2)).upscale_batch(x)
    torch.cuda.synchronize()
    assert conv3x3_int8.launches == before + 2 * 5
    one = quant(x).cpu().numpy()
    assert np.abs(one.astype(int) - two.astype(int)).max() <= 1
    want = dep(x[:1]).cpu().numpy()
    for n in (2, 4):
        got = TPFastUpscaler(dep, _devices(n))(x[:1]).cpu().numpy()
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rs_refuses_more_devices_than_cards(card, tmp_path):
    """On cuda the device list is the distinct cards: asking for one more
    exits with the JAX message, whatever the flag."""
    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.models.deploy import save_artifact
    from image_super_resolution_tpu_torch.utils.png import write_png

    spec = DeploySpec(family="fast", depth=1, width=128, scale=2)
    model = tmp_path / "m.isr"
    save_artifact(model, spec, init_fused_params(spec, seed=6))
    write_png(tmp_path / "a.png", np.zeros((40, 40, 3), np.uint8))
    n = torch.cuda.device_count() + 1
    base = ["--model", str(model), "--src", str(tmp_path / "a.png"),
            "--save_dir", str(tmp_path / "out.png")]
    for flags, message in (
        (["--data_devices", str(n)], f"data_devices={n} but only {n - 1} local devices"),
        (["--spatial_devices", str(n)], f"requested {n} devices, only {n - 1} available"),
        (["--tp_devices", str(n)], f"--tp_devices {n}: only {n - 1} local devices"),
    ):
        with pytest.raises(SystemExit, match=message):
            rs.main(base + flags)


# ------------------------------------------------ data-parallel training --

@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_data_parallel_steps_on_card(card, tmp_path, backend, world):
    """tests/torch_dist_worker.py's library-level steps (three pixel steps
    of the BN generator x2 d2 w64, without and with remat, and one GAN
    step; fp32, TF32 off) in ``world`` processes on the card: over NCCL at
    world size 1 (every collective runs, through GlobalBatchNorm and the
    gradient all-reduce), and as two ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card). Against one process on the card: the
    ranks' mean losses within 1e-5 relative and every gradient the
    optimizers took within 1e-3 of the largest (the card's own bound
    against the CPU, test_bn_pixel_step_on_card_matches_cpu: cuDNN sums in
    another order at another batch); two ranks bit-equal."""
    import torch_dist_worker as worker

    spec = worker.seeded_spec(width=64)
    torch.save(spec, tmp_path / "spec.pt")
    (tmp_path / "out").mkdir()
    rcs, outs = worker.Group(tmp_path, "steps", [
        {"phase": "steps", "spec": str(tmp_path / "spec.pt"), "out": str(tmp_path / "out"),
         "device": "cuda", "backend": backend, "shared": True}], world, world).outs()
    assert rcs == [0] * world, outs
    ranks = [torch.load(tmp_path / "out" / f"rank{r}.pt") for r in range(world)]
    assert {r["device"] for r in ranks} == {"cuda:0"}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = worker.run_steps(spec, slice(None), card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    def grads_close(got, want):
        scale = max(float(g.abs().max()) for g in want.values())
        for k, w in want.items():
            assert float((got[k] - w).abs().max()) <= 1e-3 * scale, k

    for key in ("pixel", "remat"):
        np.testing.assert_allclose(np.mean([r[key]["losses"] for r in ranks], axis=0),
                                   one["pixel"]["losses"], rtol=1e-5)
        for got, want in zip(ranks[0][key]["grads"], one["pixel"]["grads"]):
            grads_close(got, want)
    for k, want in one["gan"]["losses"].items():
        np.testing.assert_allclose(np.mean([r["gan"]["losses"][k] for r in ranks]), want,
                                   rtol=1e-5, err_msg=k)
    grads_close(ranks[0]["gan"]["g_grads"], one["gan"]["g_grads"])
    grads_close(ranks[0]["gan"]["d_grads"], one["gan"]["d_grads"])
    for other in ranks[1:]:
        for key in ("pixel", "remat"):
            for k, t in ranks[0][key]["model"].items():
                assert torch.equal(t, other[key]["model"][k]), k
        for k, t in ranks[0]["gan"]["g"].items():
            assert torch.equal(t, other["gan"]["g"][k]), k


@pytest.mark.parametrize("shape", [(8, 270, 480, 64), (8, 96, 96, 64), (3, 17, 29, 64),
                                   (2, 13, 11, 32), (1, 300, 300, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_matches_plain_version(card, shape, dtype):
    """K3 at the frames shape, a tile batch, ragged ones and the widest C
    (hidden 16), on the bf16 stream the port serves with and on an fp32
    one: within ``KERNEL_ATOL + KERNEL_RTOL |want|`` of the plain version
    (the mean summed in another order), bitwise the same on a second call
    (no atomics), one launch of each pass a call."""
    from image_super_resolution_tpu_torch.ops.kernels import channel_attention as k3

    g = torch.Generator(device=card).manual_seed(sum(shape))
    c, hidden = shape[-1], shape[-1] // 16

    def u(*s, scale=1.0):
        return (torch.rand(*s, generator=g, device=card) * 2 - 1) * scale

    args = (u(*shape, scale=60.0).to(dtype), (u(*shape, scale=8.0) + 1).to(dtype),
            u(c, scale=0.1), u(hidden, c, scale=c ** -0.5), u(hidden, scale=0.1),
            u(c, hidden, scale=hidden ** -0.5), u(c, scale=0.1))
    before = dict(k3.ca_residual.launches_by_pass)
    got, again = k3.ca_residual(*args), k3.ca_residual(*args)
    torch.cuda.synchronize()
    assert {p: k3.ca_residual.launches_by_pass[p] - before.get(p, 0)
            for p in ("reduce", "scale")} == {"reduce": 2, "scale": 2}
    want = k3.ca_residual_reference(*args)
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=k3.KERNEL_ATOL,
                               rtol=k3.KERNEL_RTOL[dtype])


def test_k3_rejects_what_it_does_not_take(card):
    from image_super_resolution_tpu_torch.ops.kernels.channel_attention import ca_residual

    x = torch.zeros(1, 4, 4, 64, device=card, dtype=torch.bfloat16)
    p = [torch.zeros(s, device=card) for s in ((64,), (4, 64), (4,), (64, 4), (64,))]
    with pytest.raises(ValueError):
        ca_residual(x, x.float(), *p)
    with pytest.raises(ValueError):
        ca_residual(x[..., :48].contiguous(), x[..., :48].contiguous(), *p)
    with pytest.raises(ValueError):
        ca_residual(x, x, p[0].bfloat16(), *p[1:])
    with pytest.raises(ValueError):
        ca_residual(x, x, *p[:-1], p[-1].cpu())


def test_rcan_on_card_launches_k3_per_block(card):
    """bf16 rcan on the card: two K3 launches per block, and the uint8
    output within 2 LSB of the port's fp32 CPU path (bf16 against float32
    measured at most 1 LSB at this size on the CPU, tests/test_torch_rcan.py;
    one more for cuDNN's sums)."""
    from image_super_resolution_tpu_torch.models.rcan import RCAN_MEAN, RCAN_STD
    from image_super_resolution_tpu_torch.ops.kernels.channel_attention import ca_residual

    spec = DeploySpec(family="rcan", depth=2, blocks=3, width=64, scale=4, mean=RCAN_MEAN,
                      std=RCAN_STD)
    params = init_fused_params(spec, seed=4)
    x = np.random.default_rng(4).integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    before = dict(ca_residual.launches_by_pass)
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cuda")(x)
    torch.cuda.synchronize()
    assert {p: ca_residual.launches_by_pass[p] - before.get(p, 0)
            for p in ("reduce", "scale")} == {"reduce": 6, "scale": 6}
    want = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    assert got.shape == (2, 96, 80, 3)
    assert (got.cpu().int() - want.int()).abs().max().item() <= 2


def test_rcan_program_exported_on_card_launches_k3(card, tmp_path):
    """A bf16 rcan ``.pt2`` exported on the card: one ``isr::ca_residual``
    node a block; the loaded program launches K3 twice a block (counted)
    and equals the eager model byte for byte."""
    from image_super_resolution_tpu_torch.models.deploy import export_program, load_program
    from image_super_resolution_tpu_torch.models.rcan import RCAN_MEAN, RCAN_STD
    from image_super_resolution_tpu_torch.ops.kernels.channel_attention import ca_residual

    spec = DeploySpec(family="rcan", depth=2, blocks=3, width=64, scale=4, mean=RCAN_MEAN,
                      std=RCAN_STD)
    eager = DeployedModel(spec, init_fused_params(spec, seed=5), dtype=torch.bfloat16,
                          device=card)
    export_program(eager, 2, 24, 20, tmp_path / "rcan.pt2")
    graph = torch.export.load(str(tmp_path / "rcan.pt2")).graph
    assert sum(n.target is torch.ops.isr.ca_residual.default for n in graph.nodes) == 6
    program = load_program(tmp_path / "rcan.pt2")
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 24, 20, 3),
                                                           dtype=np.uint8)).to(card)
    before = dict(ca_residual.launches_by_pass)
    got = program(x)
    torch.cuda.synchronize()
    assert {p: ca_residual.launches_by_pass[p] - before.get(p, 0)
            for p in ("reduce", "scale")} == {"reduce": 6, "scale": 6}
    assert got.device.type == "cuda" and torch.equal(got, eager(x))


def _k4_case(card, shape, dtype, frame, scale, seed):
    """K4's operands on the card: features ~N(0, 1), a flow of ``scale``
    pixels (uniform, either sign), a frame slot of 8 channels or none."""
    g = torch.Generator(device=card).manual_seed(seed)
    n, h, w, c = shape
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    flow = (torch.rand(n, h, w, 2, generator=g, device=card) * 2 - 1) * scale
    slot = torch.randn(n, h, w, 8, generator=g, device=card).to(dtype) if frame else None
    return x, flow.contiguous(), slot


@pytest.mark.parametrize("shape,dtype,padding,frame,scale", [
    ((1, 270, 480, 64), torch.bfloat16, "zeros", True, 2.0),  # the propagation step
    ((1, 270, 480, 64), torch.bfloat16, "zeros", True, 700.0),  # flows far out of the frame
    ((1, 270, 480, 64), torch.float32, "zeros", False, 3.0),
    ((14, 288, 480, 3), torch.float32, "border", False, 4.0),  # SPyNet's finest level
    ((14, 144, 240, 3), torch.float32, "border", False, 4.0),
    ((14, 72, 120, 3), torch.float32, "border", False, 300.0),
    ((14, 36, 60, 3), torch.float32, "border", False, 4.0),
    ((14, 18, 30, 3), torch.float32, "border", False, 4.0),
    ((14, 9, 15, 3), torch.float32, "border", False, 40.0),  # SPyNet's coarsest level
    ((2, 1, 7, 3), torch.float32, "zeros", False, 4.0),  # a side of length 1
    ((3, 17, 29, 16), torch.bfloat16, "border", True, 5.0),
])
def test_k4_matches_plain_version(card, shape, dtype, padding, frame, scale):
    """K4 at the propagation shape (1x270x480x64 bf16 into the 72-channel
    trunk input, and fp32 without a frame slot), at SPyNet's levels
    (14x{288x480 ... 9x15}x3 fp32, border), at flows far outside the frame
    and on ragged shapes: within ``KERNEL_ATOL_REL * max|x| + KERNEL_RTOL
    |want|`` of the plain version (the sampling point differs by fp32 ulps
    of the grid sampler's normalised coordinate; a bf16 output may round
    the other way), the frame slot copied bit for bit, bitwise the same on
    a second call, one launch counted by mode and by shape."""
    from image_super_resolution_tpu_torch.ops.kernels import flow_warp as k4

    x, flow, slot = _k4_case(card, shape, dtype, frame, scale, sum(shape))
    modes, shapes = dict(k4.flow_warp.launches_by_mode), dict(k4.flow_warp.launches_by_shape)
    got = k4.flow_warp(x, flow, padding, slot)
    again = k4.flow_warp(x, flow, padding, slot)
    torch.cuda.synchronize()
    assert k4.flow_warp.launches_by_mode[padding] - modes.get(padding, 0) == 2
    key = (*shape, 8 if frame else 0, x.element_size(), x.element_size())
    assert k4.flow_warp.launches_by_shape[key] - shapes.get(key, 0) == 2
    want = k4.flow_warp_reference(x, flow, padding, slot)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, again)
    if frame:
        assert torch.equal(got[..., :8], slot)
    tol = k4.KERNEL_ATOL_REL * x.float().abs().max() + k4.KERNEL_RTOL[dtype] * want.float().abs()
    assert ((got.float() - want.float()).abs() <= tol).all()


@pytest.mark.parametrize("scale", [2.0, 700.0])
def test_k4_reads_channel_windows(card, scale):
    """The propagation's launch: both branches' states as two 64-channel
    windows of the 1x270x480x128 bf16 tensor that stacks them, warped into
    2x270x480x72 trunk inputs. Within the plain version's tolerance, equal
    bit for bit to the kernel on contiguous copies of the windows, one
    launch counted under the shape (2, 270, 480, 64, 8, 2, 2)."""
    from image_super_resolution_tpu_torch.ops.kernels import flow_warp as k4

    stacked, flow, slot = _k4_case(card, (1, 270, 480, 128), torch.bfloat16, True, scale, 5)
    windows = stacked.view(270, 480, 2, 64).permute(2, 0, 1, 3)
    flow = torch.cat([flow, flow.flip(2)])
    slot = torch.cat([slot, -slot])
    shapes = dict(k4.flow_warp.launches_by_shape)
    got = k4.flow_warp(windows, flow, "zeros", slot)
    torch.cuda.synchronize()
    key = (2, 270, 480, 64, 8, 2, 2)
    assert k4.flow_warp.launches_by_shape[key] - shapes.get(key, 0) == 1
    assert torch.equal(got, k4.flow_warp(windows.contiguous(), flow, "zeros", slot))
    want = k4.flow_warp_reference(windows, flow, "zeros", slot)
    tol = (k4.KERNEL_ATOL_REL * windows.float().abs().max()
           + k4.KERNEL_RTOL[torch.bfloat16] * want.float().abs())
    assert ((got.float() - want.float()).abs() <= tol).all()
    with pytest.raises(ValueError):  # pixels not evenly spaced
        k4.flow_warp(stacked.permute(0, 2, 1, 3), flow[:1].transpose(1, 2).contiguous())


def test_k4_rejects_what_it_does_not_take(card):
    from image_super_resolution_tpu_torch.ops.kernels.flow_warp import flow_warp

    x = torch.zeros(1, 4, 4, 64, device=card, dtype=torch.bfloat16)
    flow = torch.zeros(1, 4, 4, 2, device=card)
    with pytest.raises(ValueError):
        flow_warp(x, flow.bfloat16())
    with pytest.raises(ValueError):
        flow_warp(x, flow[:, :3].contiguous())
    with pytest.raises(ValueError):
        flow_warp(x, flow, "reflection")
    with pytest.raises(ValueError):
        flow_warp(x, flow.cpu())
    with pytest.raises(ValueError):
        flow_warp(x.half(), flow)


def test_basicvsr_on_card_launches_k4(card):
    """bf16 BasicVSR on the card, width 64, 2 blocks a branch, a 5-frame
    segment of 40 x 72: SPyNet's 6 border warps (both directions in one
    batch) and 4 propagation warps (both branches in one launch), counted;
    the uint8 frames within 2
    LSB of the port's fp32 CPU path (bf16 against float32 measured at most
    1 LSB at this size on the CPU, tests/test_torch_basicvsr.py; one more
    for cuDNN's sums)."""
    from image_super_resolution_tpu_torch.models.basicvsr import BASICVSR_MEAN, BASICVSR_STD
    from image_super_resolution_tpu_torch.ops.kernels.flow_warp import flow_warp

    spec = DeploySpec(family="basicvsr", width=64, blocks=2, scale=4, mean=BASICVSR_MEAN,
                      std=BASICVSR_STD)
    params = init_fused_params(spec, seed=6)
    x = np.random.default_rng(6).integers(0, 256, (5, 40, 72, 3), dtype=np.uint8)
    before = dict(flow_warp.launches_by_mode)
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cuda")(x)
    torch.cuda.synchronize()
    assert {m: flow_warp.launches_by_mode[m] - before.get(m, 0)
            for m in ("zeros", "border")} == {"zeros": 4, "border": 6}
    want = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    assert got.shape == (5, 160, 288, 3)
    assert (got.cpu().int() - want.int()).abs().max().item() <= 2
