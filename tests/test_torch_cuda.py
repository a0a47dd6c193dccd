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
                                   (1, 9, 25), (2, 24, 24), (1, 7, 200), (1, 96, 128)])
def test_fused_rdb_matches_plain_version(card, mats, b, h, w):
    """Any batch and any H, W: images smaller than one 8 x 24 block,
    rectangles that straddle both image edges (9 x 25), the serving tile,
    rows much wider than a block and a whole-image sr input. Tolerance:
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
    (2 * depth + 1 launches per forward: 29 at the served depth 14), each
    conv0 handing its conv1 an int8 tensor, with the K-major weights laid
    out once, and the wrapper counting each variant's launches; the uint8
    output stays within INT8_CARD_MAX_LSB of the port's int8 CPU path on the
    same quantized params."""
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

    def spy(p, h, leaky, out_inv_x=None):
        y = orig(p, h, leaky, out_inv_x)
        dtypes.append((h.dtype, y.dtype))
        return y

    q.quant_site = spy
    try:
        before = k2.conv3x3_int8.launches
        k2.conv3x3_int8.launches_by_variant.clear()
        got = quant(x)
    finally:
        q.quant_site = orig
    assert k2.conv3x3_int8.launches - before == 2 * spec.depth + 1
    assert k2.conv3x3_int8.launches_by_variant == {
        "fp32 -> int8": depth, "int8 -> fp32": depth, "fp32 -> fp32": 1}
    f32, i8 = torch.float32, torch.int8
    assert dtypes == [(f32, i8), (i8, f32)] * depth + [(f32, f32)]
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
        "fp32 -> int8": 2, "int8 -> fp32": 2, "fp32 -> fp32": 1}
