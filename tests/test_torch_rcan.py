"""RCAN (``models/rcan.py``) and K3's plain version on the CPU against a
plain float32 transcription of the source (``tests/rcan_reference.py``),
at a small size (2 groups of 2 blocks, width 32, reduction 16) on seeded
weights: the generator through the import of the source's checkpoint
layout, the block's channel attention and residual, the deployed uint8
model through an ``.isr`` file and a ``.pt2`` program (K3 one node a
block), tiled photos against the benchmark's plain tiling, and the
refusals."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import rcan_reference as ref
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)
from image_super_resolution_tpu_torch.data.transforms import rgb255_to_uint8, tanh_to_uint8
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.interop.torch_import import import_rcan_state
from image_super_resolution_tpu_torch.models import deploy as deploy_module
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    export_program,
    family_defaults,
    infer_family_dims,
    init_fused_params,
    load_artifact,
    load_program,
    read_artifact,
    save_artifact,
)
from image_super_resolution_tpu_torch.models.rcan import RCAN_MEAN, RCAN_STD
from image_super_resolution_tpu_torch.ops.kernels.channel_attention import (
    ca_residual,
    ca_residual_reference,
)
from image_super_resolution_tpu_torch.utils.profiling import annotate
from image_super_resolution_tpu_torch.utils.serialization import map_tree, msgpack_restore
from perfbench.reference import tiling

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_resgroups=2, n_resblocks=2, n_feats=32, reduction=16, scale=4)


def source_model(seed: int, **kw) -> ref.RCAN:
    """The source's module with torch's default Conv2d init from ``seed``:
    U(+-1/sqrt(fan_in)) for every kernel and bias."""
    torch.manual_seed(seed)
    return ref.RCAN(**{**SMALL, **kw}).eval()


def imported(model: ref.RCAN):
    return import_rcan_state({k: v.numpy() for k, v in model.state_dict().items()})


def deployed(seed: int = 0, dtype=torch.float32) -> tuple:
    model = source_model(seed)
    spec, params = imported(model)
    return DeployedModel(spec, params, dtype=dtype, device="cpu"), model, spec, params


def inputs(seed: int, shape=(2, 13, 11, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_matches_reference_fp32(seed):
    """float32 on both sides: the same sums in another order (cuDNN-free CPU
    convs, the port's NHWC views), far inside half an LSB before rounding;
    measured equal on seeds 0-3. One LSB allows a value that lands on a
    rounding boundary."""
    d, model, _, _ = deployed(seed)
    x = inputs(seed)
    got, want = d(x).numpy(), ref.upscale(model, x)
    assert got.shape == want.shape == (2, 52, 44, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3


def test_generator_bf16_within_its_rounding():
    """bf16 convs and stream against float32: measured max 1 LSB and RMS
    0.20-0.22 over seeds 0-3 at this size (0.69-0.76 RMS at published
    widths, PERF.md); bounds of 2 LSB and 0.4 RMS leave room for another
    seed's inputs and catch a lost block (RMS in the tens)."""
    d, model, _, _ = deployed(2, torch.bfloat16)
    x = inputs(2)
    diff = d(x).numpy().astype(np.float64) - ref.upscale(model, x)
    assert np.abs(diff).max() <= 2
    assert np.sqrt(np.mean(diff ** 2)) <= 0.4


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
def test_k3_plain_version_matches_reference_block(stream):
    """``x + (r + b) * CA(r + b)``: the plain version (and the wrapper on the
    CPU) against the source's CALayer and residual, on the same operands (a
    bf16 stream's ``x`` and ``r`` as bf16 holds them). fp32: each op rounded
    in another order, 1e-5 relative; a bf16 stream: the fp32 sum rounded
    once to bf16, within one bf16 ulp (2^-7 of the value at most)."""
    model = source_model(3)
    ca = model.body[0].body[1].body[3]
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 32, 7, 9, generator=g) * 40).to(stream)
    r = (torch.randn(2, 32, 7, 9, generator=g) * 4 + 1).to(stream)
    bias = torch.randn(32, generator=g) * 0.1
    want = ref.ca_residual(x.float(), r.float() + bias[:, None, None], ca)
    w = [t.detach() for t in (ca.conv_du[0].weight[:, :, 0, 0], ca.conv_du[0].bias,
                              ca.conv_du[2].weight[:, :, 0, 0], ca.conv_du[2].bias)]
    args = (x.permute(0, 2, 3, 1).contiguous(), r.permute(0, 2, 3, 1).contiguous(), bias, *w)
    got = ca_residual_reference(*args)
    assert got.dtype == stream
    assert torch.equal(ca_residual(*args), got)
    rtol = 1e-5 if stream == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float().permute(0, 3, 1, 2), want, rtol=rtol, atol=1e-4)


def test_parameter_count_at_published_widths():
    """10 groups of 20 RCABs, 64 features, reduction 16, x4: 15,592,355
    parameters, the source's module without its two mean shifts alike."""
    spec = DeploySpec(family="rcan", depth=10, width=64, scale=4)
    port = spec.build_model(device="meta").state_dict()
    assert sum(t.numel() for t in port.values()) == 15_592_355
    source = ref.RCAN()
    n = sum(p.numel() for name, p in source.named_parameters() if "_mean" not in name)
    assert n == 15_592_355
    assert family_defaults("rcan") == (10, 64) and (spec.blocks, spec.reduction) == (20, 16)


def test_import_reads_sizes_and_checks_the_mean():
    """Sizes come from the shapes; the tree's depth and width read back; a
    checkpoint whose mean shift is not the spec's is refused."""
    model = source_model(5, n_resgroups=3, n_resblocks=1, scale=2)
    spec, params = imported(model)
    assert (spec.family, spec.depth, spec.blocks, spec.width, spec.reduction, spec.scale) == (
        "rcan", 3, 1, 32, 16, 2)
    assert spec.mean == RCAN_MEAN and spec.std == RCAN_STD
    assert infer_family_dims(params, "rcan") == (3, 32)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["sub_mean.bias"] = -255.0 * np.array([0.5, 0.5, 0.5], np.float32)
    with pytest.raises(ValueError, match="sub_mean"):
        import_rcan_state(sd)
    spec2, _ = import_rcan_state(sd | {"add_mean.bias": 127.5 * np.ones(3, np.float32)},
                                 mean=(0.5, 0.5, 0.5))
    assert spec2.mean == (0.5, 0.5, 0.5)


def test_isr_round_trip_and_group_spans(tmp_path):
    """uint8 in and out through an ``.isr`` file: the spec (with its RCAN
    sizes) and the output bytes come back (the file stores fp16, so the
    params are fp16 values from the start); one ``rcan/group`` span per
    group a forward. An ``sr`` spec's file holds no RCAN field, as the JAX
    package writes it."""
    _, _, spec, params = deployed(6)
    params = map_tree(lambda a: a.astype(np.float16).astype(np.float32), params)
    d = DeployedModel(spec, params, dtype=torch.float32, device="cpu")
    path = tmp_path / "rcan.isr"
    save_artifact(path, spec, params)
    assert read_artifact(path)[0] == spec
    x = inputs(6)
    calls = annotate.totals.get("rcan/group", [0, 0])[0]
    want = d(x)
    assert annotate.totals["rcan/group"][0] == calls + spec.depth
    got = load_artifact(path, dtype=torch.float32, device="cpu")(x)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    sr_path = tmp_path / "sr.isr"
    save_artifact(sr_path, DeploySpec(), {})
    keys = json.loads(msgpack_restore(sr_path.read_bytes())["spec"])
    assert "blocks" not in keys and "reduction" not in keys


def test_export_program_equals_deployed(tmp_path):
    """The ``.pt2`` request (normalize, the model with K3's plain version,
    ``y + 255 mean`` clamped and rounded) equals ``DeployedModel`` byte for
    byte on the CPU."""
    d, _, _, _ = deployed(7)
    path = tmp_path / "rcan.pt2"
    export_program(d, 2, 12, 12, path)
    x = torch.from_numpy(inputs(7, (2, 12, 12, 3)))
    assert torch.equal(load_program(path)(x), d(x))


@pytest.mark.parametrize("polymorphic", [False, True])
def test_export_program_records_k3_once_a_block(tmp_path, polymorphic):
    """K3 is the op ``isr::ca_residual``: a ``.pt2`` of the small model holds
    one node of it a block (groups x blocks), and the loaded program equals
    the eager model byte for byte, the dynamic one at a second shape too."""
    d, _, spec, _ = deployed(11)
    path = tmp_path / "rcan.pt2"
    export_program(d, 2, 12, 12, path, polymorphic=polymorphic)
    graph = torch.export.load(str(path)).graph
    nodes = sum(n.target is torch.ops.isr.ca_residual.default for n in graph.nodes)
    assert nodes == spec.depth * spec.blocks
    program = load_program(path)
    for shape in [(2, 12, 12, 3)] + ([(3, 9, 14, 3)] if polymorphic else []):
        x = torch.from_numpy(inputs(11, shape))
        assert torch.equal(program(x), d(x))


def test_tiled_photo_matches_reference_tiling():
    """An odd-sized photo through ``TiledUpscaler`` (the channel attention's
    mean per tile) against ``perfbench/reference/tiling.upscale`` over the
    float32 reference: the same tiles, so the same outputs within the
    generator test's 1 LSB."""
    d, model, _, _ = deployed(8)
    photo = inputs(8, (21, 30, 3))[None][0]
    got = TiledUpscaler(d, window=16, overlap=4, batch_size=3).upscale_image(photo)
    want = tiling.upscale(lambda t: ref.upscale(model, t), photo, 16, 4, block=3)
    assert got.shape == want.shape == (84, 120, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("kw", [dict(spatial_devices=2), dict(spatial_grid=(2, 1))])
def test_band_sharding_refused(kw):
    """A band's mean is not the image's: the spatial paths refuse ``rcan``;
    the data axis (whole tiles or frames per device) serves it."""
    d, _, _, _ = deployed(9)
    with pytest.raises(ValueError, match="rcan"):
        TiledUpscaler(d, **kw)
    x = inputs(9, (4, 8, 8, 3))
    assert np.array_equal(TiledUpscaler(d, data_devices=2).upscale_batch(x),
                          d(x).numpy())


def test_serving_reads_what_the_model_owns():
    """Deploy and the engine read RCAN's own facts, not its family name:
    the output map and a whole-image block (band sharding refused); a
    model without them keeps tanh and every path."""
    d, _, _, _ = deployed(10)
    assert d.model.global_pool
    y = torch.linspace(-300.0, 300.0, 12).reshape(1, 2, 2, 3)
    assert torch.equal(deploy_module.to_uint8(d.model, y, RCAN_MEAN),
                       rgb255_to_uint8(y, RCAN_MEAN))
    plain = torch.nn.Identity()
    assert torch.equal(deploy_module.to_uint8(plain, y / 300, RCAN_MEAN),
                       tanh_to_uint8(y / 300))
    spec = DeploySpec(family="fast", depth=1, width=8, scale=2)
    fast = DeployedModel(spec, init_fused_params(spec, seed=0), dtype=torch.float32,
                         device="cpu")
    assert not getattr(fast.model, "global_pool", False)
    TiledUpscaler(fast, spatial_devices=2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ulps():
    """The smoke's K3 check counts units in the last place across binades
    and through zero, in bf16 and fp32."""
    ulps = _chip_smoke()._ulps
    a = torch.tensor([1.0, -0.0, 2.0, -1.0, 3.0])
    b = torch.tensor([1.0078125, 0.0, 1.9921875, -1.0078125, 3.0])
    assert ulps(a.bfloat16(), b.bfloat16()) == 1
    assert ulps(a, b) == 2 ** 16
    tiny = torch.tensor([2.0 ** -133]).bfloat16()  # the smallest positive bf16
    assert ulps(tiny, -tiny) == 2


def test_chip_smoke_phase_rcan_on_cpu(tmp_path, monkeypatch):
    """The smoke's RCAN phase at a small size on the CPU: the ``.isr``
    round trip, the crop within its bounds, requests and the video pipeline
    served, no K3 launch counted off the card (the plain version runs)."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "RCAN_DIMS", (2, 2, 32, 16))
    monkeypatch.setattr(smoke, "RCAN_FRAMES", (2, 12, 20))
    monkeypatch.setattr(smoke, "RCAN_VIDEO_BATCHES", 2)
    monkeypatch.setattr(smoke, "RCAN_CROP", 16)
    assert smoke.phase_rcan(tmp_path, "cpu", device="cpu") == {
        "serve rcan x4 (phase 19)": 0, "rs.video_pipeline rcan x4 (phase 19)": 0}
