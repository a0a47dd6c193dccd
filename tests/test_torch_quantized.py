"""int8 PTQ serving of the fast families: the port's ``models/quantized.py``
and ``rs --int8`` against the JAX package on the CPU (where the int8 conv
site is its plain version, exact in float64), with the same weights and
inputs. The tight checks are the exact accumulators
(``tests/test_torch_matmul.py``) and the quantized params here; end to end,
requantization turns any sub-LSB difference of the bf16 calibration forward
into whole int8 steps, so those tests hold the bounds they measured."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.cli import rs as jax_rs
from image_super_resolution_tpu.data.transforms import normalize as jax_normalize
from image_super_resolution_tpu.models import quantized as jq
from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    DeploySpec as JaxDeploySpec,
)
from image_super_resolution_tpu_torch.cli import rs
from image_super_resolution_tpu_torch.data.transforms import normalize
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.models import quantized as q
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    init_fused_params,
    save_artifact,
)
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

DEPTH, WIDTH = 2, 128
CASES = {
    "fast_x4": ("fast", dict(scale=4)),
    "denoise_fast_ds2": ("denoise_fast", dict(downshuffle=2)),
    "refine_2x64": ("denoise_fast", dict(downshuffle=2, refine_blocks=2,
                                         refine_width=64)),
}


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _case(name, seed=0):
    """(port bf16 DeployedModel, JAX bf16 DeployedModel, spec) on one tree."""
    family, kw = CASES[name]
    spec = DeploySpec(family=family, depth=DEPTH, width=WIDTH, **kw)
    jspec = JaxDeploySpec(family=family, depth=DEPTH, width=WIDTH, **kw)
    params = jspec.build_model(jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return (DeployedModel(spec, params, dtype=torch.bfloat16, device="cpu"),
            JaxDeployedModel(jspec, params), spec)


@pytest.fixture(scope="module")
def fast_x4():
    return _case("fast_x4")


@pytest.mark.parametrize("pct", [None, 99.9])
def test_calibrated_scales_match_jax(fast_x4, pct):
    """Per-site scales from the same uint8 batch and the same (bf16-
    committed) weights. The two bf16 calibration forwards differ where the
    CPU convs (and normalize, within 1e-6) flip a bf16 rounding, which can
    move a site's max by one bf16 ulp: measured over weight seeds 0-2 at
    most 0.29% relative (amax and p99.9); bound 2^-7, one bf16 ulp."""
    deployed, jdeployed, spec = fast_x4
    x = _u8((1, 16, 14, 3), 1)
    want = jq.calibrate_scales(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jdeployed.params),
        [jax_normalize(jnp.asarray(x))], DEPTH, spec.add_rate, spec.output_scale,
        percentile=pct)
    got = q.calibrate_scales(dict(deployed.model.state_dict()),
                             [normalize(torch.from_numpy(x))], DEPTH, spec.add_rate,
                             spec.output_scale, percentile=pct)
    assert list(got) == list(want) == list(q.trunk_sites(DEPTH))
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    assert rel <= 2.0 ** -7, rel


@pytest.mark.parametrize("n", [1, 2, 999, 4097])
@pytest.mark.parametrize("pct", [0.5, 50.0, 99.9, 100.0])
def test_linear_percentile_matches_jnp(n, pct):
    """Same data: jnp.percentile's default linear interpolation, within
    1e-5 relative (JAX forms the position q * (n - 1) in fp32)."""
    a = np.abs(np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    want = float(jnp.percentile(jnp.asarray(a), pct))
    got = q.linear_percentile(torch.from_numpy(a), pct)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_linear_percentile_above_2_pow_24():
    """One site of a b256 t24 w128 batch holds 147,456 x 128 values, above
    the 2^24 elements torch.quantile takes; the port's percentile takes it
    (against numpy's float64 linear percentile, 1e-5 relative)."""
    a = np.abs(np.random.default_rng(3).standard_normal(2 ** 24 + 5)).astype(np.float32)
    t = torch.from_numpy(a)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(t, 0.999)
    want = np.percentile(a.astype(np.float64), 99.9)
    np.testing.assert_allclose(float(q.linear_percentile(t, 99.9)), want, rtol=1e-5)


def test_percentile_outside_0_100_refused(fast_x4):
    deployed, _, _ = fast_x4
    for bad in (0.0, -1.0, 100.5):
        with pytest.raises(ValueError, match=r"\(0, 100\]"):
            q.quantize_deployed(deployed, [_u8((1, 8, 8, 3), 0)], percentile=bad)


def test_quantized_params_match_jax(fast_x4):
    """Same fp32 weights (the bf16-committed ones) and the same scales:
    w_q equal, deq and bias within 1 fp32 ulp, inv_x equal."""
    deployed, jdeployed, _ = fast_x4
    scales = {s: 0.01 * (i + 1) / 3 for i, s in enumerate(q.trunk_sites(DEPTH))}
    params32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      jax.device_get(jdeployed.params))
    want = jq.quantize_fast_params(params32, scales, DEPTH)
    got = q.quantize_fast_params(dict(deployed.model.state_dict()), scales, DEPTH)

    def ulps(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))

    for site in q.trunk_sites(DEPTH):
        w, g = want[site], got[site]
        w_q = np.asarray(w["w_q"])
        np.testing.assert_array_equal(g["w_q"].numpy(), w_q.reshape(-1, w_q.shape[-1]))
        assert ulps(g["deq"].numpy(), w["deq"]).max() <= 1
        assert ulps(g["bias"].numpy(), w["bias"]).max() <= 1
        assert float(g["inv_x"]) == float(w["inv_x"])
    assert {k for k in got if not k.startswith("block") and k != "trunk_conv"} == {
        "head.conv.weight", "head.conv.bias", "tail.conv.weight", "tail.conv.bias"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_deployed_against_jax_and_bf16(name):
    """uint8 end to end on one .isr tree, self-calibrated on the served
    batch (odd size: edge pad and crop for the downshuffled cases).
    Against the JAX Int8DeployedFast: measured on fast x4/x2 and
    denoise_fast ds2 over weight seeds 0-2 and amax/p99.9 at most 1 LSB on
    at most 13% of the values (mean 0.134);
    bound 2 LSB, mean 0.25. Against the port's own bf16 model, the JAX
    package's int8 bound: mean < 1, max <= 8 (measured max 4)."""
    deployed, jdeployed, spec = _case(name, seed=1)
    x = _u8((2, 11, 9, 3), 2)
    quant = q.quantize_deployed(deployed, [x])
    got = quant(x).numpy().astype(int)
    want = np.asarray(jq.quantize_deployed(jdeployed, [jnp.asarray(x)])(
        jnp.asarray(x))).astype(int)
    s = spec.output_scale
    assert got.shape == want.shape == (2, 11 * s, 9 * s, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2 and diff.mean() < 0.25, (diff.max(), diff.mean())
    bf16 = deployed(x).numpy().astype(int)
    diff = np.abs(got - bf16)
    assert diff.mean() < 1.0 and diff.max() <= 8


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_handoff_equals_requantizing_at_each_site(name):
    """int8_forward hands every site but block 0's conv0 its input in int8,
    requantized in the epilogue of the site before it with the next site's
    scale: a conv0 its output, a conv1 its block's sum ``h + rate * t``.
    That is the same function as the route without the hand-offs (every
    site fp32 out, the residual stream in torch ops, each site requantizing
    at its load), bit for bit. (The route with the hand-off is also the one
    held against the JAX int8_forward in
    test_int8_deployed_against_jax_and_bf16.)"""
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8_reference

    deployed, _, spec = _case(name, seed=2)
    x = _u8((2, 11, 9, 3), 3)
    qp = q.quantize_deployed(deployed, [x]).params
    xn = normalize(torch.from_numpy(x))
    kw = dict(downshuffle=spec.downshuffle or 1, refine_blocks=spec.refine_blocks or 0)

    def fp32_sites(site, h):
        p = qp[site]
        return conv3x3_int8_reference(h, p["w_q"], p["deq"], p["bias"],
                                      site.endswith("conv0"), p["inv_x"])

    got = q.int8_forward(qp, xn, DEPTH, spec.add_rate, spec.output_scale, **kw)
    want = q.fast_forward(qp, xn, DEPTH, spec.add_rate, spec.output_scale,
                          quant=fp32_sites, **kw)
    assert torch.equal(got, want)
    # the hand-offs really are int8: only block 0's conv0 sees fp32
    seen, orig = [], q.quant_site

    def spy(p, h, *args, **kwargs):
        seen.append(h.dtype)
        return orig(p, h, *args, **kwargs)

    q.quant_site = spy
    try:
        q.int8_forward(qp, xn, DEPTH, spec.add_rate, spec.output_scale, **kw)
    finally:
        q.quant_site = orig
    assert seen == [torch.float32] + [torch.int8] * (2 * DEPTH)


@pytest.mark.parametrize("depth", [1, DEPTH, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_forward_equals_the_unfused_composition(name, depth):
    """int8_forward, whose conv1 and trunk_conv epilogues do the residual
    updates, equals bit for bit the unfused composition that served int8
    before: conv0 handing its conv1 an int8 tensor, conv1 and trunk_conv
    fp32 out, ``h + scale_residual(t, add_rate)`` and ``x + trunk_conv(h)``
    as torch ops (``fast_forward``'s ``quant``), each other site
    requantizing the fp32 stream at its load. fast and denoise_fast, with
    and without the refinement tail, at depths 1 (one block: its conv1 is
    the last), 2 and 3."""
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8_reference

    family, ckw = CASES[name]
    spec = DeploySpec(family=family, depth=depth, width=WIDTH, **ckw)
    params = init_fused_params(spec, seed=depth)
    deployed = DeployedModel(spec, params, dtype=torch.bfloat16, device="cpu")
    x = _u8((2, 13, 10, 3), depth)
    qp = q.quantize_deployed(deployed, [x]).params
    xn = normalize(torch.from_numpy(x))
    kw = dict(downshuffle=spec.downshuffle or 1, refine_blocks=spec.refine_blocks or 0)

    def unfused(site, h):
        p = qp[site]
        inv_x = None if h.dtype == torch.int8 else p["inv_x"]
        if site.endswith("conv0"):
            nxt = qp[site[:-1] + "1"]["inv_x"]
            return conv3x3_int8_reference(h, p["w_q"], p["deq"], p["bias"], True, inv_x, nxt)
        return conv3x3_int8_reference(h, p["w_q"], p["deq"], p["bias"], False, inv_x)

    got = q.int8_forward(qp, xn, depth, spec.add_rate, spec.output_scale, **kw)
    want = q.fast_forward(qp, xn, depth, spec.add_rate, spec.output_scale, quant=unfused,
                          **kw)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_int8_through_tiled_engine(fast_x4):
    """Int8DeployedFast has DeployedModel's call surface, so TiledUpscaler
    takes it; tiled int8 tracks tiled bf16 within the JAX package's bound
    (mean < 1.5, max <= 12)."""
    deployed, _, _ = fast_x4
    img = _u8((24, 40, 3), 3)
    quant = q.quantize_deployed(deployed, [img[:16, :16][None]])
    a = TiledUpscaler(deployed, window=24, overlap=4, batch_size=4).upscale_image(img)
    b = TiledUpscaler(quant, window=24, overlap=4, batch_size=4).upscale_image(img)
    assert a.shape == b.shape == (96, 160, 3)
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.mean() < 1.5 and diff.max() <= 12


def test_quantize_deployed_refuses_other_families():
    spec = DeploySpec(family="sr", depth=1, width=16, scale=2)
    deployed = DeployedModel(spec, init_fused_params(spec), dtype=torch.float32,
                             device="cpu")
    with pytest.raises(ValueError, match="fast families"):
        q.quantize_deployed(deployed, [_u8((1, 8, 8, 3), 0)])


def _write(path, arr):
    assert cv2.imwrite(str(path), arr[..., ::-1])


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A fast x2 artifact (depth 2, width 128) and a folder of two PNGs,
    one of odd size, plus an unreadable file among them."""
    tmp = tmp_path_factory.mktemp("rs_int8")
    spec = DeploySpec(family="fast", depth=DEPTH, width=WIDTH, scale=2)
    model = tmp / "fast.isr"
    save_artifact(model, spec, init_fused_params(spec, seed=4))
    src = tmp / "in"
    src.mkdir()
    _write(src / "a.png", _u8((32, 24, 3), 5))
    _write(src / "b.png", _u8((23, 17, 3), 6))
    (src / "c.png").write_bytes(b"not a png")
    return model, src, tmp


def test_int8_calib_batches_match_jax(cli_case, capsys):
    """The calibration crops: a folder (the unreadable file skipped) and a
    single image, equal to the JAX CLI's."""
    _, src, _ = cli_case
    for path, window in ((src, 16), (src, 0), (src / "a.png", 16), (src / "b.png", 96)):
        got = rs._int8_calib_batches(path, window)
        want = jax_rs._int8_calib_batches(path, window)
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0], want[0])
    assert "skipping unreadable" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--int8_percentile", "99.9"]])
def test_rs_cli_int8_folder(cli_case, extra):
    """rs --device cpu --int8 on the folder: x2 outputs for both images (the
    unreadable one skipped), tracking the bf16 run (mean < 1.5, max <= 12)."""
    model, src, tmp = cli_case
    common = ["--model", str(model), "--src", str(src), "--device", "cpu",
              "--window_size", "24", "--overlap", "4", "--batch_size", "4"]
    out8 = tmp / f"int8{len(extra)}"
    with pytest.warns(UserWarning, match="skipping c.png"):
        rs.main([*common, "--save_dir", str(out8), "--int8", *extra])
    out16 = tmp / f"bf16{len(extra)}"
    with pytest.warns(UserWarning, match="skipping c.png"):
        rs.main([*common, "--save_dir", str(out16)])
    for name, (h, w) in (("a", (32, 24)), ("b", (23, 17))):
        a = rs._read_image_rgb(out8 / f"{name}.png").astype(int)
        b = rs._read_image_rgb(out16 / f"{name}.png").astype(int)
        assert a.shape == b.shape == (2 * h, 2 * w, 3)
        diff = np.abs(a - b)
        assert diff.mean() < 1.5 and diff.max() <= 12


@pytest.mark.parametrize("argv,match", [
    (["--int8", "--tp_devices", "2"], "tp_devices"),
    (["--int8", "--spatial_devices", "2"], "spatial"),
    (["--int8", "--int8_percentile", "0"], r"\(0, 100\]"),
    (["--int8", "--int8_percentile", "101"], r"\(0, 100\]"),
])
def test_rs_cli_int8_exits(cli_case, argv, match):
    model, src, tmp = cli_case
    with pytest.raises(SystemExit, match=match):
        rs.main(["--model", str(model), "--src", str(src), "--device", "cpu",
                 "--save_dir", str(tmp / "x"), *argv])


def test_rs_cli_int8_refuses_non_fast_artifact(tmp_path):
    spec = DeploySpec(family="sr", depth=1, width=16, scale=2)
    model = tmp_path / "sr.isr"
    save_artifact(model, spec, init_fused_params(spec))
    img = tmp_path / "a.png"
    _write(img, _u8((16, 16, 3), 7))
    with pytest.raises(SystemExit, match="fast families"):
        rs.main(["--model", str(model), "--src", str(img), "--device", "cpu",
                 "--save_dir", str(tmp_path / "o.png"), "--int8"])
