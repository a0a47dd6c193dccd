"""Serving over several devices, the port against the JAX package on the
CPU: ``core/mesh.py``, ``parallel/spatial.py``, ``parallel/tensor.py``,
the sharded paths of ``TiledUpscaler``, and ``rs``/``evaluate`` with
``--data_devices``, ``--spatial_devices``, ``--spatial_grid`` and
``--tp_devices``. JAX runs on its 8 virtual CPU devices
(``tests/conftest.py``); the port runs every shard on the one CPU, which
stands for as many devices as asked, so each path's whole logic (band
cuts, halos, crops, split batches, partial sums and their reduction)
runs here. Tolerances: data-sharded output bit-equal to one device;
spatial 1e-5 in fp32 and <= 1 uint8 LSB through the engine; TP <= 1 LSB.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.cli import evaluate as jax_evaluate
from image_super_resolution_tpu.cli import rs as jax_rs
from image_super_resolution_tpu.core import mesh as jax_mesh
from image_super_resolution_tpu.infer.engine import TiledUpscaler as JaxTiledUpscaler
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    DeploySpec as JaxDeploySpec,
)
from image_super_resolution_tpu.parallel.spatial import (
    spatial_apply as jax_spatial_apply,
    spatial_apply_2d as jax_spatial_apply_2d,
)
from image_super_resolution_tpu.parallel.tensor import (
    TPFastUpscaler as JaxTPFastUpscaler,
    tp_conv as jax_tp_conv,
    tp_fast_param_specs as jax_tp_fast_param_specs,
)
from image_super_resolution_tpu_torch.cli import evaluate, rs
from image_super_resolution_tpu_torch.core import mesh
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.interop.from_jax import params_to_jax
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    init_fused_params,
    load_artifact,
    save_artifact,
)
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.models.quantized import quantize_deployed, trunk_sites
from image_super_resolution_tpu_torch.parallel.spatial import spatial_apply, spatial_apply_2d
from image_super_resolution_tpu_torch.parallel.tensor import (
    COL,
    ROW,
    TPFastUpscaler,
    tp_conv,
    tp_fast_param_specs,
)
from image_super_resolution_tpu_torch.utils.png import read_png, write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

CPU = torch.device("cpu")


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _jax_spec(spec: DeploySpec):
    return JaxDeploySpec(family=spec.family, depth=spec.depth, width=spec.width,
                         scale=spec.scale, downshuffle=spec.downshuffle,
                         refine_blocks=spec.refine_blocks,
                         refine_width=spec.refine_width)


def _deployed(seed=0, dtype=torch.float32, **kw):
    spec = DeploySpec(**kw)
    return DeployedModel(spec, init_fused_params(spec, seed), dtype=dtype, device="cpu")


# ---------------------------------------------------------------- mesh --

@pytest.mark.parametrize("port,jax_fn", [
    (lambda: mesh.make_mesh(9, [CPU] * 8),
     lambda: jax_mesh.make_mesh(n_data=1, n_tile=9)),
    (lambda: mesh.make_spatial_mesh(3, 3, [CPU] * 8),
     lambda: jax_mesh.make_spatial_mesh(3, 3)),
    (lambda: mesh.make_spatial_mesh(0, 2, [CPU] * 8),
     lambda: jax_mesh.make_spatial_mesh(0, 2)),
    (lambda: mesh.serving_devices(9, devices=[CPU] * 8),
     lambda: jax_mesh.serving_data_mesh(9)),
])
def test_device_lists_refuse_as_the_jax_meshes_do(port, jax_fn):
    """Eight devices on both sides: the same refusal, word for word."""
    with pytest.raises(ValueError) as want:
        jax_fn()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


def test_device_lists_on_cpu_and_on_cards(monkeypatch):
    """The CPU stands for as many devices as asked (one for 0); on CUDA
    the list is the distinct cards, and asking for more raises."""
    assert mesh.serving_devices(3, "cpu") == [CPU] * 3
    assert mesh.serving_devices(0, "cpu") == [CPU]
    assert mesh.make_spatial_mesh(2, 2, mesh.local_devices("cpu", 4)) == [[CPU] * 2] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = [torch.device("cuda", 0)]
    assert mesh.local_devices("cuda", 4) == one
    assert mesh.serving_devices(0, "cuda") == one
    with pytest.raises(ValueError, match="data_devices=2 but only 1 local devices available"):
        mesh.serving_devices(2, "cuda")

    class OnCard:  # an engine's model on the card, never called
        spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="data_devices=2 but only 1 local devices"):
        TiledUpscaler(OnCard(), data_devices=2)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        TiledUpscaler(OnCard(), spatial_devices=2)
    with pytest.raises(ValueError, match="requested 4 devices, only 1 available"):
        TiledUpscaler(OnCard(), spatial_grid=(2, 2))
    assert TiledUpscaler(OnCard(), data_devices=0).data_devices == 1


def test_split_gather_and_replicate():
    x = torch.arange(24).reshape(6, 4)
    shards = mesh.split_batch(x, [CPU] * 3)
    assert [tuple(s.shape) for s in shards] == [(2, 4)] * 3
    assert torch.equal(mesh.gather(shards, "cpu"), x)
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        mesh.split_batch(x, [CPU] * 4)
    dep = _deployed(family="sr", depth=1, width=8, scale=2)
    assert mesh.replicate(dep, [CPU] * 3) == [dep] * 3  # one per distinct device


# ------------------------------------------------------------- spatial --

@pytest.fixture(scope="module")
def sr_net():
    """SRGenerator depth 1, width 8, x2 (enchant) in fp32: the JAX apply
    and the port's module on the same params."""
    torch.manual_seed(0)
    ours = SRGenerator(depth=1, width=8, scale=2, enchant=True, device="cpu").eval()
    params = params_to_jax(ours.state_dict())
    model = JaxSRGenerator(depth=1, width=8, scale=2, enchant=True, dtype=jnp.float32)

    def port_apply(x):
        with torch.inference_mode():
            return ours(x)

    return (lambda p, x: model.apply({"params": p}, x)), params, port_apply


# halo 8 is below the depth-1 net's ~23 px receptive-field radius (bands
# differ from the whole image near their seams), 28 above it
@pytest.mark.parametrize("halo", [8, 28])
def test_spatial_apply_matches_jax(sr_net, halo):
    jax_apply, params, port_apply = sr_net
    image = np.random.default_rng(3).uniform(-1, 1, (1, 120, 24, 3)).astype(np.float32)
    grid = jax_mesh.make_mesh(n_data=1, n_tile=4)
    want = np.asarray(jax.jit(lambda p, x: jax_spatial_apply(
        jax_apply, p, x, grid, halo=halo, scale=2))(params, jnp.asarray(image)))
    got = spatial_apply([port_apply] * 4, torch.from_numpy(image), [CPU] * 4,
                        halo=halo, scale=2).numpy()
    assert got.shape == want.shape == (1, 240, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("halo", [8, 28])
def test_spatial_apply_2d_matches_jax(sr_net, halo):
    jax_apply, params, port_apply = sr_net
    image = np.random.default_rng(9).uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    grid = jax_mesh.make_spatial_mesh(2, 4)
    want = np.asarray(jax.jit(lambda p, x: jax_spatial_apply_2d(
        jax_apply, p, x, grid, halo=halo, scale=2))(params, jnp.asarray(image)))
    got = spatial_apply_2d([port_apply] * 8, torch.from_numpy(image),
                           mesh.make_spatial_mesh(2, 4, [CPU] * 8),
                           halo=halo, scale=2).numpy()
    assert got.shape == want.shape == (1, 128, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("grid", [None, (2, 4)])
def test_spatial_reflect_matches_whole_image_reflect_pad(sr_net, grid):
    """With halo >= the receptive field, the sharded run equals one run on
    the np.pad(mode='reflect')-padded whole image, cropped."""
    _, _, port_apply = sr_net
    halo = 28
    shape = (1, 120, 24, 3) if grid is None else (1, 64, 128, 3)
    image = np.random.default_rng(7).uniform(-1, 1, shape).astype(np.float32)
    x = torch.from_numpy(image)
    if grid is None:
        got = spatial_apply([port_apply] * 4, x, [CPU] * 4, halo=halo, scale=2)
        pads = ((0, 0), (halo, halo), (0, 0), (0, 0))
    else:
        got = spatial_apply_2d([port_apply] * 8, x, mesh.make_spatial_mesh(*grid, [CPU] * 8),
                               halo=halo, scale=2)
        pads = ((0, 0), (halo, halo), (halo, halo), (0, 0))
    whole = port_apply(torch.from_numpy(np.pad(image, pads, mode="reflect"))).numpy()
    h, w = shape[1:3]
    cw = slice(0, None) if grid is None else slice(2 * halo, 2 * (halo + w))
    want = whole[:, 2 * halo:2 * (halo + h), cw]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def sr_x2():
    """sr x2 depth 1 at K1's width 64, the optimized graph (the default
    export path), fp32; and the JAX DeployedModel on the same params."""
    spec = DeploySpec(family="sr", depth=1, width=64, scale=2)
    params = init_fused_params(spec, 0)
    dep = DeployedModel(spec, params, dtype=torch.float32, device="cpu")
    assert dep.optimized
    return dep, JaxDeployedModel(_jax_spec(spec), params, dtype=jnp.float32)


@pytest.mark.parametrize("kw,shape", [
    (dict(spatial_devices=4), (96, 40, 3)),
    (dict(spatial_grid=(2, 4)), (96, 88, 3)),
])
def test_spatial_engine_matches_whole_image_and_jax(sr_x2, kw, shape):
    """The engine's spatial paths on the optimized artifact: within 1 LSB
    of whole-image inference away from the borders (reflect halo vs the
    conv's zero pad), and of the JAX engine's same path everywhere."""
    dep, jax_dep = sr_x2
    image = _u8(shape, 11)
    whole = TiledUpscaler(dep, window=0).upscale_image(image)
    sp = TiledUpscaler(dep, overlap=28, **kw).upscale_image(image)
    assert sp.shape == whole.shape == (2 * shape[0], 2 * shape[1], 3)
    r = 28 * 2
    inner = (slice(r, -r), slice(r, -r) if "spatial_grid" in kw else slice(None))
    assert _lsb(sp[inner], whole[inner]) <= 1
    want = JaxTiledUpscaler(jax_dep, overlap=28, **kw).upscale_image(image)
    assert _lsb(sp, want) <= 1


def test_spatial_small_image_raises_clear_error(sr_x2):
    dep, _ = sr_x2
    with pytest.raises(ValueError, match="too small"):
        TiledUpscaler(dep, overlap=8, spatial_grid=(2, 2)).upscale_image(
            np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="too small"):
        TiledUpscaler(dep, overlap=8, spatial_devices=4).upscale_image(
            np.zeros((8, 200, 3), np.uint8))


def test_spatial_grid_checks_and_downshuffle_refusal(sr_x2):
    dep, _ = sr_x2
    for grid in ((0, 2), (-2, -2)):
        with pytest.raises(ValueError, match=">= 1"):
            TiledUpscaler(dep, spatial_grid=grid)
    assert TiledUpscaler(dep, spatial_grid=(1, 1)).spatial_grid is None
    ds = _deployed(family="denoise_fast", depth=1, width=8, downshuffle=2)
    for kw in (dict(spatial_devices=2), dict(spatial_grid=(2, 1))):
        with pytest.raises(ValueError, match="downshuffle>1"):
            TiledUpscaler(ds, **kw)


# ---------------------------------------------------------------- data --

def test_data_axis_matches_single_device(sr_x2):
    """Tile batches and frame batches split over 8 shards equal one device
    bit for bit, 9 frames included (padded with the last frame)."""
    dep, _ = sr_x2
    image = _u8((72, 88, 3), 7)
    single = TiledUpscaler(dep, window=32, overlap=4, batch_size=8)
    multi = TiledUpscaler(dep, window=32, overlap=4, batch_size=8, data_devices=8)
    assert multi.batch_size == 8 and len(multi._replicas) == 8
    np.testing.assert_array_equal(multi.upscale_image(image), single.upscale_image(image))
    frames = _u8((9, 24, 24, 3), 8)
    out, n = multi.upscale_batch_device(frames)
    assert n == 9 and len(out) == 8 and all(s.shape[0] == 2 for s in out)
    np.testing.assert_array_equal(multi.upscale_batch(frames), single.upscale_batch(frames))
    np.testing.assert_array_equal(rs._fetch_async(out)()[:9], single.upscale_batch(frames))


def test_data_axis_rounds_batch_and_exclusive_modes(sr_x2):
    dep, _ = sr_x2
    assert TiledUpscaler(dep, batch_size=6, data_devices=4).batch_size == 8
    assert TiledUpscaler(dep, data_devices=0).data_devices == 1  # the one CPU
    assert TiledUpscaler(dep, data_devices=0, devices=[CPU] * 3).data_devices == 3
    for kw in (dict(spatial_devices=2, data_devices=2), dict(spatial_grid=(2, 1),
                                                             data_devices=2),
               dict(spatial_devices=2, spatial_grid=(1, 2))):
        with pytest.raises(ValueError, match="mutually exclusive"):
            TiledUpscaler(dep, **kw)


@pytest.mark.parametrize("family,kw", [
    ("fast", dict(scale=2)),
    ("denoise_fast", dict(downshuffle=2)),
])
def test_int8_replicas_carry_the_single_models_scales(family, kw):
    """Calibrated once, then replicated: every replica holds the same
    scales and int8 weights, and the data-sharded int8 output equals one
    device's."""
    dep = _deployed(seed=1, family=family, depth=2, width=16, **kw)
    quant = quantize_deployed(dep, [_u8((4, 16, 16, 3), 2)])
    rep = quant.replica(CPU)
    assert rep is not quant
    for site in trunk_sites(2):
        assert rep.params[site]["inv_x"] == quant.params[site]["inv_x"]
        for key in ("w_q", "deq", "bias"):
            assert torch.equal(rep.params[site][key], quant.params[site][key])
    image = _u8((37, 45, 3), 3)
    single = TiledUpscaler(quant, window=16, overlap=4, batch_size=4)
    multi = TiledUpscaler(quant, window=16, overlap=4, batch_size=4, data_devices=4)
    np.testing.assert_array_equal(multi.upscale_image(image), single.upscale_image(image))
    frames = _u8((5, 16, 16, 3), 4)
    np.testing.assert_array_equal(TiledUpscaler(rep).upscale_batch(frames),
                                  single.upscale_batch(frames))


# ------------------------------------------------------------------ TP --

@pytest.mark.parametrize("n", [1, 2, 4])
def test_tp_conv_matches_jax(n):
    """tp_conv, and so the column-parallel ``col_conv`` that every TP conv
    but the row-parallel ones runs, against JAX's at 1, 2 and 4 shards."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)  # HWIO
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jax_tp_conv(jax_mesh.make_mesh(n_data=1, n_tile=n))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = tp_conv([CPU] * n)(torch.from_numpy(x),
                             torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="do not divide"):
        tp_conv([CPU] * 3)(torch.from_numpy(x), torch.zeros(16, 8, 3, 3), torch.zeros(16))


@pytest.mark.parametrize("refine_blocks", [0, 2])
def test_tp_param_specs_mirror_jax(refine_blocks):
    """Every param of the model has a split, and each is JAX's spec on the
    port's OIHW layout: HWIO's C_out (axis 3) is OIHW's 0, C_in (2) is 1."""
    from jax.sharding import PartitionSpec as P

    specs = tp_fast_param_specs(3, refine_blocks)
    model = DeploySpec(family="fast", depth=3, width=16, scale=2,
                       refine_blocks=refine_blocks, refine_width=8).build_model(device="meta")
    assert sorted(specs) == sorted(model.state_dict())
    jax_specs = jax_tp_fast_param_specs(3, refine_blocks=refine_blocks)
    for key, split in specs.items():
        *path, leaf = key.split(".")
        spec = jax_specs[path[0]]
        for p in path[1:]:
            spec = spec[p]
        spec = spec["kernel" if leaf == "weight" else "bias"]
        want = {P(None, None, None, "tile"): COL, P(None, None, "tile", None): ROW,
                P("tile"): COL, P(): None}[spec]
        assert split == want, key


# (name, spec, input shape, n devices): fast x4; the refinement tail; the
# downshuffle front on an odd input (its edge pad); both together
TP_CASES = {
    "fast_x4": (dict(family="fast", depth=2, width=16, scale=4), (2, 12, 12, 3), 8),
    "refine": (dict(family="fast", depth=2, width=16, scale=2, refine_blocks=2,
                    refine_width=8), (2, 12, 12, 3), 4),
    "denoise_fast_odd": (dict(family="denoise_fast", depth=2, width=16, downshuffle=2),
                         (2, 13, 11, 3), 4),
    "denoise_fast_refine": (dict(family="denoise_fast", depth=2, width=16, downshuffle=2,
                                 refine_blocks=2, refine_width=8), (1, 16, 16, 3), 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_tp_matches_jax_and_single_device(case, dtype):
    """Port TP within 1 LSB of the JAX TPFastUpscaler on the same mesh size,
    and within 1 LSB of the port's single-device graph in the same dtype
    (JAX's own bound, tests/test_parallel.py)."""
    kw, shape, n = TP_CASES[case]
    spec = DeploySpec(**kw)
    params = init_fused_params(spec, 4)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    dep = DeployedModel(spec, params, dtype=tdt, device="cpu")
    jax_tp = JaxTPFastUpscaler(JaxDeployedModel(_jax_spec(spec), params, dtype=jdt),
                               jax_mesh.make_mesh(n_data=1, n_tile=n), dtype=jdt)
    tp = TPFastUpscaler(dep, [CPU] * n, dtype=tdt)
    u8 = _u8(shape, 6)
    got = tp(u8).numpy()
    want = np.asarray(jax_tp(jnp.asarray(u8)))
    assert got.shape == want.shape == dep(u8).shape
    assert _lsb(got, want) <= 1
    assert _lsb(got, dep(u8)) <= 1


def test_tp_through_tiled_engine():
    dep = _deployed(seed=2, family="fast", depth=2, width=16, scale=2)
    tp = TPFastUpscaler(dep, [CPU] * 4, dtype=torch.float32)
    image = _u8((40, 56, 3), 1)
    a = TiledUpscaler(dep, window=16, overlap=4, batch_size=4).upscale_image(image)
    b = TiledUpscaler(tp, window=16, overlap=4, batch_size=4).upscale_image(image)
    assert a.shape == b.shape == (80, 112, 3)
    assert _lsb(a, b) <= 1


@pytest.mark.parametrize("kw,n", [
    (dict(family="sr", depth=1, width=8, scale=2), 2),
    (dict(family="fast", depth=1, width=12, scale=2), 8),
    (dict(family="fast", depth=1, width=16, scale=2, refine_blocks=1, refine_width=6), 4),
])
def test_tp_refuses_as_jax_does(kw, n):
    spec = DeploySpec(**kw)
    params = init_fused_params(spec, 0)
    with pytest.raises(ValueError) as want:
        JaxTPFastUpscaler(JaxDeployedModel(_jax_spec(spec), params, dtype=jnp.float32),
                          jax_mesh.make_mesh(n_data=1, n_tile=n))
    with pytest.raises(ValueError) as got:
        TPFastUpscaler(DeployedModel(spec, params, dtype=torch.float32, device="cpu"),
                       [CPU] * n)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- CLIs --

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    out = {}
    for name, kw in {"sr": dict(family="sr", depth=1, width=8, scale=2),
                     "fast": dict(family="fast", depth=1, width=8, scale=2),
                     "denoise_fast": dict(family="denoise_fast", depth=1, width=8,
                                          downshuffle=2)}.items():
        spec = DeploySpec(**kw)
        out[name] = tmp / f"{name}.isr"
        save_artifact(out[name], spec, init_fused_params(spec, 3))
    write_png(tmp / "a.png", _u8((40, 36, 3), 12))
    return tmp, out


@pytest.mark.parametrize("model,flags", [
    ("sr", ["--tp_devices", "-1"]),
    ("sr", ["--tp_devices", "2", "--data_devices", "2"]),
    ("sr", ["--tp_devices", "0", "--spatial_grid", "2", "1"]),
    ("fast", ["--int8", "--tp_devices", "2"]),
    ("fast", ["--int8", "--spatial_devices", "2"]),
    ("denoise_fast", ["--spatial_devices", "2"]),
    ("denoise_fast", ["--spatial_grid", "1", "2"]),
    ("sr", ["--tp_devices", "2"]),
    ("fast", ["--data_devices", "2", "--spatial_devices", "2"]),
    ("fast", ["--spatial_grid", "0", "2"]),
    ("fast", ["--tp_devices", "3"]),
])
def test_rs_refusals_match_jax(artifacts, model, flags, tmp_path):
    tmp, isr = artifacts
    argv = ["--model", str(isr[model]), "--src", str(tmp / "a.png"),
            "--save_dir", str(tmp_path / "out.png"), *flags]
    with pytest.raises(SystemExit) as want:
        jax_rs.main(argv)
    with pytest.raises(SystemExit) as got:
        rs.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags,engine", [
    (["--data_devices", "2"], dict(data_devices=2)),
    (["--data_devices", "0"], dict(data_devices=0)),
    (["--spatial_devices", "2"], dict(spatial_devices=2)),
    (["--spatial_grid", "2", "2"], dict(spatial_grid=(2, 2))),
    (["--tp_devices", "2"], None),
])
def test_rs_sharded_flags_serve(artifacts, flags, engine, tmp_path):
    """Each sharding flag on --device cpu writes what the library's engine
    computes with the same sharding, and the data axis what one device
    writes, bit for bit; TP within 1 LSB of one device."""
    tmp, isr = artifacts
    model = "fast" if engine is None else "sr"
    base = ["--model", str(isr[model]), "--src", str(tmp / "a.png"), "--device", "cpu",
            "--window_size", "16", "--overlap", "4"]
    one = read_png(rs.main(base + ["--save_dir", str(tmp_path / "one.png")]))
    got = read_png(rs.main(base + ["--save_dir", str(tmp_path / "got.png"), *flags]))
    assert got.shape == one.shape == (80, 72, 3)
    if engine is None:
        assert _lsb(got, one) <= 1
        return
    image = read_png(tmp / "a.png")
    want = TiledUpscaler(load_artifact(isr[model], device="cpu"), window=16, overlap=4,
                         **engine).upscale_image(image)
    np.testing.assert_array_equal(got, want)
    if "--data_devices" in flags:
        np.testing.assert_array_equal(got, one)


def test_rs_int8_folder_on_the_data_axis(artifacts, tmp_path):
    """--int8 with --data_devices on a folder (the batch rounded up to 4):
    calibrated once, the same output as one device."""
    tmp, isr = artifacts
    src = tmp_path / "in"
    src.mkdir()
    for i, hw in enumerate(((40, 36), (23, 17))):
        write_png(src / f"{i}.png", _u8((*hw, 3), 20 + i))
    base = ["--model", str(isr["fast"]), "--src", str(src), "--device", "cpu", "--int8",
            "--window_size", "16", "--overlap", "4", "--batch_size", "3"]
    one = rs.main(base + ["--save_dir", str(tmp_path / "one")])
    got = rs.main(base + ["--save_dir", str(tmp_path / "got"), "--data_devices", "2"])
    for i in range(2):
        np.testing.assert_array_equal(read_png(got / f"{i}.png"), read_png(one / f"{i}.png"))


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_eval")
    paths = []
    for i in range(4):
        p = tmp / f"{i}.png"
        write_png(p, _u8((40, 40, 3), 30 + i))
        paths.append(str(p))
    m = tmp / "val.json"
    m.write_text(json.dumps(paths))
    return m


@pytest.mark.parametrize("flags", [
    ["--data_devices", "-1"],
    ["--data_devices", "3"],
])
def test_eval_refusals_match_jax(artifacts, val_set, flags):
    _, isr = artifacts
    argv = ["--model", str(isr["sr"]), "--val_json", str(val_set), "--shape", "16",
            "--batch_size", "2", *flags]
    with pytest.raises(SystemExit) as want:
        jax_evaluate.main(argv)
    with pytest.raises(SystemExit) as got:
        evaluate.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model,extra", [("sr", []), ("fast", ["--int8"])])
def test_eval_data_devices_equal_one_device(artifacts, val_set, model, extra):
    """--data_devices 2 scores what one device scores, key by key."""
    _, isr = artifacts
    argv = ["--model", str(isr[model]), "--val_json", str(val_set), "--shape", "16",
            "--batch_size", "2", "--device", "cpu", *extra]
    assert evaluate.main(argv + ["--data_devices", "2"]) == evaluate.main(argv)
