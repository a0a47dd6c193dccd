"""The fast families (``fast``, ``denoise_fast``) of the port against the JAX
package on the CPU: the generator in fp32 and bf16, the functional mirror,
the deployed uint8 model and tiled serving, with the same weights (JAX
init, through the weight bridge) and the same inputs (numpy seeds)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.infer.engine import TiledUpscaler as JaxTiledUpscaler
from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    DeploySpec as JaxDeploySpec,
    infer_downshuffle as jax_infer_downshuffle,
    infer_refine as jax_infer_refine,
)
from image_super_resolution_tpu.models.fast import FastSRGenerator as JaxFast
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.interop.from_jax import params_from_jax
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    infer_downshuffle,
    infer_refine,
    load_artifact,
    save_artifact,
)
from image_super_resolution_tpu_torch.models.fast import FastSRGenerator
from image_super_resolution_tpu_torch.models.quantized import fast_forward
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

# name: (depth, width, scale, downshuffle, refine_blocks, refine_width, input HW)
CONFIGS = {
    "fast_x4": (2, 128, 4, 1, 0, 32, (9, 11)),
    "fast_x2": (2, 128, 2, 1, 0, 32, (9, 11)),
    "denoise_fast_ds2_odd": (2, 128, 1, 2, 0, 32, (11, 13)),
    "refine_2x64": (2, 128, 1, 2, 2, 64, (7, 9)),
    "denoise_fullres": (6, 128, 1, 1, 0, 32, (10, 12)),
}


def _jax_case(name, dtype, seed=0):
    depth, width, scale, ds, rb, rw, hw = CONFIGS[name]
    model = JaxFast(depth=depth, width=width, scale=scale, downshuffle=ds,
                    refine_blocks=rb, refine_width=rw, fused=True, dtype=dtype)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(name, params, dtype):
    depth, width, scale, ds, rb, rw, _ = CONFIGS[name]
    model = FastSRGenerator(depth=depth, width=width, scale=scale, downshuffle=ds,
                            refine_blocks=rb, refine_width=rw, dtype=dtype,
                            device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _input(name, seed=1, n=2):
    hw = CONFIGS[name][-1]
    return np.random.default_rng(seed).standard_normal((n, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fast_fp32_matches_jax(name):
    """fp32, same weights and inputs: the two sum each conv in another
    order, so allow rtol/atol 1e-4 on tanh outputs in [-1, 1]."""
    jmodel, params = _jax_case(name, jnp.float32)
    x = _input(name)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(name, params, torch.float32)(torch.from_numpy(x)).numpy()
    scale = CONFIGS[name][2]
    assert got.shape == want.shape == (2, x.shape[1] * scale, x.shape[2] * scale, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["fast_x4", "denoise_fast_ds2_odd", "refine_2x64"])
def test_fast_bf16_matches_jax_within_measured_bound(name):
    """bf16 (flax's policy: fp32 params, bf16 compute, the bias added after
    the conv's own rounding): with the same rounding points, what is left is
    each CPU conv's order of fp32 sums, which flips a bf16 rounding now and
    then and carries through the trunk. Measured over input seeds 2, 5, 9
    at depth 2, width 128: max |diff| 2^-8 (one bf16 ulp at magnitude
    0.5-1), on at most 8.7% of the outputs (refine tail; x4 4.3%); bound
    2^-7 and 15%."""
    jmodel, params = _jax_case(name, jnp.bfloat16)
    x = _input(name, seed=2)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(name, params, torch.bfloat16)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -7, diff.max()
    assert (diff > 0).mean() < 0.15, (diff > 0).mean()


@pytest.mark.parametrize("name", ["fast_x4", "denoise_fast_ds2_odd", "refine_2x64"])
def test_fast_forward_mirror_is_bit_exact(name):
    """The functional mirror without hooks is the bf16 module, bit for bit
    (as the JAX package's fast_forward is its flax module's), so calibration
    sees the forward that is deployed."""
    depth, _, scale, ds, rb, _, _ = CONFIGS[name]
    _, params = _jax_case(name, jnp.bfloat16, seed=3)
    module = _port(name, params, torch.bfloat16)
    x = torch.from_numpy(_input(name, seed=4))
    with torch.no_grad():
        want = module(x)
        got = fast_forward(dict(module.state_dict()), x, depth, 0.2, scale,
                           downshuffle=ds, refine_blocks=rb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_infer_downshuffle_and_refine_match_jax():
    for name in ("fast_x4", "denoise_fast_ds2_odd", "refine_2x64"):
        _, params = _jax_case(name, jnp.float32)
        assert infer_downshuffle(params) == jax_infer_downshuffle(params)
        assert infer_refine(params) == jax_infer_refine(params)
    assert infer_downshuffle({}) is None and infer_refine({}) == (0, 32)


def _spec(family, **kw):
    return DeploySpec(family=family, **kw), JaxDeploySpec(family=family, **kw)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """fast x4 and denoise_fast ds2 (depth 2, width 128), each saved by the
    port as an .isr; returns {family: (port spec, jax spec, params, path)}."""
    out = {}
    for family, kw in (("fast", dict(scale=4)), ("denoise_fast", dict(downshuffle=2))):
        spec, jspec = _spec(family, depth=2, width=128, **kw)
        model = jspec.build_model(jnp.float32)
        params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 8, 8, 3)))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        path = tmp_path_factory.mktemp("isr") / f"{family}.isr"
        save_artifact(path, spec, params)
        out[family] = (spec, jspec, params, path)
    return out


@pytest.mark.parametrize("family", ["fast", "denoise_fast"])
def test_deployed_uint8_matches_jax(artifacts, family):
    """The same .isr through the port's load_artifact and the JAX
    DeployedModel, uint8 end to end on an odd-sized batch. fp32: sums in
    another order can flip a rounding, <= 1 LSB. bf16: measured over
    weight seeds 5, 6, 7 at most 1 LSB on at most 0.27% of the values;
    bound 2 LSB."""
    spec, jspec, _, path = artifacts[family]
    from image_super_resolution_tpu.models.deploy import load_artifact as jax_load

    x = _u8((2, 13, 11, 3), 6)
    for dtype, jdtype, bound in ((torch.float32, jnp.float32, 1),
                                 (torch.bfloat16, jnp.bfloat16, 2)):
        got = load_artifact(path, dtype=dtype, device="cpu")(x).numpy().astype(int)
        want = np.asarray(jax_load(path, dtype=jdtype)(jnp.asarray(x))).astype(int)
        s = spec.output_scale
        assert got.shape == want.shape == (2, 13 * s, 11 * s, 3)
        diff = np.abs(got - want)
        assert diff.max() <= bound, (dtype, diff.max())
        assert (diff > 0).mean() < 0.02, (dtype, (diff > 0).mean())


def test_denoise_fast_tiled_and_whole_image(artifacts):
    """denoise_fast through TiledUpscaler: tiles stay on the downshuffle
    grid (the engine refuses windows and overlaps off it), tiled output
    tracks JAX's tiled output, and whole-image mode takes an odd-sized image
    through the edge pad and the crop."""
    spec, jspec, params, path = artifacts["denoise_fast"]
    deployed = load_artifact(path, dtype=torch.float32, device="cpu")
    for kw in ({"window": 33, "overlap": 8}, {"window": 32, "overlap": 7}):
        with pytest.raises(ValueError, match="downshuffle"):
            TiledUpscaler(deployed, **kw)
    image = _u8((37, 29, 3), 7)
    got = TiledUpscaler(deployed, window=32, overlap=8, batch_size=4).upscale_image(image)
    jdeployed = JaxDeployedModel(jspec, params, dtype=jnp.float32)
    want = JaxTiledUpscaler(jdeployed, window=32, overlap=8,
                            batch_size=4).upscale_image(image)
    assert got.shape == want.shape == image.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    whole = TiledUpscaler(deployed, window=0).upscale_image(image)
    jwhole = np.asarray(jdeployed(jnp.asarray(image[None])))[0]
    assert whole.shape == image.shape
    assert np.abs(whole.astype(int) - jwhole.astype(int)).max() <= 1


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_denoise_fast_whole_image_pins_the_padding_modes(artifacts, dtype, jdtype):
    """A 37x29 image, a size the downshuffle factor 2 does not divide, whole
    and tiled. Whole-image, the model's front pads the last row and column
    by repeating the edge (JAX ``models/fast.py:131``); tiled, the image is
    reflect-padded to the tile grid (``infer/tiling.py:83-87``). Each mode
    agrees with JAX's within 1 LSB, and the two modes differ from each other
    (at the edges and at the seams, where depth 2's receptive field outgrows
    the overlap of 8) by the same amounts in both packages: the difference
    maps within 2 LSB of each other."""
    spec, jspec, params, path = artifacts["denoise_fast"]
    image = _u8((37, 29, 3), 8)
    deployed = load_artifact(path, dtype=dtype, device="cpu")
    jdeployed = JaxDeployedModel(jspec, params, dtype=jdtype)
    whole = TiledUpscaler(deployed, window=0).upscale_image(image).astype(int)
    jwhole = np.asarray(jdeployed(jnp.asarray(image[None])))[0].astype(int)
    tiled = TiledUpscaler(deployed, window=32, overlap=8, batch_size=4).upscale_image(
        image).astype(int)
    jtiled = JaxTiledUpscaler(jdeployed, window=32, overlap=8,
                              batch_size=4).upscale_image(image).astype(int)
    assert whole.shape == tiled.shape == jwhole.shape == jtiled.shape == image.shape
    assert np.abs(whole - jwhole).max() <= 1
    assert np.abs(tiled - jtiled).max() <= 1
    modes, jmodes = whole - tiled, jwhole - jtiled
    assert np.abs(modes - jmodes).max() <= 2
    assert np.abs(jmodes).max() > 2  # the padding modes really differ


def test_fast_bf16_full_depth_bound():
    """fast x4 at full depth 14, width 128: bf16 against the port's fp32
    path, the comparison the card's check makes. Measured on the CPU over
    weight seeds 0-2 x 4 tiles of 24x24: at most 2 LSB, on 18% of the
    values; FAST_BF16_MAX_LSB = 3 leaves one LSB for the card's order of
    sums."""
    from image_super_resolution_tpu_torch.models.deploy import (
        FAST_BF16_MAX_LSB, init_fused_params)

    spec = DeploySpec(family="fast", depth=14, width=128, scale=4)
    params = init_fused_params(spec, seed=0)
    x = _u8((2, 24, 24, 3), 1)
    lo = DeployedModel(spec, params, dtype=torch.bfloat16, device="cpu")(x)
    hi = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    diff = (lo.int() - hi.int()).abs()
    assert FAST_BF16_MAX_LSB == 3
    assert diff.max().item() <= 2
    assert (diff > 0).float().mean().item() < 0.3
