"""The port's generators and weight transforms against the JAX package, in
fp32 on the CPU, with the same weights (JAX init, through the weight
bridge) and the same inputs (numpy seed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.optimized import (
    OptimizedSRGenerator as JaxOptimizedSRGenerator,
    optimize_generator_params as jax_optimize_generator_params,
)
from image_super_resolution_tpu.ops.fold_tail import (
    fold_tail_params as jax_fold_tail_params,
    fold_tail_params_x4 as jax_fold_tail_params_x4,
)
from image_super_resolution_tpu_torch.interop.from_jax import (
    params_from_jax,
    params_to_jax,
)
from image_super_resolution_tpu_torch.models.deploy import DeploySpec, init_fused_params
from image_super_resolution_tpu_torch.models.fast import FastResBlock, FastSRGenerator
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.models.optimized import (
    OptimizedSRGenerator,
    ScatterRRDB,
    optimize_generator_params,
)
from image_super_resolution_tpu_torch.models.denoiser import Denoiser, LegacyDenoiser
from image_super_resolution_tpu_torch.ops.blocks import RDB, RRDB, ResidualBlock, Upsampler
from image_super_resolution_tpu_torch.ops.conv import ConvBlock
from image_super_resolution_tpu_torch.ops.fold_tail import (
    fold_tail_params,
    fold_tail_params_x4,
)
from image_super_resolution_tpu_torch.ops.scatter import ScatterRDB
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

WIDTH = 64


def _jax_params(depth, scale, enchant=False, hw=(12, 12)):
    model = JaxSRGenerator(depth=depth, width=WIDTH, scale=scale,
                           enchant=enchant, fused=True, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    return model, jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def x2_case():
    return _jax_params(depth=1, scale=2)


@pytest.fixture(scope="module")
def x4_case():
    return _jax_params(depth=1, scale=4)


def _input(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["x2_case", "x4_case"])
def test_sr_generator_matches_jax(case, request):
    """Fused standard graph, fp32: same convs in another library, so sums
    differ only in order (rtol/atol 1e-4, as tests/test_optimized.py)."""
    jax_model, params = request.getfixturevalue(case)
    x = _input((2, 12, 12, 3))
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    ours = SRGenerator(depth=jax_model.depth, width=WIDTH, scale=jax_model.scale,
                       device="cpu")
    ours.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12 * jax_model.scale, 12 * jax_model.scale, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case,tail_fold,hw", [
    ("x2_case", 1, (12, 12)),
    ("x4_case", 1, (12, 12)),
    ("x4_case", 2, (12, 12)),
    ("x4_case", 2, (13, 11)),  # odd LR size: the stride-2 tail runs on 2H x 2W
])
def test_optimized_generator_matches_jax(case, tail_fold, hw, request):
    """Optimized graph (scatter RDBs, folded tail) in fp32 against the JAX
    optimized graph and the JAX standard graph: rtol/atol 1e-4."""
    jax_model, params = request.getfixturevalue(case)
    scale = jax_model.scale
    x = _input((2, *hw, 3))
    want_std = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    jax_opt = JaxOptimizedSRGenerator(depth=jax_model.depth, width=WIDTH,
                                      scale=scale, tail_fold=tail_fold,
                                      dtype=jnp.float32)
    want = np.asarray(jax_opt.apply(
        {"params": jax_optimize_generator_params(params, tail_fold=tail_fold)},
        jnp.asarray(x)))
    ours = OptimizedSRGenerator(depth=jax_model.depth, width=WIDTH, scale=scale,
                                tail_fold=tail_fold, dtype=torch.float32,
                                device="cpu")
    ours.load_state_dict(params_from_jax(
        optimize_generator_params(params, tail_fold=tail_fold)))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_std, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tail_fold", [1, 2])
def test_optimize_generator_params_matches_jax(x4_case, tail_fold):
    _, params = x4_case
    ours = optimize_generator_params(params, tail_fold=tail_fold)
    theirs = jax_tree = jax_optimize_generator_params(params, tail_fold=tail_fold)
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, jax_tree))
    assert ("tail_folded2" if tail_fold == 2 else "tail_folded") in theirs


def test_fold_tail_params_match_jax():
    rng = np.random.default_rng(3)
    tail = {"conv": {"kernel": rng.standard_normal((9, 9, 8, 3)).astype(np.float32),
                     "bias": rng.standard_normal(3).astype(np.float32)}}
    for ours, theirs in ((fold_tail_params, jax_fold_tail_params),
                         (fold_tail_params_x4, jax_fold_tail_params_x4)):
        _assert_trees_equal(ours(tail), jax.tree_util.tree_map(np.asarray, theirs(tail)))


@pytest.mark.parametrize("enchant", [False, True])
def test_init_fused_params_has_the_jax_tree_layout(enchant):
    """The numpy-seeded random params name and shape every leaf as the JAX
    fused generator does, and the weight bridge maps them back unchanged."""
    spec = DeploySpec(family="sr", depth=1, width=WIDTH, scale=4, enchant=enchant)
    ours = init_fused_params(spec, seed=0)
    _, theirs = _jax_params(depth=1, scale=4, enchant=enchant)
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape for k in a)
    _assert_trees_equal(params_to_jax(params_from_jax(ours)), ours)


@pytest.mark.parametrize("build", [
    lambda: SRGenerator(depth=1),
    lambda: OptimizedSRGenerator(depth=1, scale=4, tail_fold=2),
    lambda: ScatterRRDB(),
    lambda: ScatterRDB(),
    lambda: RRDB(WIDTH),
    lambda: RDB(WIDTH, WIDTH // 2),
    lambda: Upsampler(WIDTH),
    lambda: ConvBlock(3, WIDTH, 9),
    lambda: DeploySpec(family="sr", depth=1).build_model(),
    lambda: FastSRGenerator(depth=1, width=8),
    lambda: FastResBlock(8),
    lambda: DeploySpec(family="denoise_fast", depth=1, width=8,
                       downshuffle=2).build_model(),
    lambda: SRGenerator(depth=1, fused=False),
    lambda: ConvBlock(3, 8, 3, use_bn=True, param_dtype=torch.float32),
    lambda: ConvBlock(3, 8, 3, act="prelu"),
    lambda: ResidualBlock(8, 8),
    lambda: Denoiser(depth=2, width=8, fused=False),
    lambda: LegacyDenoiser(depth=2, width=8),
    lambda: DeploySpec(family="denoise", depth=2, width=8).build_model(),
], ids=["SRGenerator", "OptimizedSRGenerator", "ScatterRRDB", "ScatterRDB",
        "RRDB", "RDB", "Upsampler", "ConvBlock", "build_model", "FastSRGenerator",
        "FastResBlock", "build_model_denoise_fast", "SRGenerator_bn", "ConvBlock_bn",
        "ConvBlock_prelu", "ResidualBlock", "Denoiser", "LegacyDenoiser",
        "build_model_denoise"])
def test_modules_default_to_cuda(build, monkeypatch):
    """Every module is built on the card unless the caller passes
    device="cpu": with no CUDA it raises, never dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_unported_configurations_raise():
    """What slices 1-2 refused now builds: the BN training generator and the
    x1 denoise families' serving graphs; an unknown family still raises."""
    bn = SRGenerator(depth=1, width=8, fused=False, device="cpu")
    assert bn.rrdb0.rdb0.conv0.bn is not None and bn.rrdb0.rdb0.conv0.conv.bias is None
    assert bn.head.bn is None and bn.tail.bn is None
    for family in ("denoise", "denoise_legacy"):
        model = DeploySpec(family=family, depth=2, width=8).build_model(device="cpu")
        with torch.no_grad():
            assert model(torch.zeros(1, 6, 6, 3)).shape == (1, 6, 6, 3)
    with pytest.raises(ValueError, match="unknown model family"):
        DeploySpec(family="gan").build_model(device="cpu")
