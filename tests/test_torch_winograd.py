"""Winograd F(2,3) / F(4,3) trunk convs (``ops/winograd.py``, ``ScatterRDB``
and ``DeployedModel`` with ``wino_m``) against the JAX package on the CPU:
the same numpy weights and inputs through both, at JAX's own test shapes
(``tests/test_winograd.py``, ``tests/test_optimized.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    DeploySpec as JaxDeploySpec,
)
from image_super_resolution_tpu.ops import winograd as jwino
from image_super_resolution_tpu.ops.scatter import (
    ScatterRDB as JaxScatterRDB,
    rdb_params_to_scatter as jax_rdb_params_to_scatter,
)
from image_super_resolution_tpu_torch.interop.from_jax import params_from_jax
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    export_program,
    init_fused_params,
    load_program,
)
from image_super_resolution_tpu_torch.ops import winograd
from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
from image_super_resolution_tpu_torch.ops.scatter import ScatterRDB, rdb_params_to_scatter
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

# fp32 against the direct conv and against JAX: JAX's own bound
# (tests/test_winograd.py); measured here 3.6e-5 against direct, 2.6e-5
# against JAX (F(4,3))
ATOL, RTOL = 5e-5, 1e-5


def _rng_conv(seed, shape, cin, cout, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * scale).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m", [2, 4])
def test_transform_kernel_matches_jax(m):
    """G w G^T, (3, 3, Cin, Cout) -> (t, t, Cin, Cout) fp32: equal to JAX's
    to fp32 rounding (1e-6 of the kernel's scale)."""
    _, w, _ = _rng_conv(0, (1, 1, 1), 32, 96)
    got = winograd.transform_kernel(w, m)
    want = np.asarray(jwino.transform_kernel(jnp.asarray(w), m))
    assert got.dtype == torch.float32 and got.shape == (m + 2, m + 2, 32, 96)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="m = 2 or 4"):
        winograd.transform_kernel(w, 3)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("cin,cout", [(64, 192), (32, 96), (3, 64)])
def test_winograd_matches_jax_and_direct_fp32(m, cin, cout):
    """JAX's shapes: fp32 within ATOL/RTOL of the port's direct conv and of
    JAX's Winograd conv on the same kernel."""
    x, w, b = _rng_conv(0, (2, 24, 20), cin, cout)
    wk = winograd.transform_kernel(w, m)
    got = winograd.winograd_conv3x3(torch.from_numpy(x), wk, torch.from_numpy(b), m=m,
                                    dtype=torch.float32)
    direct = winograd.direct_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    want = jwino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(wk.numpy()), jnp.asarray(b),
                                  m=m, dtype=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 20, cout)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the flattened (t*t*Cin, Cout) layout that ScatterRDB holds
    flat = winograd.winograd_conv3x3(torch.from_numpy(x), wk.reshape(-1, cout),
                                     torch.from_numpy(b), m=m, dtype=torch.float32)
    assert torch.equal(flat, got)


@pytest.mark.parametrize("hw", [(24, 24), (23, 21), (5, 9), (1, 1)])
def test_winograd_odd_sizes(hw):
    """Tile padding crops back exactly for any spatial size, both m."""
    x, w, _ = _rng_conv(1, (1, *hw), 8, 16, scale=0.1)
    want = winograd.direct_conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    for m in (2, 4):
        got = winograd.winograd_conv3x3(torch.from_numpy(x), winograd.transform_kernel(w, m),
                                        m=m, dtype=torch.float32)
        assert got.shape == want.shape == (1, *hw, 16)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_winograd_f2_bf16_error_class_matches_direct_bf16():
    """JAX's precision contract with its constants: bf16 F(2,3) stays within
    2.5x the RMS error of the direct bf16 conv against fp32 truth, F(4,3)
    more than 4x (why it is fp32-only). The port's bf16 F(2,3) keeps fp32
    sums, so it agrees with JAX's to a bf16 ulp of the output's scale
    (measured 4.9e-4 at most, on 0.014% of values; the error ratios read
    1.65 and 9.4)."""
    rng = np.random.default_rng(2)
    x32 = rng.uniform(-1, 1, (2, 24, 24, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(64) * 0.05).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x32, w, b))
    truth = winograd.direct_conv3x3(tx.double(), tw.double(), tb.double()).numpy()
    x16 = tx.bfloat16()

    def rms(y):
        return float(np.sqrt(((y.double().numpy() - truth) ** 2).mean()))

    direct_err = rms(winograd.direct_conv3x3(x16, tw, tb))
    wino2 = winograd.winograd_conv3x3(x16, winograd.transform_kernel(tw, 2), tb, m=2)
    wino4 = winograd.winograd_conv3x3(x16, winograd.transform_kernel(tw, 4), tb, m=4)
    assert wino2.dtype == torch.bfloat16
    assert rms(wino2) < 2.5 * direct_err
    assert rms(wino4) > 4 * direct_err
    jax2 = jwino.winograd_conv3x3(jnp.asarray(x32).astype(jnp.bfloat16),
                                  jwino.transform_kernel(jnp.asarray(w), 2), jnp.asarray(b), m=2)
    gap = np.abs(wino2.float().numpy() - np.asarray(jax2.astype(jnp.float32)))
    assert gap.max() <= 2.0 ** -7 * np.abs(truth).max() and (gap > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def rdb():
    """One fused RDB at width 64 (numpy seed), in scatter form for both
    packages, and an input."""
    spec = DeploySpec(family="sr", depth=1, width=64, scale=4)
    fused = init_fused_params(spec, seed=1)["rrdb0"]["rdb0"]
    x = np.random.default_rng(5).standard_normal((2, 12, 10, 64)).astype(np.float32)
    return fused, x


@pytest.mark.parametrize("m", [2, 4])
def test_rdb_params_to_scatter_winograd_matches_jax(rdb, m):
    fused, _ = rdb
    ours = rdb_params_to_scatter(fused, wino_m=m)
    theirs = jax_rdb_params_to_scatter(jax.tree_util.tree_map(jnp.asarray, fused), wino_m=m)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,jdtype,atol", [
    (torch.float32, jnp.float32, 1e-5),
    # JAX rounds every conv output, y_i and slice sum to bf16 as the port's
    # Winograd path does; the products sum in another order, which flips a
    # few bf16 roundings: measured 7.8e-3 (one bf16 ulp at the output's
    # scale of 2-4) on 0.2% of values; fp32 2.4e-7
    (torch.bfloat16, jnp.bfloat16, 1.6e-2),
])
def test_scatter_rdb_winograd_matches_jax(rdb, dtype, jdtype, atol):
    """``ScatterRDB(wino_m=2)`` no longer refuses: it runs the JAX module's
    Winograd form, and never the fused kernel."""
    fused, x = rdb
    scatter = rdb_params_to_scatter(fused, wino_m=2)
    mod = ScatterRDB(64, wino_m=2, dtype=dtype, device="cpu")
    mod.load_state_dict({k[2:]: v for k, v in params_from_jax({"r": scatter}).items()})
    before = scatter_rdb.launches
    with torch.inference_mode():
        got = mod(torch.from_numpy(x).to(dtype))
    assert scatter_rdb.launches == before
    want = JaxScatterRDB(64, wino_m=2, dtype=jdtype).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, scatter)}, jnp.asarray(x, jdtype))
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=0)
    with pytest.raises(ValueError, match="wino_m must be 0, 2 or 4"):
        ScatterRDB(64, wino_m=3, device="cpu")


@pytest.fixture(scope="module")
def sr_d2():
    """sr x4 d2 w64, numpy-seeded fused params, and a 24x24 uint8 pair (JAX
    ``tests/test_optimized.py:95-111``'s shapes); the port's direct fp32
    output."""
    spec = DeploySpec(family="sr", depth=2, width=64, scale=4)
    params = init_fused_params(spec, seed=0)
    x = np.random.default_rng(0).integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    direct = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
    return spec, params, x, direct.numpy().astype(int)


def _jax_deployed(spec, params, dtype, m):
    jspec = JaxDeploySpec(family="sr", depth=spec.depth, width=spec.width, scale=spec.scale)
    return JaxDeployedModel(jspec, jax.tree_util.tree_map(jnp.asarray, params), dtype=dtype,
                            wino_m=m)


@pytest.mark.parametrize("m,lsb", [(2, 0), (4, 1)])
def test_deployed_winograd_fp32_matches_direct_and_jax(sr_d2, m, lsb):
    """fp32 ``wino_m=2`` is bit-identical after uint8 decode to the port's
    direct path and to JAX's ``DeployedModel(wino_m=2)``; ``wino_m=4``
    within 1 LSB of both (measured 0). No K1 launch on either."""
    spec, params, x, direct = sr_d2
    before = scatter_rdb.launches
    got = DeployedModel(spec, params, dtype=torch.float32, device="cpu", wino_m=m)(x)
    assert scatter_rdb.launches == before
    got = got.numpy().astype(int)
    want = np.asarray(_jax_deployed(spec, params, jnp.float32, m)(jnp.asarray(x))).astype(int)
    assert got.shape == (2, 96, 96, 3)
    assert np.abs(got - direct).max() <= lsb
    assert np.abs(got - want).max() <= lsb


def test_deployed_winograd_bf16_matches_jax(sr_d2):
    """bf16 ``wino_m=2``: within 1 LSB of JAX's bf16 Winograd deployment
    (measured 1 LSB on 2.2% of values: the products' sums run in another
    order and flip a few bf16 roundings) and of the fp32 direct path
    (measured 1)."""
    spec, params, x, direct = sr_d2
    got = DeployedModel(spec, params, dtype=torch.bfloat16, device="cpu", wino_m=2)(x)
    got = got.numpy().astype(int)
    want = np.asarray(_jax_deployed(spec, params, jnp.bfloat16, 2)(jnp.asarray(x))).astype(int)
    assert np.abs(got - want).max() <= 1 and (got != want).mean() < 0.05
    assert np.abs(got - direct).max() <= 1


def test_replica_and_program_keep_winograd(sr_d2, tmp_path):
    """``replica()`` rebuilds with ``wino_m`` (the sharded serving paths hold
    replicas), and ``export_program`` carries the Winograd graph through
    ``torch.export``, bit-equal to eager: static at depth 2; polymorphic
    (H and W multiples of ``wino_m``) at depth 1, at a second shape too."""
    spec, params, x, _ = sr_d2
    dep = DeployedModel(spec, params, dtype=torch.float32, device="cpu", wino_m=2)
    eager = dep(x)
    rep = dep.replica("cpu")
    assert rep.wino_m == 2 and rep.model.rrdb1.rdb2.wino_m == 2
    assert torch.equal(rep(x), eager)
    export_program(dep, 2, 24, 24, tmp_path / "static.pt2")
    assert torch.equal(load_program(tmp_path / "static.pt2")(torch.from_numpy(x)), eager)
    d1 = DeploySpec(family="sr", depth=1, width=64, scale=4)
    dep = DeployedModel(d1, {k: v for k, v in params.items() if k != "rrdb1"},
                        dtype=torch.float32, device="cpu", wino_m=2)
    export_program(dep, 2, 8, 8, tmp_path / "poly.pt2", polymorphic=True)
    prog = load_program(tmp_path / "poly.pt2")
    for u8 in (x[:, :8, :12], x[:1, :14, :18]):
        assert torch.equal(prog(torch.from_numpy(u8)), dep(u8))
