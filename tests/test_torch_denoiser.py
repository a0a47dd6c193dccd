"""The x1 denoisers (``denoise``, ``denoise_legacy``) and PReLU against the
JAX package on the CPU: modules fused and unfused, parameter counts, the
deployed uint8 artifact, ``build_deployed`` from a training checkpoint, and
the ``rs`` CLI on a denoise artifact. Small widths unless stated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.models import Denoiser as JaxDenoiser
from image_super_resolution_tpu.models.denoiser import LegacyDenoiser as JaxLegacyDenoiser
from image_super_resolution_tpu.models.deploy import (
    DeployedModel as JaxDeployedModel,
    DeploySpec as JaxDeploySpec,
    build_deployed as jax_build_deployed,
    load_artifact as jax_load_artifact,
)
from image_super_resolution_tpu.ops.conv import ConvBlock as JaxConvBlock
from image_super_resolution_tpu.train import checkpoint as jax_ckpt
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu_torch.interop.from_jax import variables_from_jax
from image_super_resolution_tpu_torch.models.denoiser import Denoiser, LegacyDenoiser
from image_super_resolution_tpu_torch.models.deploy import (
    DENOISE_BF16_MAX_LSB,
    DeployedModel,
    DeploySpec,
    build_deployed,
    infer_family_dims,
    init_fused_params,
    save_artifact,
)
from image_super_resolution_tpu_torch.ops.activations import PReLU
from image_super_resolution_tpu_torch.ops.conv import ConvBlock
from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

# fp32 forwards: the same convs in another library, so sums differ in
# order only (as tests/test_torch_models.py): rtol/atol 1e-4.
FWD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pair(kind, fused):
    if kind == "denoise":
        return (JaxDenoiser(depth=2, width=8, fused=fused, dtype=jnp.float32),
                Denoiser(depth=2, width=8, fused=fused, device="cpu"))
    return (JaxLegacyDenoiser(depth=2, width=8, hidden=4, fused=fused, dtype=jnp.float32),
            LegacyDenoiser(depth=2, width=8, hidden=4, fused=fused, device="cpu"))


@pytest.mark.parametrize("kind", ["denoise", "legacy"])
@pytest.mark.parametrize("fused,train", [(True, False), (False, False), (False, True)])
def test_denoiser_forward_matches_jax(kind, fused, train):
    """Denoiser (stride-2 down conv to 4x width, shuffle back) and
    LegacyDenoiser, fp32, with the JAX init's weights: fused, unfused with
    running statistics, and unfused in train mode (batch statistics)."""
    jm, model = _pair(kind, fused)
    x = _x((2, 14, 10, 3))
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x))
    model.load_state_dict(variables_from_jax(v["params"], v.get("batch_stats")))
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 14, 10, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("act", ["prelu", ("prelu", 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_conv_block_matches_jax(act, dtype):
    """ConvBlock with the learnable PReLU (one shared slope, or one per
    output channel) against flax's ``prelu/alpha``, with alphas drawn to
    straddle 0.25: fp32 within 1e-5; bf16 bit for bit on small-integer
    inputs (exact convs) and alphas that are bf16 values."""
    rng = np.random.default_rng(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.integers(-4, 5, (2, 6, 6, 4)).astype(np.float32)
    jblock = JaxConvBlock(8, 3, act=act, use_bn=False, dtype=jdt)
    v = _np(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    n = 8 if isinstance(act, tuple) else 1
    v["params"]["conv"]["kernel"] = rng.integers(-2, 3, (3, 3, 4, 8)).astype(np.float32)
    v["params"]["prelu"]["alpha"] = (rng.integers(1, 64, n) / 128).astype(np.float32)
    want = jblock.apply(v, jnp.asarray(x))
    block = ConvBlock(4, 8, 3, act=act, dtype=tdt, param_dtype=torch.float32, device="cpu")
    assert block.prelu.alpha.shape == (n,) and block.prelu.alpha.dtype == torch.float32
    block.load_state_dict(variables_from_jax(v["params"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(tdt)).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert (want < 0).any()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prelu_init_and_module():
    p = PReLU(3, device="cpu")
    assert torch.equal(p.alpha.detach(), torch.full((3,), 0.25))
    x = torch.tensor([[-4.0, 2.0, -1.0]])
    torch.testing.assert_close(p(x), torch.tensor([[-1.0, 2.0, -0.25]]))


@pytest.mark.parametrize("fused,count", [(False, 3_760_963), (True, None)])
def test_denoiser_param_count(fused, count):
    """Denoise at depth 16, width 64 with BN: 3,760,963 parameters (SURVEY
    2.4); fused, every BN pair is one biased conv: the JAX fused tree's
    count."""
    model = Denoiser(depth=16, width=64, fused=fused, device="meta")
    n = sum(p.numel() for p in model.parameters())
    if count is None:
        jm = JaxDenoiser(depth=16, width=64, fused=True)
        v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
        count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v["params"]))
    assert n == count


@pytest.mark.parametrize("family", ["denoise", "denoise_legacy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deployed_denoise_matches_jax_within_1_lsb(family, dtype):
    """uint8 -> uint8 at x1 against the JAX DeployedModel in the same dtype,
    numpy-seeded fused params: measured 0 LSB in fp32, at most 1 LSB on
    2.1-2.7% of values in bf16 (the CPU convs' order of sums flips a bf16
    rounding now and then). Bound: 1 LSB on under 10% of values."""
    spec = DeploySpec(family=family, depth=2, width=16)
    params = init_fused_params(spec, seed=0)
    x = _u8((2, 24, 20, 3), 1)
    got = DeployedModel(spec, params, dtype=getattr(torch, dtype), device="cpu")(x)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 24, 20, 3)
    jspec = JaxDeploySpec(family=family, depth=2, width=16)
    want = JaxDeployedModel(jspec, jax.tree_util.tree_map(jnp.asarray, params),
                            dtype=getattr(jnp, dtype))(jnp.asarray(x))
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.1


def test_deployed_params_are_committed_in_the_compute_dtype():
    spec = DeploySpec(family="denoise", depth=2, width=8)
    model = DeployedModel(spec, init_fused_params(spec, 0), dtype=torch.bfloat16,
                          device="cpu").model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_denoise_bf16_full_depth_bound():
    """denoise at full size (depth 16, width 64), bf16 against fp32 of the
    port on the CPU: measured at most 1 LSB over four weight seeds;
    DENOISE_BF16_MAX_LSB adds one for the card's order of sums."""
    spec = DeploySpec(family="denoise", depth=16, width=64)
    x = _u8((2, 24, 20, 3), 5)
    for seed in range(4):
        params = init_fused_params(spec, seed=seed)
        f32 = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(x)
        b16 = DeployedModel(spec, params, dtype=torch.bfloat16, device="cpu")(x)
        diff = (f32.int() - b16.int()).abs()
        assert diff.max().item() <= DENOISE_BF16_MAX_LSB - 1


def _jax_denoise_checkpoint(tmp_path):
    """A JAX Denoiser state after two updates, EMA apart from the params,
    running statistics off their init, saved with a dataset mean/std."""
    jm = JaxDenoiser(depth=2, width=8)
    state = create_train_state(jm, (1, 16, 16, 3), build_optimizer(lr=1e-2, total_steps=10),
                               jax.random.PRNGKey(1), ema_tau=3.0)
    from image_super_resolution_tpu.train.steps import make_denoise_train_step

    step = make_denoise_train_step((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))
    for i in range(2):
        state, _ = step(state, jnp.asarray(_u8((2, 16, 16, 3), i)), jax.random.PRNGKey(i))
    path = tmp_path / "denoise.ckpt"
    jax_ckpt.save_checkpoint(path, state, 0, (0.4, 0.5, 0.6), (0.2, 0.25, 0.3), [0.1])
    return path


@pytest.mark.parametrize("with_ema", [True, False])
def test_build_deployed_matches_jax(with_ema, tmp_path):
    """Training checkpoint -> deployed denoiser, both packages from the same
    file: EMA weights preferred (a checkpoint without them: the raw params
    with the raw statistics), BN folded, the checkpoint's mean/std baked
    in. fp32 uint8 within 1 LSB on under 2% of values (measured 0), and the
    fused trees equal within 1e-6 relative."""
    path = _jax_denoise_checkpoint(tmp_path)
    ours, theirs = load_checkpoint(path), jax_ckpt.load_checkpoint(path)
    if not with_ema:
        for ckpt in (ours, theirs):
            ckpt.pop("ema_params")
            ckpt.pop("ema_batch_stats")
    spec = DeploySpec(family="denoise", depth=2, width=8)
    model, fused = build_deployed(ours, spec, dtype=torch.float32, device="cpu")
    assert model.spec.mean == (0.4, 0.5, 0.6) and model.spec.std == (0.2, 0.25, 0.3)
    jmodel, jfused = jax_build_deployed(theirs, JaxDeploySpec(family="denoise", depth=2, width=8),
                                        dtype=jnp.float32)
    x = _u8((2, 16, 12, 3), 7)
    diff = np.abs(model(x).numpy().astype(int) - np.asarray(jmodel(jnp.asarray(x))).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    flat = jax.tree_util.tree_leaves_with_path(_np(jfused))
    assert infer_family_dims(fused, "denoise") == (2, 8)
    for keys, want in flat:
        node = fused
        for k in keys:
            node = node[k.key]
        np.testing.assert_allclose(node, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("family", ["denoise", "denoise_legacy"])
def test_denoise_artifact_serves_in_jax(family, tmp_path):
    """The port's .isr of a denoise family loads in the JAX package and
    serves the port's own output there (fp32, within 1 LSB)."""
    spec = DeploySpec(family=family, depth=2, width=8, hidden=4 if "legacy" in family else 0)
    params = init_fused_params(spec, seed=3)
    save_artifact(tmp_path / "d.isr", spec, params)
    x = _u8((1, 12, 12, 3), 2)
    want = np.asarray(jax_load_artifact(tmp_path / "d.isr", dtype=jnp.float32)(jnp.asarray(x)))
    from image_super_resolution_tpu_torch.models.deploy import load_artifact

    got = load_artifact(tmp_path / "d.isr", dtype=torch.float32, device="cpu")(x).numpy()
    assert got.shape == want.shape == (1, 12, 12, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rs_cli_serves_a_denoise_artifact(tmp_path):
    """rs on a denoise artifact writes a same-size PNG; --int8 refuses it
    (fast families only), as the JAX CLI does."""
    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    spec = DeploySpec(family="denoise", depth=2, width=8)
    save_artifact(tmp_path / "d.isr", spec, init_fused_params(spec, 0))
    write_png(tmp_path / "a.png", _u8((30, 22, 3), 3))
    out = rs.main(["--model", str(tmp_path / "d.isr"), "--src", str(tmp_path / "a.png"),
                   "--save_dir", str(tmp_path / "o.png"), "--device", "cpu",
                   "--window_size", "24", "--overlap", "4"])
    assert read_png(out).shape == (30, 22, 3)
    with pytest.raises(SystemExit, match="fast"):
        rs.main(["--model", str(tmp_path / "d.isr"), "--src", str(tmp_path / "a.png"),
                 "--device", "cpu", "--int8"])

