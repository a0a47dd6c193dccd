"""Training in the port against the JAX package on the CPU: BatchNorm, the
initializers, the optimizer chain, and three pixel and three denoise steps
(the Denoiser and the fast denoisers; checkpoints and the CLI: tests/test_torch_checkpoint.py). Models are tiny
(depth 1-2, width 8) and run in fp32 on both sides unless a test says
bf16; each tolerance is stated where it is used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.models import Denoiser as JaxDenoiser
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.fast import FastDenoiser as JaxFastDenoiser
from image_super_resolution_tpu.models.fast import FastSRGenerator as JaxFastSRGenerator
from image_super_resolution_tpu.ops.conv import ConvBlock as JaxConvBlock
from image_super_resolution_tpu.ops.fuse import fuse_conv_bn as jax_fuse_conv_bn
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import _apply_train
from image_super_resolution_tpu.train.steps import (
    make_pixel_train_step as jax_make_pixel_train_step,
)
from image_super_resolution_tpu.losses import mse_loss as jax_mse_loss
from image_super_resolution_tpu_torch.interop.from_jax import (
    variables_from_jax,
    variables_to_jax,
)
from image_super_resolution_tpu_torch.models.denoiser import Denoiser
from image_super_resolution_tpu_torch.models.fast import FastDenoiser, FastSRGenerator
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.ops.conv import ConvBlock, batch_norms, commit_batch_stats
from image_super_resolution_tpu_torch.ops.fuse import fuse_conv_bn
from image_super_resolution_tpu_torch.ops.initializers import init_weights
from image_super_resolution_tpu_torch.train.state import TrainState, linear_lr
from image_super_resolution_tpu_torch.train.steps import (
    make_denoise_train_step,
    make_pixel_train_step,
)
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

# fp32 steps: the same convs summed in another order. Both sides are held
# on the scale of the float64 run (scripts/torch_train_fp64_gap.py, on the
# CPU): each fp32 side lies within 1.09e-6 of the model's largest float64
# gradient (the port 0.95e-6, JAX 1.09e-6, both worst on tail.conv.weight of
# the Denoiser d2 w8, spread over every tensor), and its three losses within
# 7.4e-7 relative (the two sides' gaps sum to at most 9.8e-7, at step 2).
# Bounds: twice the sum of the two sides' gaps, on the same scale:
# GRAD_RTOL of the largest gradient (elementwise) and LOSS_RTOL relative.
# After three steps at lr 1e-3, params, EMA and
# BN statistics within 2e-7 (bound STEP_ATOL), except where a gradient is
# itself rounding noise (|g| ~ 1e-8, Adam's eps): Adam divides it by its
# own size, so its update can differ by a good part of lr. Up to
# NOISY_SHARE of a leaf's elements may do so, each by at most 2 * 3 * lr,
# the most two Adam trajectories part in three steps. The BN statistics of
# later batches see those elements: measured within 4e-6 (bound STATS_ATOL).
GRAD_RTOL = 4e-6
LOSS_RTOL = 2e-6
STEP_ATOL = 2e-6
STATS_ATOL = 2e-5
NOISY_SHARE = 1e-3
LR = 1e-3
TOTAL = 30  # schedule length of the step tests


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(ours, theirs, atol, what, noisy_share=0.0):
    a, b = _flat(ours), _flat(_np(theirs))
    assert sorted(a) == sorted(b), what
    for k in a:
        diff = np.abs(a[k] - b[k])
        if noisy_share:
            assert (diff > atol).mean() <= noisy_share, f"{what} {k}: {(diff > atol).sum()}"
            atol_k = 6 * LR
        else:
            atol_k = atol
        assert diff.max(initial=0) <= atol_k, f"{what} {k}: {diff.max()} > {atol_k}"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _port_state(model, jax_state, ema_tau=TOTAL):
    model.load_state_dict(variables_from_jax(_np(jax_state.params),
                                             _np(jax_state.batch_stats)))
    return TrainState(model, lr=LR, total_steps=TOTAL, ema_tau=ema_tau)


def _jax_state(model, shape=(1, 16, 16, 3), ema_tau=TOTAL, weight_decay=0.0):
    tx = build_optimizer(lr=LR, total_steps=TOTAL, weight_decay=weight_decay)
    return create_train_state(model, shape, tx, jax.random.PRNGKey(0), ema_tau=ema_tau)


def _assert_states_close(state, jstate):
    params, stats = variables_to_jax(state.model.state_dict())
    e_params, e_stats = variables_to_jax(state.ema.state_dict())
    _assert_trees_close(params, jstate.params, STEP_ATOL, "params", NOISY_SHARE)
    _assert_trees_close(stats, jstate.batch_stats, STATS_ATOL, "batch_stats")
    _assert_trees_close(e_params, jstate.ema.params, STEP_ATOL, "ema params", NOISY_SHARE)
    _assert_trees_close(e_stats, jstate.ema.batch_stats, STATS_ATOL, "ema batch_stats")
    assert state.step == int(jstate.step) and state.ema.updates == int(jstate.ema.updates)


# ------------------------------------------------------------- BatchNorm --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_conv_block_train_mode_matches_flax(dtype):
    """Train-mode ConvBlock(use_bn=True): output and the running mean/var
    after one forward, against flax. flax reduces bf16 activations for the
    batch statistics in fp32 and normalizes in fp32; the port does the same
    (native_batch_norm's fp32 accumulators), so in bf16 the output is equal
    bit for bit and the statistics agree to fp32 rounding (1e-6), where a
    bf16 reduction would be off by ~1e-2. flax folds the *biased* variance
    into ``var``; torch's BatchNorm2d would fold the unbiased one, n/(n-1)
    = 1.0025 larger here, far outside 1e-6."""
    x = np.random.default_rng(0).standard_normal((4, 10, 10, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblock = JaxConvBlock(24, 3, act=("leaky_relu", 0.2), use_bn=True, dtype=jdt)
    v = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, mutated = jblock.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    block = ConvBlock(16, 24, 3, act=("leaky_relu", 0.2), use_bn=True, dtype=tdt,
                      param_dtype=torch.float32, device="cpu")
    block.load_state_dict(variables_from_jax(_np(v["params"]), _np(v["batch_stats"])))
    block.train()
    got = block(torch.from_numpy(x).to(tdt))
    assert block.bn.batch_stats is not None
    commit_batch_stats(batch_norms(block))
    assert block.bn.batch_stats is None
    _, stats = variables_to_jax(block.state_dict())
    _assert_trees_close(stats, mutated["batch_stats"], 1e-6, "running stats")
    got = got.float().detach().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_batchnorm_eval_mode_uses_running_stats():
    """Eval mode normalizes with the running statistics, as flax's
    use_running_average: fp32, within 1e-6."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    jblock = JaxConvBlock(8, 3, use_bn=True, dtype=jnp.float32)
    v = _np(jblock.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    v["params"]["bn"] = {"scale": rng.uniform(0.5, 2, 8).astype(np.float32),
                         "bias": rng.standard_normal(8).astype(np.float32)}
    v["batch_stats"]["bn"] = {"mean": rng.standard_normal(8).astype(np.float32),
                              "var": rng.uniform(0.1, 3, 8).astype(np.float32)}
    want = np.asarray(jblock.apply(v, jnp.asarray(x), train=False))
    block = ConvBlock(8, 8, 3, use_bn=True, param_dtype=torch.float32, device="cpu").eval()
    block.load_state_dict(variables_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fuse_conv_bn_matches_jax():
    """The fold on a trained-looking tree (random BN params and statistics,
    a conv with and one without its own bias): equal to the JAX fold within
    one fp32 ulp of the values (1e-6 relative)."""
    rng = np.random.default_rng(3)

    def bn():
        return ({"scale": rng.uniform(0.5, 2, 4).astype(np.float32),
                 "bias": rng.standard_normal(4).astype(np.float32)},
                {"mean": rng.standard_normal(4).astype(np.float32),
                 "var": rng.uniform(0.01, 2, 4).astype(np.float32)})

    (p1, s1), (p2, s2) = bn(), bn()
    params = {"a": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)},
                    "bn": p1},
              "b": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 4)).astype(np.float32),
                             "bias": rng.standard_normal(4).astype(np.float32)}, "bn": p2},
              "c": {"conv": {"kernel": rng.standard_normal((1, 1, 4, 3)).astype(np.float32),
                             "bias": rng.standard_normal(3).astype(np.float32)}}}
    stats = {"a": {"bn": s1}, "b": {"bn": s2}}
    got, want = _flat(fuse_conv_bn(params, stats)), _flat(_np(jax_fuse_conv_bn(params, stats)))
    assert sorted(got) == sorted(want) and not any("bn" in k for k in got)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)


# ----------------------------------------------------- models and counts --

@pytest.mark.parametrize("scale,enchant,count", [(2, False, 11_735_875),
                                                 (4, False, 11_883_587),
                                                 (2, True, 11_726_595)])
def test_generator_golden_param_counts(scale, enchant, count):
    """The training generator at depth 16 (BN unless enchant): the golden
    counts of the JAX package (models/generator.py:16-18)."""
    model = SRGenerator(depth=16, scale=scale, enchant=enchant, fused=False, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("enchant", [False, True])
def test_training_generator_tree_matches_jax(enchant):
    """fused=False names and shapes every param and BN statistic as the JAX
    generator does, so checkpoints carry over leaf for leaf."""
    jm = JaxSRGenerator(depth=1, width=8, scale=4, enchant=enchant)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    model = SRGenerator(depth=1, width=8, scale=4, enchant=enchant, fused=False,
                        device="cpu")
    params, stats = variables_to_jax(model.state_dict())
    for ours, theirs in ((params, v["params"]), (stats, v.get("batch_stats", {}))):
        a, b = _flat(ours), jax.tree_util.tree_leaves_with_path(theirs)
        b = {"/".join(k.key for k in path): leaf.shape for path, leaf in b}
        assert sorted(a) == sorted(b)
        assert all(a[k].shape == b[k] for k in a)
    assert bool(stats) != enchant


def test_init_weights_distribution_and_seed():
    """--seed draws the JAX package's distributions: every kernel within
    +-weight_scale/sqrt(fan_in) (0.2x for enchant), biases within
    +-1/sqrt(fan_in), BN at 1/0; the same seed gives the same weights."""
    a = init_weights(SRGenerator(depth=1, width=8, enchant=True, device="cpu"), 5)
    b = init_weights(SRGenerator(depth=1, width=8, enchant=True, device="cpu"), 5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for mod in a.modules():
        if isinstance(mod, ConvBlock):
            w = mod.conv.weight
            bound = 1 / np.sqrt(w[0].numel())
            top = float(w.detach().abs().max())
            assert 0.15 * bound < top <= 0.2 * bound
            assert float(mod.conv.bias.detach().abs().max()) <= bound
    bn = init_weights(SRGenerator(depth=1, width=8, fused=False, device="cpu"), 5)
    assert float(bn.rrdb0.rdb0.conv0.bn.weight.detach().min()) == 1.0


def test_remat_gives_the_same_step():
    """remat recomputes each RRDB in backward: the same gradients, and the
    BN statistics folded in once (not again by the recomputation)."""
    states = []
    for remat in (False, True):
        model = init_weights(SRGenerator(depth=2, width=8, fused=False, remat=remat,
                                         device="cpu"), 1)
        state = TrainState(model, total_steps=4)
        step = make_pixel_train_step(2)
        for i in range(2):
            step(state, torch.from_numpy(_u8((2, 16, 16, 3), i)))
        states.append(state.model.state_dict())
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], rtol=0, atol=1e-6)


# ---------------------------------------------------------- optimizer --

@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_chain_matches_optax(weight_decay):
    """clip 10 -> coupled L2 -> Adam -> linear schedule, on one tensor with
    set gradients (one step's norm 50x over the clip): the JAX package's
    chain within 1e-6."""
    rng = np.random.default_rng(23)
    w0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(4)]
    grads[1] *= 50.0
    tx = build_optimizer(lr=1e-2, lr2=0.01, total_steps=10, weight_decay=weight_decay)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = {"w": params["w"] + updates["w"]}

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))

    state = TrainState(One(), lr=1e-2, lr2=0.01, total_steps=10,
                       weight_decay=weight_decay)  # its EMA plays no part here
    for g in grads:
        state.model.w.grad = torch.from_numpy(g.copy())
        state.clip_and_adam()
    np.testing.assert_allclose(state.model.w.detach().numpy(), np.asarray(params["w"]),
                               rtol=0, atol=1e-6)


def test_linear_lr_matches_optax_schedule():
    import optax

    sched = optax.linear_schedule(1e-4, 1e-6, 7)
    for k in range(10):
        assert abs(linear_lr(k, 1e-4, 0.01, 7) - float(sched(k))) < 1e-11


# ---------------------------------------------------------------- steps --

@pytest.mark.parametrize("family", ["sr", "fast"])
def test_three_pixel_steps_match_jax(family):
    """Three pixel steps (x2, fp32) on the same uint8 batches from the same
    weights: each loss within LOSS_RTOL, then params, BN running statistics
    and EMA within STEP_ATOL of the JAX TrainState."""
    if family == "sr":
        jm = JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32)
        model = SRGenerator(depth=1, width=8, scale=2, fused=False, device="cpu")
    else:
        jm = JaxFastSRGenerator(depth=1, width=8, scale=2, refine_blocks=1, refine_width=4,
                                dtype=jnp.float32)
        model = FastSRGenerator(depth=1, width=8, scale=2, refine_blocks=1, refine_width=4,
                                param_dtype=torch.float32, device="cpu")
    jstate = _jax_state(jm)
    state = _port_state(model, jstate)
    jstep, step = jax_make_pixel_train_step(2), make_pixel_train_step(2)
    for i in range(3):
        u8 = _u8((2, 16, 16, 3), i)
        jstate, metrics = jstep(jstate, jnp.asarray(u8))
        loss = step(state, torch.from_numpy(u8))
        assert loss.shape == () and loss.requires_grad is False
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    _assert_states_close(state, jstate)


def _three_denoise_steps(jstate, state, loss_rtol=LOSS_RTOL, check=_assert_states_close):
    """Three denoise steps on both sides with the degradation replaced by a
    fixed noisy image: each loss within ``loss_rtol``, then ``check`` the
    states (by default as in the pixel test)."""
    rng = np.random.default_rng(9)

    @jax.jit
    def jstep(s, u8, noisy01):
        from image_super_resolution_tpu.data.transforms import normalize, to_tanh

        hr, lr = to_tanh(u8), normalize(noisy01)

        def loss(params):
            out, new_stats = _apply_train(s, params, lr)
            return jax_mse_loss(out, hr), new_stats

        (val, stats), grads = jax.value_and_grad(loss, has_aux=True)(s.params)
        return s.apply_gradients(grads, stats), val

    for i in range(3):
        u8 = _u8((2, 16, 16, 3), 10 + i)
        noisy = np.clip(u8 / 255.0 + rng.normal(0, 0.05, u8.shape), 0, 1).astype(np.float32)
        step = make_denoise_train_step(degradation=lambda gen, x01: torch.from_numpy(noisy))
        jstate, jloss = jstep(jstate, jnp.asarray(u8), jnp.asarray(noisy))
        loss = step(state, torch.from_numpy(u8), torch.Generator())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_rtol)
    check(state, jstate)


def test_three_denoise_steps_match_jax():
    """Three denoise steps (Denoiser depth 2, width 8, fp32, tau 2000) with
    the degradation replaced by a fixed noisy image on both sides: loss,
    params, BN statistics and EMA as in the pixel test."""
    jm = JaxDenoiser(depth=2, width=8, dtype=jnp.float32)
    jstate = _jax_state(jm, ema_tau=2000.0)
    state = _port_state(Denoiser(depth=2, width=8, fused=False, device="cpu"), jstate,
                        ema_tau=2000.0)
    _three_denoise_steps(jstate, state)


@pytest.mark.parametrize("downshuffle,depth,refine", [(1, 2, 0), (2, 1, 2)],
                         ids=["fullres", "refine"])
def test_three_fast_denoise_steps_match_jax(downshuffle, depth, refine):
    """The denoise quality experiment's fast arms take the same steps as
    JAX's: the trunk at full resolution (its W arm, downshuffle 1) and at
    half resolution with a refinement tail (its N arm), width 16 (the
    refinement's too, so that each kernel has over 1,000 elements, as
    NOISY_SHARE presumes), fp32, tau 2000, three steps as in
    test_three_denoise_steps_match_jax."""
    kw = dict(depth=depth, width=16, downshuffle=downshuffle, refine_blocks=refine,
              refine_width=16)
    jstate = _jax_state(JaxFastDenoiser(**kw, dtype=jnp.float32), ema_tau=2000.0)
    state = _port_state(FastDenoiser(**kw, param_dtype=torch.float32, device="cpu"), jstate,
                        ema_tau=2000.0)
    _three_denoise_steps(jstate, state)


# bf16 (fp32 params), where the CLIs train, from the W case of
# scripts/torch_train_fp64_gap.py (each side against a float64 run): the
# loss gap within the sum of the two sides' largest bf16 loss errors,
# 1.63e-4 + 2.24e-4 (the gap reads 1.0e-4); a gradient's sign differs from
# float64 on 2.1e-3 (port) and 2.2e-3 (JAX) of the elements, where an Adam
# update may part by up to 2 LR, so over three steps at most 3 x 4.3e-3 of
# the elements may part by more than LR / 10 (read: 4.5e-3), none by more
# than 6 LR.
LOSS_BF16_RTOL = 4e-4
BF16_PART_ATOL = LR / 10
BF16_NOISY_SHARE = 1.3e-2


def test_three_fast_denoise_steps_match_bf16_jax():
    """The W arm's configuration (fast denoiser, trunk at full resolution;
    depth 2, width 16) in bf16 with fp32 params, as the CLIs train it:
    three steps against JAX's bf16 TrainState within the float64-derived
    bounds above, the shares over all of the model's elements (its head
    kernel has 432)."""
    kw = dict(depth=2, width=16, downshuffle=1, refine_blocks=0, refine_width=16)
    jstate = _jax_state(JaxFastDenoiser(**kw, dtype=jnp.bfloat16), ema_tau=2000.0)
    state = _port_state(FastDenoiser(**kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                                     device="cpu"), jstate, ema_tau=2000.0)

    def check(state, jstate):
        for ours, theirs in ((state.model, jstate.params), (state.ema, jstate.ema.params)):
            a, b = _flat(variables_to_jax(ours.state_dict())[0]), _flat(_np(theirs))
            assert sorted(a) == sorted(b)
            diff = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in a])
            assert (diff > BF16_PART_ATOL).mean() <= BF16_NOISY_SHARE
            assert diff.max() <= 6 * LR
        assert state.step == int(jstate.step) == 3

    _three_denoise_steps(jstate, state, loss_rtol=LOSS_BF16_RTOL, check=check)


def test_denoise_gradients_match_jax():
    """One denoise step's gradients (Denoiser depth 2, width 8, BN in train
    mode, fp32) on a fixed noisy pair: every element within GRAD_RTOL of
    jax.grad's largest gradient."""
    from image_super_resolution_tpu.data.transforms import normalize, to_tanh
    from image_super_resolution_tpu_torch.data import transforms
    from image_super_resolution_tpu_torch.interop.from_jax import params_from_jax
    from image_super_resolution_tpu_torch.losses.pixel import mse_loss

    jstate = _jax_state(JaxDenoiser(depth=2, width=8, dtype=jnp.float32))
    u8 = _u8((2, 16, 16, 3), 10)
    noisy = np.clip(u8 / 255.0 + np.random.default_rng(9).normal(0, 0.05, u8.shape),
                    0, 1).astype(np.float32)

    def loss(params):
        out, _ = _apply_train(jstate, params, normalize(jnp.asarray(noisy)))
        return jax_mse_loss(out, to_tanh(jnp.asarray(u8)))

    want = params_from_jax(_np(jax.grad(loss)(jstate.params)))
    state = _port_state(Denoiser(depth=2, width=8, fused=False, device="cpu"), jstate)
    mse_loss(state.model(transforms.normalize(torch.from_numpy(noisy))),
             transforms.to_tanh(torch.from_numpy(u8))).backward()
    atol = GRAD_RTOL * max(float(g.abs().max()) for g in want.values())
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0, atol=atol, msg=name)


def test_denoise_step_draws_from_its_generator():
    """The default degradation draws from the step's generator: the same
    seed gives the same loss, another seed another one."""
    losses = []
    for seed in (1, 1, 2):
        model = init_weights(Denoiser(depth=2, width=8, fused=False, device="cpu"), 0)
        state = TrainState(model, total_steps=2)
        losses.append(float(make_denoise_train_step()(
            state, torch.from_numpy(_u8((2, 16, 16, 3), 0)), torch.Generator().manual_seed(seed))))
    assert losses[0] == losses[1] != losses[2]
