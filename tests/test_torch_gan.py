"""The GAN phase of the port against the JAX package on the CPU: the
adversarial losses, ``adaptive_avg_pool``, the discriminator, the truncated
VGG19 and the perceptual loss, three GAN steps, and the eval metrics and
eval step. Models are tiny (depth 2, width 8) and run in fp32 on both sides
unless a test says bf16; each tolerance is stated where it is used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from image_super_resolution_tpu.losses import adversarial as jax_adv
from image_super_resolution_tpu.losses.perceptual import PerceptualLoss as JaxPerceptualLoss
from image_super_resolution_tpu.models import Discriminator as JaxDiscriminator
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.discriminator import (
    adaptive_avg_pool as jax_adaptive_avg_pool,
)
from image_super_resolution_tpu.models.vgg import TruncatedVGG19 as JaxVGG
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import make_eval_step as jax_make_eval_step
from image_super_resolution_tpu.train.steps import make_gan_train_step as jax_make_gan_step
from image_super_resolution_tpu.utils import metrics as jax_metrics
from image_super_resolution_tpu_torch.interop.from_jax import (
    params_from_jax,
    variables_from_jax,
    variables_to_jax,
)
from image_super_resolution_tpu_torch.losses import adversarial
from image_super_resolution_tpu_torch.losses.perceptual import PerceptualLoss
from image_super_resolution_tpu_torch.models.discriminator import (
    Discriminator,
    adaptive_avg_pool,
)
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.models.vgg import (
    TruncatedVGG19,
    init_random_vgg,
    init_vgg_params,
)
from image_super_resolution_tpu_torch.ops.conv import batch_norms, commit_batch_stats
from image_super_resolution_tpu_torch.ops.initializers import init_weights
from image_super_resolution_tpu_torch.train.checkpoint import opt_state_from_jax
from image_super_resolution_tpu_torch.train.state import TrainState
from image_super_resolution_tpu_torch.train.steps import (
    GAN_PARTS,
    make_eval_step,
    make_gan_train_step,
)
from image_super_resolution_tpu_torch.utils import metrics

# fp32 forwards of the same convs summed in another order: within FWD_ATOL
# (+ FWD_RTOL relative). The GAN steps are held as the pixel steps of
# tests/test_torch_train.py are: params, EMA and BN statistics within
# STEP_ATOL / STATS_ATOL, except where a gradient is rounding noise and
# Adam's step is a sign (at most NOISY_SHARE of a tensor, at least one
# element, each within 2 lr of one step). Losses within LOSS_RTOL, the
# pixel tests' bound: measured within 6.8e-7 relative (loss/content;
# scripts/torch_gan_step_gap.py).
FWD_ATOL, FWD_RTOL = 1e-5, 1e-5
LOSS_RTOL = 2e-6
STEP_ATOL, STATS_ATOL, NOISY_SHARE = 2e-6, 2e-5, 1e-3
LR, TOTAL = 1e-3, 30


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
    """Every leaf within ``atol``; with ``noisy_share``, up to that share of
    a leaf's elements (at least one) may be off by up to one step's Adam
    update on each side, 2 lr."""
    a, b = _flat(ours), _flat(_np(theirs))
    assert sorted(a) == sorted(b), what
    for k in a:
        diff = np.abs(a[k] - b[k])
        if noisy_share:
            allowed = max(1, int(noisy_share * diff.size))
            assert (diff > atol).sum() <= allowed, f"{what} {k}: {(diff > atol).sum()}"
        bound = 2 * LR if noisy_share else atol
        assert diff.max(initial=0) <= bound, f"{what} {k}: {diff.max()} > {bound}"


def _close(got, want, atol=FWD_ATOL, rtol=FWD_RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------ losses --

@pytest.mark.parametrize("scale", [1.0, 30.0, 300.0])
def test_bce_with_logits_matches_jax(scale):
    """The stable form, at logits up to +-300 (where log(1 + exp(-x))
    overflows in the naive form): equal to JAX's within 1e-6 relative, and
    finite; the generator and discriminator losses too."""
    rng = np.random.default_rng(int(scale))
    x = (rng.standard_normal((64, 1)) * scale).astype(np.float32)
    y = (rng.standard_normal((64, 1)) * scale).astype(np.float32)
    t = rng.integers(0, 2, (64, 1)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    pairs = [(adversarial.bce_with_logits(tx, torch.from_numpy(t)),
              jax_adv.bce_with_logits(jnp.asarray(x), jnp.asarray(t))),
             (adversarial.generator_adversarial_loss(tx),
              jax_adv.generator_adversarial_loss(jnp.asarray(x))),
             (adversarial.discriminator_loss(tx, ty),
              jax_adv.discriminator_loss(jnp.asarray(x), jnp.asarray(y)))]
    for got, want in pairs:
        assert np.isfinite(float(got))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -------------------------------------------------------- discriminator --

@pytest.mark.parametrize("h,w", [(6, 6), (7, 7), (3, 3), (96, 96), (100, 100), (37, 41)])
def test_adaptive_avg_pool_matches_jax(h, w):
    """torch's bins on NHWC, against the JAX function: the maps D sees at
    patch 96 (6: the identity), 100 (7) and 37 (3, where bins overlap), and
    maps of those sizes themselves; within 1e-6."""
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 5)).astype(np.float32)
    got = adaptive_avg_pool(torch.from_numpy(x), 6, 6)
    assert tuple(got.shape) == (2, 6, 6, 5)
    if (h, w) == (6, 6):
        assert got.data_ptr() == torch.from_numpy(x).data_ptr() or torch.equal(
            got, torch.from_numpy(x))
    _close(got, jax_adaptive_avg_pool(jnp.asarray(x), 6, 6), atol=1e-6, rtol=0)


def test_discriminator_golden_param_count():
    """Discriminator(3, 64, 8, 1024): 23,563,649 params, the JAX package's
    golden count (models/discriminator.py:8)."""
    model = Discriminator(3, 64, 8, 1024, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 23_563_649


def _discriminators(seed=0, shape=(2, 24, 24, 3)):
    jm = JaxDiscriminator(3, 8, 8, 16, dtype=jnp.float32)
    v = _np(jm.init(jax.random.PRNGKey(seed), jnp.zeros(shape)))
    model = Discriminator(3, 8, 8, 16, dtype=torch.float32, device="cpu")
    model.load_state_dict(variables_from_jax(v["params"], v["batch_stats"]))
    return jm, v, model


@pytest.mark.parametrize("size", [24, 37])
def test_discriminator_matches_flax_in_train_and_eval_mode(size):
    """D at width 8 (fc 16) on the same weights: train-mode logits and the
    running statistics after one forward, and eval-mode logits with random
    running statistics, against flax; within FWD_ATOL + FWD_RTOL. The
    NHWC flatten before fc1 is what makes fc1 carried over from flax agree."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jm, v, model = _discriminators()
    want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = model.train()(torch.from_numpy(x))
    _close(got.detach(), want)
    commit_batch_stats(batch_norms(model))
    _, stats = variables_to_jax(model.state_dict())
    _assert_trees_close(stats, mutated["batch_stats"], 1e-5, "D batch_stats")

    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    want = jm.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x))
    model.load_state_dict(variables_from_jax(v["params"], stats))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1)
    _close(got, want)


def test_discriminator_bf16_matches_flax_bf16():
    """bf16 compute, fp32 params, eval mode: within 2% of the logit range
    of flax's bf16 D (both round every conv and dense output to bf16, in
    another order of sums)."""
    x = np.random.default_rng(3).standard_normal((2, 24, 24, 3)).astype(np.float32)
    jm = JaxDiscriminator(3, 8, 8, 16)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    model = Discriminator(3, 8, 8, 16, device="cpu")
    model.load_state_dict(variables_from_jax(v["params"], v["batch_stats"]))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 0.02 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_discriminator_and_vgg_bf16_match_fp32(mode):
    """The full-width D and VGG19 (5, 4) in bf16 against fp32 on the same
    weights (random, seed 0) at 2x96x96: D's logits within 3% of the largest
    fp32 logit, VGG's features within 3% of the largest fp32 feature
    (measured on the CPU over three seeds: 1.2% and 1.1%; the card test in
    tests/test_torch_cuda.py holds the card's bf16 to the same bounds)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 96, 96, 3),
                                                                  dtype=np.float32))
    d32 = init_weights(Discriminator(dtype=torch.float32, device="cpu"), 0)
    d16 = Discriminator(device="cpu")
    d16.load_state_dict(d32.state_dict())
    with torch.no_grad():
        want = getattr(d32, mode)()(x)
        got = getattr(d16, mode)()(x)
    assert (got - want).abs().max().item() <= 0.03 * want.abs().max().item()
    if mode == "train":
        v32 = init_random_vgg(TruncatedVGG19(dtype=torch.float32, device="cpu"))
        v16 = TruncatedVGG19(device="cpu")
        v16.load_state_dict(v32.state_dict())
        with torch.no_grad():
            want, got = v32(x), v16(x)
        assert (got - want).abs().max().item() <= 0.03 * want.abs().max().item()


# ------------------------------------------------------------------ VGG --

def _vgg(i, j, before_act, dtype=jnp.float32):
    jm = JaxVGG(i=i, j=j, before_act=before_act, dtype=dtype)
    params = _np(jm.init(jax.random.PRNGKey(i * 10 + j), jnp.zeros((1, 32, 32, 3)))["params"])
    model = TruncatedVGG19(i, j, before_act, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return jm, params, model


@pytest.mark.parametrize("i,j", [(2, 2), (5, 4)])
@pytest.mark.parametrize("before_act", [False, True])
def test_truncated_vgg19_matches_flax(i, j, before_act):
    """Features at two truncation points, before and after the last ReLU,
    on flax's He-normal weights: the same layers (conv count, pools) and
    within FWD_ATOL + FWD_RTOL of flax's largest feature."""
    jm, params, model = _vgg(i, j, before_act)
    assert model.keep == (4 if (i, j) == (2, 2) else 16)
    assert all(not p.requires_grad for p in model.parameters())
    x = np.random.default_rng(i).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert (got < 0).any() == before_act
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_ATOL + FWD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("feature_norm", [False, True])
@pytest.mark.parametrize("before_act", [False, True])
def test_perceptual_loss_matches_jax(feature_norm, before_act):
    """(perceptual, adversarial, content) against the JAX PerceptualLoss
    at (2, 2): MSE after the ReLU, L1 before it, with and without the
    random-feature RMS normalization; within 1e-5 relative."""
    jm, params, model = _vgg(2, 2, before_act)
    rng = np.random.default_rng(7)
    sr, hr = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    logits = rng.standard_normal((2, 1)).astype(np.float32)
    want = JaxPerceptualLoss(params, 2, 2, before_act=before_act, feature_norm=feature_norm,
                             dtype=jnp.float32)(jnp.asarray(sr), jnp.asarray(hr),
                                                jnp.asarray(logits))
    got = PerceptualLoss(model, feature_norm=feature_norm)(
        torch.from_numpy(sr), torch.from_numpy(hr), torch.from_numpy(logits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_vgg_weights_load_from_npz_and_pth(tmp_path):
    """--vgg_weights: an npz (HWIO) and a torchvision state dict (OIHW,
    ``features.{n}``) load the same weights; a missing file or none falls
    back to random He-normal features with a warning and loaded=False."""
    _, params, want = _vgg(2, 2, False)
    np.savez(tmp_path / "vgg.npz", **{f"{k}/{leaf}": params[k][leaf]
                                      for k in params for leaf in ("kernel", "bias")})
    plan_index = {"conv0": 0, "conv1": 2, "conv2": 5, "conv3": 7}  # torchvision layers
    sd = {f"features.{plan_index[k]}.{n}": t for k, (n, t) in
          ((name.split(".")[0], (name.split(".")[1], t))
           for name, t in want.state_dict().items())}
    torch.save(sd, tmp_path / "vgg.pth")
    for name in ("vgg.npz", "vgg.pth"):
        model, loaded = init_vgg_params(TruncatedVGG19(2, 2, dtype=torch.float32, device="cpu"),
                                        tmp_path / name, with_status=True)
        assert loaded
        for k, t in want.state_dict().items():
            assert torch.equal(model.state_dict()[k], t), (name, k)
    for path in (tmp_path / "missing.npz", None):
        with pytest.warns(UserWarning, match="(?i)random"):
            model, loaded = init_vgg_params(
                TruncatedVGG19(2, 2, dtype=torch.float32, device="cpu"), path,
                with_status=True)
        assert not loaded
        w = model.conv1.weight
        std = float(np.sqrt(2.0 / w[0].numel()))
        assert float(w.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
        assert 0.7 * std < float(w.std()) < 1.3 * std and float(model.conv1.bias.abs().max()) == 0


# --------------------------------------------------------------- GAN step --

def _gan_states(scale=2):
    """The JAX G and D states and the port's on the same weights, and the
    two perceptual losses on the same VGG (2, 2) with feature_norm."""
    tx = lambda: build_optimizer(lr=LR, total_steps=TOTAL)  # noqa: E731
    jg = create_train_state(JaxSRGenerator(depth=2, width=8, scale=scale, dtype=jnp.float32),
                            (1, 12, 12, 3), tx(), jax.random.PRNGKey(0), ema_tau=TOTAL)
    jd = create_train_state(JaxDiscriminator(3, 8, 8, 16, dtype=jnp.float32), (1, 24, 24, 3),
                            tx(), jax.random.PRNGKey(1), with_ema=False)
    g = SRGenerator(depth=2, width=8, scale=scale, fused=False, device="cpu")
    g.load_state_dict(variables_from_jax(_np(jg.params), _np(jg.batch_stats)))
    d = Discriminator(3, 8, 8, 16, dtype=torch.float32, device="cpu")
    d.load_state_dict(variables_from_jax(_np(jd.params), _np(jd.batch_stats)))
    g_state = TrainState(g, lr=LR, total_steps=TOTAL, ema_tau=TOTAL)
    d_state = TrainState(d, lr=LR, total_steps=TOTAL, with_ema=False)
    _, vgg_params, vgg = _vgg(2, 2, False)
    jperc = JaxPerceptualLoss(vgg_params, 2, 2, feature_norm=True, dtype=jnp.float32)
    return jg, jd, jperc, g_state, d_state, PerceptualLoss(vgg, feature_norm=True)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _sync(state, jstate):
    """The port's state set to JAX's: params, BN statistics, Adam, the step
    count and the EMA."""
    state.model.load_state_dict(variables_from_jax(_np(jstate.params),
                                                   _np(jstate.batch_stats)))
    opt_state_from_jax(state, _np(serialization.to_state_dict(jstate.opt_state)))
    state.step = int(jstate.step)
    if jstate.ema is not None:
        with torch.no_grad():
            for k, t in variables_from_jax(_np(jstate.ema.params),
                                           _np(jstate.ema.batch_stats)).items():
                state.ema.state_dict()[k].copy_(t)
        state.ema.updates = int(jstate.ema.updates)


def test_three_gan_steps_match_jax():
    """Three GAN steps (G: sr x2 depth 2 width 8 BN; D width 8; VGG (2, 2)
    with feature_norm; fp32) on the same uint8 batches, each from the same
    state (the port's is set to JAX's before each step): the three losses
    within LOSS_RTOL; then G's params, BN statistics and EMA, and D's params
    and BN statistics (three train forwards per step, of which G's is
    dropped and D's two are folded in turn) within STEP_ATOL / STATS_ATOL
    of JAX's make_gan_train_step, but for the Adam-sign elements.

    Each step starts from JAX's state because an Adam-sign element (one in
    a 3x3x12x4 kernel at the first step) moves the next step's point, and
    the GAN's later steps amplify that: the free-running trajectories part
    by far more than a step's own difference (scripts/torch_gan_step_gap.py
    measures both, and the port's fp32 run against its float64 run)."""
    jg, jd, jperc, g_state, d_state, perc = _gan_states()
    jstep, step = jax_make_gan_step(2, jperc), make_gan_train_step(2, perc)
    for i in range(3):
        _sync(g_state, jg)
        _sync(d_state, jd)
        u8 = _u8((2, 24, 24, 3), i)
        jg, jd, want = jstep(jg, jd, jnp.asarray(u8))
        got = step(g_state, d_state, torch.from_numpy(u8))
        assert sorted(got) == sorted(want)
        for k in want:
            assert not got[k].requires_grad
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        params, stats = variables_to_jax(g_state.model.state_dict())
        e_params, e_stats = variables_to_jax(g_state.ema.state_dict())
        _assert_trees_close(params, jg.params, STEP_ATOL, "G params", NOISY_SHARE)
        _assert_trees_close(stats, jg.batch_stats, STATS_ATOL, "G batch_stats")
        _assert_trees_close(e_params, jg.ema.params, STEP_ATOL, "G ema params", NOISY_SHARE)
        _assert_trees_close(e_stats, jg.ema.batch_stats, STATS_ATOL, "G ema batch_stats")
        params, stats = variables_to_jax(d_state.model.state_dict())
        _assert_trees_close(params, jd.params, STEP_ATOL, "D params", NOISY_SHARE)
        _assert_trees_close(stats, jd.batch_stats, STATS_ATOL, "D batch_stats")
    assert (g_state.step, d_state.step, g_state.ema.updates) == \
        (int(jg.step), int(jd.step), int(jg.ema.updates)) == (3, 3, 3)
    assert d_state.ema is None and jd.ema is None


def test_generator_update_leaves_the_discriminator_untouched():
    """G's loss runs through D, but G's backward and Adam touch G alone: at
    the end of G's update D has no gradient, the same params and running
    statistics, and no pending batch statistics (the ones of its forward
    inside G's loss are dropped); VGG never gets a gradient. D then moves.
    Each gradient has its param's strides (a conv's comes channels-last from
    autograd, and the card's fused Adam refuses a layout that differs)."""
    _, _, _, g_state, d_state, perc = _gan_states()
    d0 = {k: t.clone() for k, t in d_state.model.state_dict().items()}
    g0 = {k: t.clone() for k, t in g_state.model.state_dict().items()}
    seen = []

    def mark(part):
        if part in ("G backward", "D backward"):  # the fused Adam needs p's layout
            st = g_state if part == "G backward" else d_state
            assert all(p.grad.stride() == p.stride() for p in st.params)
        if part == "G clip + Adam":
            assert all(p.grad is None for p in d_state.params)
            assert all(m.batch_stats is None for m in batch_norms(d_state.model))
            for k, t in d_state.model.state_dict().items():
                assert torch.equal(t, d0[k]), k
            assert any(not torch.equal(t, g0[k]) for k, t in g_state.model.state_dict().items())
        seen.append(part)

    make_gan_train_step(2, perc)(g_state, d_state, torch.from_numpy(_u8((2, 24, 24, 3), 0)),
                                 mark)
    assert tuple(seen) == GAN_PARTS
    assert all(p.grad is None for p in perc.vgg.parameters())
    assert any(not torch.equal(t, d0[k]) for k, t in d_state.model.state_dict().items())


def test_constants_made_while_serving_can_be_saved_for_backward():
    """normalize's mean/std tensors are made once per device and dtype; when
    serving (inference mode) asks for them first, the GAN step must still be
    able to divide by them under autograd."""
    from image_super_resolution_tpu_torch.data.transforms import normalize, tanh_to_norm

    mean, std = (0.31, 0.32, 0.33), (0.21, 0.22, 0.23)
    with torch.inference_mode():
        normalize(torch.zeros(1, 2, 2, 3), mean, std)
    x = torch.zeros(1, 2, 2, 3, requires_grad=True)
    tanh_to_norm(x, mean, std).sum().backward()
    torch.testing.assert_close(x.grad[0, 0, 0], 0.5 / torch.tensor(std))


# ---------------------------------------------------------------- eval --

def test_metrics_match_jax():
    """psnr, psnr_y (border 4) and ssim (11x11 Gaussian, VALID) on two
    [0,1] batches: within 1e-4 dB and 1e-5 of JAX's."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)), float(jax_metrics.psnr(ja, jb)),
                               atol=1e-4)
    np.testing.assert_allclose(float(metrics.psnr_y(ta, tb)),
                               float(jax_metrics.psnr_y(ja, jb)), atol=1e-4)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)), float(jax_metrics.ssim(ja, jb)),
                               atol=1e-5)
    assert float(metrics.psnr(ta, ta)) == pytest.approx(120.0)


def test_eval_step_matches_jax_on_the_ema_weights():
    """make_eval_step: the EMA params and BN statistics in eval mode, LR =
    normalize(downscale(x)); PSNR, PSNR-Y and SSIM within 1e-3 dB / 1e-5
    of JAX's. The EMA is set apart from the live params, so a step that
    evaluated the live ones would be off by far more."""
    jg, _, _, g_state, _, _ = _gan_states()
    rng = np.random.default_rng(4)
    shift = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a) * rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), t)
    jg = jg.replace(ema=jg.ema.replace(params=shift(jg.ema.params),
                                       batch_stats=shift(jg.ema.batch_stats)))
    with torch.no_grad():
        for k, t in variables_from_jax(_np(jg.ema.params), _np(jg.ema.batch_stats)).items():
            g_state.ema.state_dict()[k].copy_(t)
    u8 = _u8((2, 24, 24, 3), 5)
    want = jax_make_eval_step(2)(jg, jnp.asarray(u8))
    got = make_eval_step(2)(g_state, torch.from_numpy(u8))
    live = make_eval_step(2)(TrainState(g_state.model, with_ema=False), torch.from_numpy(u8))
    assert sorted(got) == sorted(want) == ["psnr", "psnr_y", "ssim"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=1e-5 if k == "ssim" else 1e-3, err_msg=k)
    assert abs(float(live["psnr"]) - float(want["psnr"])) > 1e-2
    assert g_state.model.training
