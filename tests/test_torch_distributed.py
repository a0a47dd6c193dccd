"""Data-parallel training in the port on the CPU: real processes over gloo
(one per rank, as torchrun starts them; ``tests/torch_dist_worker.py``),
held against JAX's multi-host semantics (``tests/test_multihost.py``) and
against one process.

Three groups of processes start together, once for the module, each
running several phases in the same processes:
- A: two nodes of one rank each over an uneven 23-image manifest: the pixel
  phase with ``--mean`` and eval, the GAN phase, then a resume whose
  checkpoint only rank 0's work dir holds;
- B: one node of two ranks: ``--family fast`` and the ``denoise_fast``
  phase, then library-level steps (three pixel steps of a BN generator,
  without and with remat, and one GAN step, on batches whose halves
  differ);
- C: one node of three ranks at ``--batch_size 4``: the data group shrinks
  to two ranks and the third exits.
The stripes and rows of the loader, ``distributed_init``, the global
BatchNorm and the logger are tested without processes. Models are depth
1-2 and width 8 (D and VGG at full width in the CLI's GAN phase), patches
32; every tolerance is stated where it is used."""

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_super_resolution_tpu.core.mesh import (
    largest_divisible_device_count as jax_largest_divisible_device_count,
)
from image_super_resolution_tpu.data.pipeline import (
    LoaderConfig as JaxLoaderConfig,
    PatchLoader as JaxPatchLoader,
)
from image_super_resolution_tpu.losses.perceptual import PerceptualLoss as JaxPerceptualLoss
from image_super_resolution_tpu.models import Discriminator as JaxDiscriminator
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.models.vgg import TruncatedVGG19 as JaxVGG
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import make_gan_train_step as jax_make_gan_step
from image_super_resolution_tpu.train.steps import (
    make_pixel_train_step as jax_make_pixel_train_step,
)
from image_super_resolution_tpu_torch.cli.train import denoise_seed
from image_super_resolution_tpu_torch.core import mesh
from image_super_resolution_tpu_torch.data.pipeline import LoaderConfig, PatchLoader
from image_super_resolution_tpu_torch.interop.from_jax import (
    params_from_jax,
    variables_from_jax,
    variables_to_jax,
)
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.ops.conv import GlobalBatchNorm
from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from image_super_resolution_tpu_torch.train.state import TrainState
from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb
from image_super_resolution_tpu_torch.utils.logging import MetricsLogger
from image_super_resolution_tpu_torch.utils.png import write_png

import torch_dist_worker
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

Group = torch_dist_worker.Group

# The tolerances of tests/test_torch_train.py and tests/test_torch_gan.py
# (fp32 steps summed in other orders; see there): gradients within GRAD_RTOL
# of the largest gradient, losses within LOSS_RTOL, params and EMA within
# STEP_ATOL but for at most NOISY_SHARE of a tensor (Adam-sign elements,
# each within 6 lr), BN statistics within STATS_ATOL. Two ranks against one
# process differ only by where the sums are split (the BN sums per rank,
# then combined; the gradient sum per rank, then averaged), so the same
# bounds hold, and JAX is held to them as well.
GRAD_RTOL, LOSS_RTOL = 4e-6, 2e-6
STEP_ATOL, STATS_ATOL, NOISY_SHARE = 2e-6, 2e-5, 1e-3
LR, TOTAL = 1e-3, 30
# Per-rank BatchNorm statistics (each half normalized alone) move the
# first step's gradients by far more than GRAD_RTOL on these batches: the
# test asserts at least PER_RANK_FACTOR times it.
PER_RANK_FACTOR = 100


# ---------------------------------------------------------------- helpers --

def _phases(out: str, rank: int) -> list:
    """A rank's output cut at its ``PHASE name DONE`` lines, in order:
    (name, what the phase printed, its summary {saves, hash})."""
    res, start = [], 0
    for m in re.finditer(rf"WORKER {rank} PHASE (\w+) DONE(.*)\n", out):
        res.append((m.group(1), out[start:m.start()],
                    dict(kv.split("=") for kv in m.group(2).split())))
        start = m.end()
    return res


def _manifest(folder: Path, n: int, size=(48, 48), seed=0) -> Path:
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = folder / f"i{i}.png"
        write_png(p, rng.integers(0, 255, (*size, 3), dtype=np.uint8))
        paths.append(str(p))
    m = folder / "train_images.json"
    m.write_text(json.dumps(paths))
    return m


def _cli_args(manifest: Path, work, *more):
    return ["--scale", "2", "--save_name", "mh", "--train_json", str(manifest),
            "--work_dir", str(work), "--epochs", "1", "--batch_size", "4", "--rs_deep", "1",
            "--width", "8", "--shape", "32", "--no_tensorboard", "--worker", "2",
            "--loader_backend", "python", "--device", "cpu", *more]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def _one_thread():
    """torch on one thread for this process's tiny steps (as the workers
    run): beside the suite's other workers, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _spec():
    """JAX's initial G (sr x2 d2 w8 BN), D (3-8-8-16) and VGG (2, 2), the
    port's state dicts of the same weights, and the batches. (Each init is
    jitted: the same values as eager, in a third of the time.)"""
    tx = lambda: build_optimizer(lr=LR, total_steps=TOTAL)  # noqa: E731
    jg = jax.jit(lambda key: create_train_state(
        JaxSRGenerator(depth=2, width=8, scale=2, dtype=jnp.float32), (1, 16, 16, 3), tx(),
        key, ema_tau=TOTAL))(jax.random.PRNGKey(0))
    jd = jax.jit(lambda key: create_train_state(
        JaxDiscriminator(3, 8, 8, 16, dtype=jnp.float32), (1, 24, 24, 3), tx(), key,
        with_ema=False))(jax.random.PRNGKey(1))
    jvgg = JaxVGG(i=2, j=2, before_act=False, dtype=jnp.float32)
    vgg_params = _np(jax.jit(jvgg.init)(jax.random.PRNGKey(22),
                                        jnp.zeros((1, 32, 32, 3)))["params"])
    spec = {"lr": LR, "total": TOTAL,
            "g": variables_from_jax(_np(jg.params), _np(jg.batch_stats)),
            "d": variables_from_jax(_np(jd.params), _np(jd.batch_stats)),
            "vgg": params_from_jax(vgg_params),
            "pixel": [torch.from_numpy(torch_dist_worker.halves((4, 16, 16, 3), i))
                      for i in range(3)],
            "gan": torch.from_numpy(torch_dist_worker.halves((4, 24, 24, 3), 7))}
    return spec, jg, jd, vgg_params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start groups A, B and C (all at once), and build what the tests
    compare them with."""
    tmp = tmp_path_factory.mktemp("dist")
    m23 = _manifest(tmp / "data", 23)
    # group A's resume: a mid-run checkpoint (epoch 0, step 2, with Adam) in
    # rank 0's work dir only, of the model the CLI builds
    (tmp / "w0").mkdir()
    (tmp / "w1").mkdir()
    model = SRGenerator(depth=1, width=8, scale=2, fused=False, dtype=torch.bfloat16,
                        param_dtype=torch.float32, device="cpu")
    state = TrainState(model, total_steps=4, ema_tau=4.0)
    state.step = 2
    save_checkpoint(tmp / "w0" / "res_mh_1_0.2.ckpt", state, 0, [0.485, 0.456, 0.406],
                    [0.229, 0.224, 0.225], [0.1], final=False)
    (tmp / "steps").mkdir()
    groups = {
        "A": Group(tmp, "A", [
            {"phase": "pixel", "args": _cli_args(m23, tmp / "a", "--mean", "--eval_every", "1",
                                                 "--eval_json", str(m23))},
            {"phase": "gan", "args": _cli_args(m23, tmp / "a")},
            {"phase": "pixel", "args": _cli_args(m23, tmp / "w{rank}", "--resume",
                                                 "--epochs", "2")}], world=2, local_world=1),
        "B": Group(tmp, "B", [
            {"phase": "pixel", "args": _cli_args(m23, tmp / "b", "--family", "fast")},
            {"phase": "denoise", "args": _cli_args(m23, tmp / "b", "--family", "fast")},
            {"phase": "steps", "spec": str(tmp / "spec.pt"), "out": str(tmp / "steps")}],
            world=2, local_world=2),
        "C": Group(tmp, "C", [{"phase": "pixel", "args": _cli_args(m23, tmp / "c")}],
                   world=3, local_world=3),
    }
    spec, jg, jd, vgg_params = _spec()  # while the groups run; B waits for the file
    torch.save(spec, tmp / "spec.tmp")
    (tmp / "spec.tmp").rename(tmp / "spec.pt")
    return {"tmp": tmp, "m23": m23, "groups": groups, "spec": spec, "jg": jg, "jd": jd,
            "vgg_params": vgg_params}


def _group(runs, name: str, world: int):
    rcs, outs = runs["groups"][name].outs()
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"group {name} rank {rank} failed:\n{out[-4000:]}"
    return outs


def _single_writer_and_equal(outs, index: int, ranks):
    """Phase ``index`` of each rank: rank 0 saved once, the others never,
    and their params hash the same."""
    summaries = [_phases(outs[r], r)[index][2] for r in ranks]
    assert [s["saves"] for s in summaries] == ["1"] + ["0"] * (len(ranks) - 1), summaries
    assert len({s["hash"] for s in summaries}) == 1, summaries  # ranks bit-equal
    return summaries


# ------------------------------------------------------- the CLI, A-C --

def test_two_nodes_uneven_manifest_with_mean_and_eval(runs):
    """23 images over two nodes (JAX's hosts): equal stripes of 11, the
    remainder dropped, 2 steps per epoch on both, global batch 8; --mean
    from the whole manifest on every rank; eval in lockstep, logged by rank
    0; one checkpoint, written by rank 0, whose losses are the global means
    both ranks print."""
    outs = _group(runs, "A", 2)
    segs = [_phases(out, r)[0][1] for r, out in enumerate(outs)]
    assert "multi-host 2 processes, global batch 8" in segs[0]
    for seg in segs:
        assert "11 images, 2 steps/epoch" in seg and "Eval [0]" in seg
    epoch = [re.search(r"Epoch \[0\] mean loss (\S+)", seg).group(1) for seg in segs]
    assert epoch[0] == epoch[1]
    _single_writer_and_equal(outs, 0, [0, 1])
    meta = load_checkpoint(runs["tmp"] / "a" / "res_mh_1_0.2.ckpt")["meta"]
    assert meta["step"] == 2 and np.all(np.isfinite(meta["loss"]))
    assert f"{np.mean(meta['loss']):.5f}" == epoch[0]
    full = PatchLoader(runs["m23"], LoaderConfig())
    assert meta["mean"] == pytest.approx(full.calculate_stats()[0], abs=1e-12)
    logs = list((runs["tmp"] / "a").glob("*_metrics.jsonl"))
    assert len(logs) == 1  # one writer, and eval logged
    assert '"eval/psnr"' in logs[0].read_text()


def test_two_nodes_gan_phase(runs):
    """Then the GAN phase in the same processes: G warm-started on both, D
    at full width and VGG19 (5, 4) agreed from rank 0, both optimizers
    over the data group; ranks bit-equal and one writer, D saved."""
    outs = _group(runs, "A", 2)
    for r, out in enumerate(outs):
        assert _phases(out, r)[1][0] == "gan"
        assert "loaded pre-trained generator" in _phases(out, r)[1][1]
    _single_writer_and_equal(outs, 1, [0, 1])
    data = load_checkpoint(runs["tmp"] / "a" / "gen_mh_1_0.2.ckpt")
    assert "d_params" in data and np.all(np.isfinite(data["meta"]["loss"]))


def test_resume_without_shared_work_dir(runs):
    """Only rank 0's work dir holds the checkpoint: rank 0 prints "load
    from", rank 1 does not, and both continue at epoch 1 (rank 0's state and
    first epoch); rank 0 alone writes, so rank 1's dir stays empty."""
    outs = _group(runs, "A", 2)
    resumed = [_phases(out, r)[2][1] for r, out in enumerate(outs)]
    assert "load from" in resumed[0] and "load from" not in resumed[1]
    for text in resumed:
        assert "Epoch [1]" in text and "Epoch [0]" not in text
    _single_writer_and_equal(outs, 2, [0, 1])
    meta = load_checkpoint(runs["tmp"] / "w0" / "res_mh_1_0.2.ckpt")["meta"]
    assert meta["epoch"] == 1 and meta["step"] == 4 and np.all(np.isfinite(meta["loss"]))
    assert not list((runs["tmp"] / "w1").iterdir())


def test_fast_then_denoise_fast_on_one_node(runs):
    """--family fast, then the denoise_fast phase, over two ranks of one
    node (each 2 rows of the batch of 4): ranks bit-equal, one writer."""
    outs = _group(runs, "B", 2)
    for index, phase in ((0, "pixel"), (1, "denoise")):
        _single_writer_and_equal(outs, index, [0, 1])
        for r, out in enumerate(outs):
            name, text, _ = _phases(out, r)[index]
            assert name == phase and "23 images, 5 steps/epoch" in text
    for name in ("res_mh_1_0.2.ckpt", "denoise_mh_1_0.2.ckpt"):
        meta = load_checkpoint(runs["tmp"] / "b" / name)["meta"]
        assert meta["step"] == 5 and np.all(np.isfinite(meta["loss"]))


def test_three_ranks_shrink_to_two(runs):
    """--batch_size 4 over three ranks of one node: the data mesh shrinks
    to the largest count that divides the batch (2, JAX's rule); rank 2
    prints JAX's message and exits 0; ranks 0 and 1 train bit-equal."""
    outs = _group(runs, "C", 3)
    msg = "Train: batch_size=4 not divisible by 3 devices; using a 2-device data mesh"
    for out in outs:
        assert msg in out
    assert "WORKER 2 PHASE" not in outs[2] and "rank 2 is outside the data mesh" in outs[2]
    _single_writer_and_equal(outs, 0, [0, 1])
    meta = load_checkpoint(runs["tmp"] / "c" / "res_mh_1_0.2.ckpt")["meta"]
    assert meta["step"] == 5 and np.all(np.isfinite(meta["loss"]))


# ------------------------------------- two ranks against one process and JAX --

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close(ours, theirs, atol, what, noisy_share=0.0, steps=3):
    """Flax trees (or state dicts) within ``atol``; with ``noisy_share``, up
    to that share of a tensor's elements (at least one,
    tests/test_torch_gan.py's rule) may be off by up to 2 lr per step
    (Adam-sign elements)."""
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b), what
    for k in a:
        diff = np.abs(a[k] - b[k])
        if noisy_share:
            allowed = max(1, int(noisy_share * diff.size))
            assert (diff > atol).sum() <= allowed, f"{what} {k}: {(diff > atol).sum()}"
        bound = 2 * steps * LR if noisy_share else atol
        assert diff.max(initial=0) <= bound, f"{what} {k}: {diff.max()} > {bound}"


def _sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _loss_close(got, one, jax_value, what):
    """The ranks' mean loss within LOSS_RTOL of one process, and from JAX
    no further than one process is plus LOSS_RTOL: the one-process gap
    itself is tests/test_torch_gan.py's to bound (on this batch, whose
    halves lie at the two ends of the range, loss/content reads 2.02e-6
    relative in one process, over the 6.8e-7 measured there)."""
    np.testing.assert_allclose(got, one, rtol=LOSS_RTOL, err_msg=what)
    assert abs(got - jax_value) <= abs(one - jax_value) + LOSS_RTOL * abs(jax_value), what


def _grads_close(got, want, what):
    scale = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / scale
        assert err <= GRAD_RTOL, f"{what} {k}: {err:.3g} of the largest > {GRAD_RTOL}"


@pytest.fixture(scope="module")
def steps(runs):
    """The two ranks' dumps, the one-process port's run on the whole
    batches, and JAX's pixel and GAN states after its steps on them."""
    _group(runs, "B", 2)
    ranks = [torch.load(runs["tmp"] / "steps" / f"rank{r}.pt") for r in range(2)]
    with _one_thread():
        one = torch_dist_worker.run_steps(runs["spec"], slice(None), parts=("pixel", "gan"))
    jg, jd, spec = runs["jg"], runs["jd"], runs["spec"]
    jstep = jax_make_pixel_train_step(2)
    jlosses, js = [], jg
    for b in spec["pixel"]:
        js, m = jstep(js, jnp.asarray(b.numpy()))
        jlosses.append(float(m["loss"]))
    jperc = JaxPerceptualLoss(runs["vgg_params"], 2, 2, feature_norm=True, dtype=jnp.float32)
    jgan_g, jgan_d, jgan = jax_make_gan_step(2, jperc)(jg, jd, jnp.asarray(spec["gan"].numpy()))
    return {"ranks": ranks, "one": one, "jax_pixel": (js, jlosses),
            "jax_gan": (jgan_g, jgan_d, {k: float(v) for k, v in jgan.items()})}


def test_two_ranks_pixel_steps_match_one_process_and_jax(steps):
    """Three pixel steps on two ranks (each one half of every batch) against
    the one-process port and JAX on the whole batches: the mean of the
    ranks' losses as ``_loss_close`` holds them, the gradients the optimizer took at
    every step within GRAD_RTOL of the largest, then params, BN statistics
    and EMA within STEP_ATOL / STATS_ATOL. Per-rank statistics would fail
    by far (test_per_rank_batchnorm_would_fail)."""
    ranks, one = steps["ranks"], steps["one"]["pixel"]
    js, jlosses = steps["jax_pixel"]
    got = ranks[0]["pixel"]
    losses = np.mean([r["pixel"]["losses"] for r in ranks], axis=0)
    for i in range(3):
        _loss_close(losses[i], one["losses"][i], jlosses[i], f"step {i}")
    for i, (g, w) in enumerate(zip(got["grads"], one["grads"])):
        _grads_close(g, w, f"step {i}")
    assert got["step"] == one["step"] == int(js.step) == 3
    params, stats = variables_to_jax(got["model"])
    e_params, e_stats = variables_to_jax(got["ema"])
    _close(_sd(got["model"]), _sd(one["model"]), STEP_ATOL, "vs one process", NOISY_SHARE)
    _close(_sd(got["ema"]), _sd(one["ema"]), STEP_ATOL, "EMA vs one process", NOISY_SHARE)
    _close(params, _np(js.params), STEP_ATOL, "params vs JAX", NOISY_SHARE)
    _close(stats, _np(js.batch_stats), STATS_ATOL, "batch_stats vs JAX")
    _close(e_params, _np(js.ema.params), STEP_ATOL, "EMA params vs JAX", NOISY_SHARE)
    _close(e_stats, _np(js.ema.batch_stats), STATS_ATOL, "EMA batch_stats vs JAX")


def test_two_ranks_gan_step_matches_one_process_and_jax(steps):
    """One GAN step from the same state on two ranks: the three losses
    (means of the ranks') as ``_loss_close`` holds them; G's
    and D's gradients within GRAD_RTOL of one process's largest; G's
    params, statistics and EMA and D's params and statistics (D's
    statistics from its two forwards, over the global batch) within
    STEP_ATOL / STATS_ATOL of both."""
    ranks, one = steps["ranks"], steps["one"]["gan"]
    jg, jd, jlosses = steps["jax_gan"]
    got = ranks[0]["gan"]
    for k, want in one["losses"].items():
        _loss_close(np.mean([r["gan"]["losses"][k] for r in ranks]), want, jlosses[k], k)
    _grads_close(got["g_grads"], one["g_grads"], "G")
    _grads_close(got["d_grads"], one["d_grads"], "D")
    for key, jstate in (("g", jg), ("d", jd)):
        _close(_sd(got[key]), _sd(one[key]), STEP_ATOL, f"{key} vs one process", NOISY_SHARE,
               steps=1)
        params, stats = variables_to_jax(got[key])
        _close(params, _np(jstate.params), STEP_ATOL, f"{key} params vs JAX", NOISY_SHARE,
               steps=1)
        _close(stats, _np(jstate.batch_stats), STATS_ATOL, f"{key} batch_stats vs JAX")
    e_params, e_stats = variables_to_jax(got["g_ema"])
    _close(e_params, _np(jg.ema.params), STEP_ATOL, "G EMA vs JAX", NOISY_SHARE, steps=1)
    _close(e_stats, _np(jg.ema.batch_stats), STATS_ATOL, "G EMA stats vs JAX")


def test_ranks_stay_bit_equal(steps):
    """Every gradient the optimizers took, every param, statistic and EMA
    entry is the same on both ranks, bit for bit: the statistics are
    combined in rank order, the gradients all-reduced, and the updates
    then the same arithmetic."""
    a, b = steps["ranks"]

    def walk(x, y, path):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, list):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        elif "losses" not in path:  # each rank's loss is its own rows'
            assert x == y, path

    walk(a, b, "")


def test_remat_repeats_the_collectives(steps):
    """With remat each block's forward runs again in backward, its
    BatchNorm collectives with it, on both ranks in the same order (else
    the run would hang or part): the same steps as without remat, within
    1e-6 (tests/test_torch_train.py::test_remat_gives_the_same_step), and
    the gradients within GRAD_RTOL."""
    for dump in steps["ranks"]:
        plain, remat = dump["pixel"], dump["remat"]
        for g, w in zip(remat["grads"], plain["grads"]):
            _grads_close(g, w, "remat")
        for k, t in plain["model"].items():
            torch.testing.assert_close(remat["model"][k], t, rtol=0, atol=1e-6)


def test_per_rank_batchnorm_would_fail(runs, steps):
    """The batches are built so that a fault shows: each half normalized by
    its own statistics (one process on each half, gradients averaged, as
    per-rank BatchNorm would give) moves the first step's gradients by more
    than PER_RANK_FACTOR times GRAD_RTOL of the largest."""
    spec = runs["spec"]
    with _one_thread():
        halves = [torch_dist_worker.run_steps(spec, slice(r * 2, r * 2 + 2), parts=("pixel",))
                  ["pixel"]["grads"][0] for r in range(2)]
    want = steps["one"]["pixel"]["grads"][0]
    scale = max(float(g.abs().max()) for g in want.values())
    err = max(float(((halves[0][k] + halves[1][k]) / 2 - w).abs().max())
              for k, w in want.items()) / scale
    assert err > PER_RANK_FACTOR * GRAD_RTOL, err


# ------------------------------------------------------ without processes --

@pytest.mark.parametrize("nodes", [2, 3])
def test_node_stripes_match_jax(tmp_path, nodes):
    """Each node's stripe of 23 images, its length and its steps per epoch,
    and its batches (python backend) equal JAX's PatchLoader(process_index=,
    process_count=), sample for sample and byte for byte."""
    m = _manifest(tmp_path, 23, size=(40, 52))
    for node in range(nodes):
        jl = JaxPatchLoader(str(m), JaxLoaderConfig(batch_size=4, patch_size=16, scale=2,
                                                    workers=2, seed=5, backend="python"),
                            process_index=node, process_count=nodes)
        pl = PatchLoader(m, LoaderConfig(batch_size=4, patch_size=16, scale=2, workers=2,
                                         seed=5, backend="python"),
                         process_index=node, process_count=nodes)
        assert pl.samples == jl.samples and len(pl.samples) == 23 // nodes
        assert pl.full_samples == jl.full_samples and len(pl) == len(jl)
        jl.set_epoch(1)
        pl.set_epoch(1)
        for a, b in zip(pl, jl):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("backend", ["python", "native"])
def test_rank_rows_equal_the_one_process_batch(tmp_path, backend):
    """On each backend, the rows that the ranks of a node cut, concatenated
    in rank order, are the one-process loader's batch byte for byte (for
    one node of 2 and 4 ranks, and for a node of two nodes against that
    node's one-rank loader): a crop is keyed by (seed, epoch, batch,
    index), not by who cuts it."""
    m = _manifest(tmp_path, 11, size=(40, 52))
    cfg = LoaderConfig(batch_size=4, patch_size=16, scale=2, workers=2, seed=9,
                       backend=backend)
    for node, nodes in ((0, 1), (1, 2)):
        one = PatchLoader(m, cfg, process_index=node, process_count=nodes)
        assert one.backend == backend
        one.set_epoch(2)
        want = list(one)
        for lw in (2, 4):
            parts = []
            for r in range(lw):
                pl = PatchLoader(m, cfg, process_index=node, process_count=nodes,
                                 local_rank=r, local_world=lw)
                pl.set_epoch(2)
                assert len(pl) == len(one)
                parts.append(list(pl))
            for b, batch in enumerate(want):
                np.testing.assert_array_equal(np.concatenate([p[b] for p in parts]), batch)
    with pytest.raises(ValueError, match="does not divide"):
        PatchLoader(m, cfg, local_world=3)


def test_calculate_stats_uses_the_full_manifest(tmp_path):
    """A node's loader computes --mean over the whole manifest, not its
    stripe: every node gets the one-process numbers."""
    m = _manifest(tmp_path, 7, size=(20, 24))
    want = PatchLoader(m, LoaderConfig()).calculate_stats()
    pixels = np.concatenate([read_image_rgb(p).reshape(-1, 3)
                             for p in json.loads(m.read_text())]) / 255.0
    np.testing.assert_allclose(want[0], pixels.mean(0), rtol=0, atol=1e-12)
    for node in range(3):
        pl = PatchLoader(m, LoaderConfig(), process_index=node, process_count=3)
        assert len(pl.samples) == 2
        assert pl.calculate_stats() == want


def test_largest_divisible_device_count_matches_jax():
    for batch in range(1, 33):
        for n in range(1, 10):
            assert mesh.largest_divisible_device_count(batch, n) == \
                jax_largest_divisible_device_count(batch, n)


def test_distributed_init_in_one_process_and_too_many_ranks(monkeypatch):
    """Without WORLD_SIZE, or WORLD_SIZE=1 outside torchrun, nothing is
    joined: rank 0 of 1, no data group, and the shrink is a no-op. A node
    that runs more ranks than it has cards raises before it joins."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    got = mesh.distributed_init("cpu")
    assert (got.rank, got.world, got.node, got.nodes, got.local_rank, got.local_world) == \
        (0, 1, 0, 1, 0, 1)
    assert not got.initialized and mesh.data_group() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not mesh.distributed_init("cpu").initialized
    assert mesh.shrink_data_group(5) == 1 and mesh.broadcast_object("x") == "x"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one process per card"):
        mesh.distributed_init("cuda")
    assert not mesh.local_mesh().initialized


def test_several_nodes_need_a_batch_that_divides_by_their_ranks(monkeypatch):
    """On several nodes the data mesh spans every rank and cannot shrink:
    a per-node --batch_size that the ranks of a node do not divide exits
    with the JAX CLI's message (cli/train.py's multi-host check), and one
    that they divide keeps every rank."""
    monkeypatch.setattr(mesh, "_MESH", mesh.DataMesh(rank=3, world=4, local_rank=1,
                                                     local_world=2, size=4, initialized=True))
    with pytest.raises(SystemExit, match="multi-host: per-host --batch_size 3 must be "
                                         "divisible by the local device count 2"):
        mesh.shrink_data_group(3)
    assert mesh.shrink_data_group(4) == 4
    got = mesh.local_mesh()
    assert (got.node, got.nodes, got.ranks_per_node) == (1, 2, 2)


def test_global_batchnorm_in_one_rank_matches_native():
    """GlobalBatchNorm with no group (one rank's table) against
    torch.native_batch_norm: forward, statistics and every gradient within
    fp32 rounding (1e-5), in bf16 too; and gradcheck in float64."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((3, 5, 6, 4)).astype(np.float32) * 3 + 1)
        x = x.to(dtype).permute(0, 3, 1, 2).requires_grad_()
        w = torch.from_numpy(rng.uniform(0.5, 2, 4).astype(np.float32)).requires_grad_()
        b = torch.from_numpy(rng.standard_normal(4).astype(np.float32)).requires_grad_()
        dy = torch.from_numpy(rng.standard_normal((3, 4, 5, 6)).astype(np.float32)).to(dtype)
        outs = []
        for fn in (lambda: GlobalBatchNorm.apply(x, w, b),
                   lambda: torch.native_batch_norm(x, w, b, None, None, True, 0.0, 1e-5)):
            y, mean, invstd = fn()
            grads = torch.autograd.grad(y, (x, w, b), dy)
            outs.append((y, mean, invstd, *grads))
        for got, want in zip(*outs):
            assert got.dtype == want.dtype
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 4))).requires_grad_()
    w = torch.from_numpy(rng.uniform(0.5, 2, 3)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(3)).requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: GlobalBatchNorm.apply(*a)[0], (x, w, b))


def test_metrics_logger_disabled_writes_nothing(tmp_path):
    """enabled=False (every rank but 0) opens and writes no file."""
    log = MetricsLogger(tmp_path / "w", "run", use_tensorboard=False, enabled=False)
    log.scalar("loss", 1.0, 0)
    log.scalars({"a": 2.0}, 1)
    log.images("images/hr", np.zeros((1, 4, 4, 3), np.uint8), 0)
    log.close()
    assert not (tmp_path / "w").exists()
    on = MetricsLogger(tmp_path / "v", "run", use_tensorboard=False)
    on.scalar("loss", 1.0, 0)
    on.close()
    assert (tmp_path / "v" / "run_metrics.jsonl").read_text().count("\n") == 1


def test_denoise_seed_keeps_rank_zero_and_parts_the_others():
    """Rank 0 draws the one-process stream (seed + 2); every other rank its
    own, each different."""
    seeds = [denoise_seed(100, r) for r in range(4)]
    assert seeds[0] == 102 and len(set(seeds)) == 4
    assert seeds == [denoise_seed(100, r) for r in range(4)]
