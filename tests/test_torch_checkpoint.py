"""Checkpoints and the training CLI of the port against the JAX package on
the CPU: files written by each package resumed by the other with the
optimizer, the per-phase epoch policies, saving over an Orbax directory,
``cli/train --device cpu`` (phases, options, resume, the substitution
count, refusals) and its GAN phase (warm start, eval, resume with the
discriminator across the packages). Tiny generators (depth 1-2, width 8)
in fp32; tolerances are stated where they are used."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from image_super_resolution_tpu.models import Discriminator as JaxDiscriminator
from image_super_resolution_tpu.models import SRGenerator as JaxSRGenerator
from image_super_resolution_tpu.train import checkpoint as jax_ckpt
from image_super_resolution_tpu.train.state import build_optimizer, create_train_state
from image_super_resolution_tpu.train.steps import (
    make_pixel_train_step as jax_make_pixel_train_step,
)
from image_super_resolution_tpu_torch.cli import train as cli_train
from image_super_resolution_tpu_torch.interop.from_jax import variables_to_jax
from image_super_resolution_tpu_torch.models.generator import SRGenerator
from image_super_resolution_tpu_torch.ops.initializers import init_weights
from image_super_resolution_tpu_torch.train import checkpoint as ckpt
from image_super_resolution_tpu_torch.train.state import TrainState
from image_super_resolution_tpu_torch.train.steps import make_pixel_train_step
from image_super_resolution_tpu_torch.utils.png import write_png

# As in tests/test_torch_train.py: one fp32 step from the same checkpoint,
# losses within 1e-6 relative (a first step's loss is one forward of the
# same params: within 1.2e-7 to 3.1e-7 by scripts/torch_train_fp64_gap.py);
# params and EMA within 2e-6, but for at most
# 0.1% of a tensor whose gradient is rounding noise (Adam turns it into up
# to lr), within 2 lr; BN statistics within 2e-5.
LR, TOTAL = 1e-3, 30
LOSS_RTOL, STEP_ATOL, STATS_ATOL, NOISY_SHARE = 1e-6, 2e-6, 2e-5, 1e-3


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
            assert (diff > atol).mean() <= noisy_share, f"{what} {k}"
        bound = 2 * LR if noisy_share else atol
        assert diff.max(initial=0) <= bound, f"{what} {k}: {diff.max()} > {bound}"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_state(model, weight_decay=0.0):
    tx = build_optimizer(lr=LR, total_steps=TOTAL, weight_decay=weight_decay)
    return create_train_state(model, (1, 16, 16, 3), tx, jax.random.PRNGKey(0),
                              ema_tau=TOTAL)


def _assert_states_close(state, jstate):
    params, stats = variables_to_jax(state.model.state_dict())
    e_params, e_stats = variables_to_jax(state.ema.state_dict())
    _assert_trees_close(params, jstate.params, STEP_ATOL, "params", NOISY_SHARE)
    _assert_trees_close(stats, jstate.batch_stats, STATS_ATOL, "batch_stats")
    _assert_trees_close(e_params, jstate.ema.params, STEP_ATOL, "ema params", NOISY_SHARE)
    _assert_trees_close(e_stats, jstate.ema.batch_stats, STATS_ATOL, "ema batch_stats")
    assert state.step == int(jstate.step) and state.ema.updates == int(jstate.ema.updates)


# ---------------------------------------------------------- checkpoints --

def _jax_pixel_run(tmp_path, final=False):
    """A JAX state after one pixel step, saved as epoch 0."""
    jm = JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32)
    jstate = _jax_state(jm)
    jstate, _ = jax_make_pixel_train_step(2)(jstate, jnp.asarray(_u8((2, 16, 16, 3), 0)))
    path = tmp_path / "jax.ckpt"
    jax_ckpt.save_checkpoint(path, jstate, 0, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2), [0.3],
                             final=final)
    return jstate, path


def _fp16(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float16).astype(np.float32),
                                  _np(tree))


def test_port_resumes_a_jax_checkpoint_with_its_optimizer(tmp_path):
    """The port reads the JAX package's file: every leaf matches, Adam's
    moments and count come back (fp32, exactly), the epoch continues, and
    the next step agrees with the JAX step from the same checkpoint."""
    jstate, path = _jax_pixel_run(tmp_path)
    state = TrainState(SRGenerator(depth=1, width=8, scale=2, fused=False, device="cpu"),
                       lr=1e-3, total_steps=TOTAL, ema_tau=TOTAL)
    _, start = ckpt.resume_state(state, ckpt.load_checkpoint(path), epoch_policy="opt")
    assert start == 1 and state.step == 1 and state.ema.updates == 1
    mu = state.optimizer.state[state.model.tail.conv.weight]["exp_avg"]
    want_mu = np.asarray(jstate.opt_state[1][0].mu["tail"]["conv"]["kernel"])
    np.testing.assert_array_equal(mu.permute(2, 3, 1, 0).numpy(), want_mu)
    params, _ = variables_to_jax(state.model.state_dict())
    _assert_trees_close(params, _fp16(jstate.params), 0, "params (fp16 in the file)")

    jloaded = jax_ckpt.load_checkpoint(path)
    jresumed, jstart = jax_ckpt.resume_state(_jax_state(JaxSRGenerator(
        depth=1, width=8, scale=2, dtype=jnp.float32)), jloaded, epoch_policy="opt")
    assert jstart == 1
    u8 = _u8((2, 16, 16, 3), 5)
    jresumed, metrics = jax_make_pixel_train_step(2)(jresumed, jnp.asarray(u8))
    loss = make_pixel_train_step(2)(state, torch.from_numpy(u8))
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=LOSS_RTOL)
    _assert_states_close(state, jresumed)


def test_jax_resumes_a_port_checkpoint_with_its_optimizer(tmp_path):
    """The JAX package reads the port's file: all leaves match, the optax
    chain is restored (moments equal to Adam's), the epoch continues, and
    params/EMA/statistics are the port's, stored in fp16."""
    model = init_weights(SRGenerator(depth=1, width=8, scale=2, fused=False,
                                     device="cpu"), 3)
    state = TrainState(model, lr=1e-3, total_steps=TOTAL, ema_tau=TOTAL, weight_decay=0.01)
    make_pixel_train_step(2)(state, torch.from_numpy(_u8((2, 16, 16, 3), 1)))
    path = tmp_path / "port.ckpt"
    ckpt.save_checkpoint(path, state, 4, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2), [0.25])

    loaded = jax_ckpt.load_checkpoint(path)
    assert loaded["meta"]["epoch"] == 4 and loaded["meta"]["step"] == 1
    jstate = _jax_state(JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32),
                        weight_decay=0.01)
    jstate, start = jax_ckpt.resume_state(jstate, loaded, epoch_policy="opt")
    assert start == 5 and int(jstate.step) == 1 and int(jstate.ema.updates) == 1
    adam = jstate.opt_state[2][0]
    assert int(adam.count) == 1 and int(jstate.opt_state[2][1].count) == 1
    nu = state.optimizer.state[model.head.conv.weight]["exp_avg_sq"]
    np.testing.assert_array_equal(np.asarray(adam.nu["head"]["conv"]["kernel"]),
                                  nu.permute(2, 3, 1, 0).numpy())
    params, stats = variables_to_jax(model.state_dict())
    e_params, _ = variables_to_jax(state.ema.state_dict())
    _assert_trees_close(_fp16(params), jstate.params, 0, "params")
    _assert_trees_close(_fp16(stats), jstate.batch_stats, 0, "batch_stats")
    _assert_trees_close(_fp16(e_params), jstate.ema.params, 0, "ema")


@pytest.mark.parametrize("policy,want", [("opt", 0), ("matched", 3), ("always", 3)])
def test_final_checkpoint_epoch_policies_match_jax(policy, want, tmp_path):
    """The final epoch's checkpoint has no optimizer: both packages continue
    its epoch counter by the same per-phase rule."""
    model = init_weights(SRGenerator(depth=1, width=8, fused=False, device="cpu"), 0)
    state = TrainState(model, total_steps=TOTAL)
    path = tmp_path / "final.ckpt"
    ckpt.save_checkpoint(path, state, 2, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2), final=True)
    loaded = ckpt.load_checkpoint(path)
    assert "opt_state" not in loaded
    fresh = TrainState(SRGenerator(depth=1, width=8, fused=False, device="cpu"))
    assert ckpt.resume_state(fresh, loaded, epoch_policy=policy)[1] == want
    jstate = _jax_state(JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32))
    assert jax_ckpt.resume_state(jstate, jax_ckpt.load_checkpoint(path),
                                 epoch_policy=policy)[1] == want


def test_incompatible_optimizer_resumes_weights_only(tmp_path):
    """A chain without the L2 entry, resumed with --weight_decay: weights
    only, epoch 0, as the JAX package does."""
    _, path = _jax_pixel_run(tmp_path)
    state = TrainState(SRGenerator(depth=1, width=8, fused=False, device="cpu"),
                       weight_decay=0.1)
    _, start = ckpt.resume_state(state, ckpt.load_checkpoint(path), epoch_policy="opt")
    assert start == 0 and state.step == 0 and not state.optimizer.state


def test_checkpoint_name_matches_jax():
    for phase in ("pixel", "gan", "denoise"):
        assert ckpt.checkpoint_name(phase, "x", 16, 0.2) == \
            jax_ckpt.checkpoint_name(phase, "x", 16, 0.2)


# ------------------------------------------------------------------ CLI --

def _manifest(tmp_path, n=2, size=(40, 36)):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = tmp_path / f"img{i}.png"
        write_png(p, rng.integers(0, 256, (*size, 3), dtype=np.uint8))
        paths.append(str(p))
    m = tmp_path / "train.json"
    m.write_text(json.dumps(paths))
    return m


def _cli(tmp_path, manifest, *flags):
    return cli_train.main(["--train_json", str(manifest), "--work_dir", str(tmp_path / "w"),
                           "--batch_size", "2", "--shape", "16", "--device", "cpu",
                           "--no_tensorboard", "--rs_deep", "1", "--width", "8", *flags])


def test_cli_trains_on_cpu_then_resumes(tmp_path, capsys):
    """cli/train --device cpu on two tiny PNGs for one epoch, then --resume
    with more epochs: the final checkpoint has no optimizer, and the pixel
    phase's rule continues its epoch counter anyway (epochs 1 and 2) with
    a fresh Adam and step count (the last save is at step 2); it prints the JAX CLI's epoch line with the
    substitution count. test_cli_resume_restores_the_optimizer covers a
    checkpoint that carries Adam."""
    m = _manifest(tmp_path)
    first = _cli(tmp_path, m, "--resnet", "--epochs", "1")
    assert [h["epoch"] for h in first] == [0] and first[0]["substituted"] == 0
    path = tmp_path / "w" / "res_checkpoint_1_0.2.ckpt"
    saved = ckpt.load_checkpoint(path)
    assert "opt_state" not in saved  # epoch 0 was the final one
    out = capsys.readouterr().out
    assert "Epoch [0] mean loss" in out and "0 substituted patches" in out
    lines = [json.loads(l) for l in (tmp_path / "w" / "checkpoint_metrics.jsonl").open()]
    assert [(r["tag"], r["step"]) for r in lines] == [("loss", 1),
                                                     ("throughput/patches_per_sec", 1)]
    assert lines[0]["value"] == pytest.approx(first[0]["losses"][0])
    second = _cli(tmp_path, m, "--resnet", "--epochs", "3", "--resume")
    assert [h["epoch"] for h in second] == [1, 2]
    assert "Loaded pre-trained 54/54 model" in capsys.readouterr().out
    assert ckpt.load_checkpoint(path)["meta"]["step"] == 2


def test_cli_resume_restores_the_optimizer(tmp_path):
    """A mid-run checkpoint (not final) carries Adam: --resume continues the
    epoch and the step count (1 -> 2) of the denoise phase."""
    m = _manifest(tmp_path)
    run = cli_train.Run(cli_train.build_parser().parse_args([
        "--train_json", str(m), "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
        "--shape", "16", "--device", "cpu", "--no_tensorboard", "--rs_deep", "2",
        "--train_denoise", "--epochs", "2"]))
    run.step(torch.from_numpy(next(iter(run.loader))))
    ckpt.save_checkpoint(run.ckpt_path, run.state, 0, run.mean, run.std, [0.1])
    history = _cli(tmp_path, m, "--train_denoise", "--epochs", "2", "--resume",
                   "--rs_deep", "2")
    assert [h["epoch"] for h in history] == [1] and np.isfinite(history[0]["mean_loss"])
    saved = ckpt.load_checkpoint(run.ckpt_path)
    assert saved["meta"]["step"] == 2 and saved["ema_updates"] == 2


@pytest.mark.parametrize("flags,model,loss", [
    (["--resnet", "--enchant"], "SRGenerator", "l1_loss"),
    (["--resnet", "--L1_loss", "--mean", "--remat"], "SRGenerator", "l1_loss"),
    (["--resnet", "--family", "fast", "--scale", "4", "--refine_blocks", "1"],
     "FastSRGenerator", "mse_loss"),
    (["--train_denoise", "--family", "fast", "--downshuffle", "2", "--remat"],
     "FastSRGenerator", "mse_loss"),
    (["--preset", "denoise_fullres", "--rs_deep", "1"], "FastSRGenerator", "mse_loss"),
])
def test_cli_phases_and_options_train(flags, model, loss, tmp_path):
    """Each phase and option of the JAX CLI that this slice ports trains one
    finite epoch on the CPU: --enchant (EResNet, L1, no BN), --L1_loss with
    --mean (dataset statistics) and --remat, the fast family with its
    refinement tail, the fast denoiser, and the denoise_fullres preset."""
    m = _manifest(tmp_path)
    opt = cli_train.build_parser().parse_args([
        "--train_json", str(m), "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
        "--shape", "16", "--device", "cpu", "--no_tensorboard", "--rs_deep", "1",
        "--width", "8", "--epochs", "1", *flags])
    run = cli_train.Run(opt)
    assert type(run.state.model).__name__ == model
    assert run.step_fn.loss_fn.__name__ == loss
    if "--mean" in flags:
        assert run.mean != [0.485, 0.456, 0.406]
    if "--enchant" in flags:
        assert not any("bn" in k for k, _ in run.state.model.named_parameters())
    history = run.train()
    assert np.isfinite(history[0]["mean_loss"]) and run.ckpt_path.exists()


def test_cli_counts_substituted_patches(tmp_path, capsys):
    """A file no decoder reads becomes a black patch, as in the JAX
    package, and is counted on the epoch line."""
    m = _manifest(tmp_path, n=3)
    paths = json.loads(m.read_text())
    (tmp_path / "bad.png").write_bytes(b"not an image")
    m.write_text(json.dumps(paths + [str(tmp_path / "bad.png")]))
    history = _cli(tmp_path, m, "--resnet", "--epochs", "1")
    assert history[0]["substituted"] == 1
    assert "1 substituted patches" in capsys.readouterr().out


@pytest.mark.parametrize("flags,slice_name", [
    (["--ckpt_backend", "orbax"], "slice 5"),
    (["--loader_backend", "native"], "slice 5"),
    (["--resnet", "--ckpt_backend", "orbax"], "slice 5"),
    (["--resnet", "--profile_dir", "prof"], "slice 5"),
    (["--resnet", "--loader_backend", "native"], "slice 5"),
])
def test_cli_refuses_what_is_not_ported(flags, slice_name, tmp_path):
    with pytest.raises(SystemExit, match=slice_name):
        _cli(tmp_path, tmp_path / "missing.json", *flags)


def test_cli_refuses_more_than_one_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(SystemExit, match="slice 5"):
        cli_train.main(["--resnet", "--train_json", str(tmp_path / "m.json")])


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _manifest(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--resnet", "--train_json", str(m), "--work_dir", str(tmp_path)])


def test_cli_preset_and_checks_match_jax():
    opt = cli_train.build_parser().parse_args(["--preset", "denoise_fullres"])
    cli_train.check_options(opt)
    assert (opt.train_denoise, opt.family, opt.downshuffle, opt.rs_deep, opt.width) == \
        (True, "fast", 1, 6, 128)
    for flags in (["--resnet", "--family", "fast", "--enchant"],
                  ["--resnet", "--downshuffle", "2"],
                  ["--resnet", "--refine_blocks", "1"]):
        with pytest.raises(SystemExit):
            cli_train.check_options(cli_train.build_parser().parse_args(flags))


# ------------------------------------------------- Orbax directory swap --

@pytest.mark.parametrize("at_path,stale_old", [("directory", False), ("directory", True),
                                                ("file", True)])
def test_save_over_an_orbax_directory(at_path, stale_old, tmp_path, monkeypatch):
    """A JAX --ckpt_backend orbax run leaves a checkpoint DIRECTORY at the
    name the port saves to; a crash inside an Orbax save can leave one at
    <name>.old. The save succeeds over both, as the JAX save does: the
    directory is moved to <name>.old before the new file is renamed in (so
    the disk holds a checkpoint at every moment), then removed, and a stale
    .old directory is removed."""
    path, old = tmp_path / "gen_x_1_0.2.ckpt", tmp_path / "gen_x_1_0.2.ckpt.old"
    if at_path == "directory":
        (path / "state").mkdir(parents=True)
        (path / "state" / "x").write_bytes(b"orbax")
    else:
        path.write_bytes(b"an older checkpoint")
    if stale_old:
        (old / "stale").mkdir(parents=True)
    seen = []
    replace = ckpt.os.replace

    def watched(src, dst):
        if Path(dst) == path:
            seen.append((path.exists(), old.is_dir()))
        replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", watched)
    state = TrainState(init_weights(SRGenerator(depth=1, width=8, fused=False,
                                                device="cpu"), 0))
    ckpt.save_checkpoint(path, state, 0, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2), [0.1])
    assert path.is_file() and not old.exists()
    # during the rename the Orbax directory waits at .old: never no checkpoint
    assert seen == [(False, True)] if at_path == "directory" else [(True, True)]
    assert ckpt.load_checkpoint(path)["meta"]["epoch"] == 0
    assert jax_ckpt.load_checkpoint(path)["meta"]["epoch"] == 0


# -------------------------------------------------------------- GAN phase --

def test_cli_gan_phase_warm_starts_evaluates_and_resumes(tmp_path, capsys):
    """The GAN phase on the CPU: without a pixel checkpoint it says so and
    starts fresh; after a pixel run it warm-starts G from that run's EMA
    (the matched-leaves line), trains D, VGG on random features, logs
    loss/content, loss/adv and loss/dis per step and eval/psnr, psnr_y,
    ssim after each epoch (--eval_every 1), saves D (with its Adam but on
    the final epoch), and --resume continues both optimizers by the "always"
    rule."""
    m = _manifest(tmp_path)
    with pytest.raises(SystemExit):  # --eval_every without a phase flag still parses
        cli_train.build_parser().parse_args(["--eval_every"])
    _cli(tmp_path, m, "--epochs", "1", "--save_name", "fresh")
    assert "Could not load pretrain checkpoint." in capsys.readouterr().out
    _cli(tmp_path, m, "--resnet", "--epochs", "1")
    pixel = ckpt.load_checkpoint(tmp_path / "w" / "res_checkpoint_1_0.2.ckpt")
    run = cli_train.Run(cli_train.build_parser().parse_args([
        "--train_json", str(m), "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
        "--shape", "16", "--device", "cpu", "--no_tensorboard", "--rs_deep", "1",
        "--width", "8", "--epochs", "2", "--eval_every", "1", "--eval_json", str(m)]))
    assert run.resume() == 0
    assert "loaded pre-trained generator (54/54 leaves)" in capsys.readouterr().out
    params, _ = variables_to_jax(run.state.model.state_dict())
    _assert_trees_close(params, pixel["ema_params"], 0, "warm-started G")
    assert run.state.ema.updates == 0
    history = run.train()
    assert [h["epoch"] for h in history] == [0, 1]
    for h in history:
        assert sorted(h["metrics"]) == ["loss/adv", "loss/content", "loss/dis"]
        assert h["losses"] == h["metrics"]["loss/content"]
        assert sorted(h["eval"]) == ["psnr", "psnr_y", "ssim"]
        assert all(np.isfinite(v) for v in h["eval"].values())
    tags = {json.loads(line)["tag"] for line in
            (tmp_path / "w" / "checkpoint_metrics.jsonl").open()}
    assert {"loss/content", "loss/adv", "loss/dis", "eval/psnr", "eval/psnr_y",
            "eval/ssim"} <= tags
    path = tmp_path / "w" / "gen_checkpoint_1_0.2.ckpt"
    final = ckpt.load_checkpoint(path)
    assert {"d_params", "d_batch_stats"} <= set(final) and "d_opt_state" not in final
    assert final["meta"]["epoch"] == 1 and final["meta"]["step"] == 2
    resumed = _cli(tmp_path, m, "--epochs", "3", "--resume")
    assert [h["epoch"] for h in resumed] == [2]


def _jax_gan_states(d_channels=64, fc_size=1024):
    tx = build_optimizer(lr=LR, total_steps=TOTAL)
    jg = create_train_state(JaxSRGenerator(depth=1, width=8, scale=2, dtype=jnp.float32),
                            (1, 16, 16, 3), tx, jax.random.PRNGKey(0), ema_tau=TOTAL)
    jd = create_train_state(JaxDiscriminator(3, d_channels, 8, fc_size, dtype=jnp.float32),
                            (1, 16, 16, 3), tx, jax.random.PRNGKey(1), with_ema=False)
    return jg, jd


def test_port_resumes_a_jax_gan_checkpoint_with_the_discriminator(tmp_path):
    """A GAN checkpoint written as the JAX CLI writes it (D's fp32 params
    and statistics, its optax state dict with set moments, d_step 3):
    --resume restores G, D's params, D's Adam moments (fc kernels
    transposed) and D's step, and the run continues at the next epoch."""
    m = _manifest(tmp_path)
    jg, jd = _jax_gan_states()
    rng = np.random.default_rng(0)
    d_opt = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32) if np.ndim(a) else a,
        _np(serialization.to_state_dict(jd.opt_state)))
    d_opt["1"]["0"]["count"] = d_opt["1"]["1"]["count"] = np.asarray(3, np.int32)
    d_stats = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), _np(jd.batch_stats))
    path = tmp_path / "w" / "gen_checkpoint_1_0.2.ckpt"
    jax_ckpt.save_checkpoint(path, jg, 0, (0.4, 0.5, 0.6), (0.2, 0.2, 0.2), [0.3],
                             extra={"d_params": _np(jd.params), "d_batch_stats": d_stats,
                                    "d_opt_state": d_opt, "d_step": 3})
    run = cli_train.Run(cli_train.build_parser().parse_args([
        "--train_json", str(m), "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
        "--shape", "16", "--device", "cpu", "--no_tensorboard", "--rs_deep", "1",
        "--width", "8", "--epochs", "2", "--resume"]))
    assert run.resume() == 1
    assert len(run.state.optimizer.state) == len(run.state.params)  # G's Adam too
    d = run.d_state
    assert d.step == 3
    params, stats = variables_to_jax(d.model.state_dict())
    _assert_trees_close(params, jd.params, 0, "D params")
    _assert_trees_close(stats, d_stats, 0, "D batch_stats")
    adam = d.optimizer.state[d.model.fc1.dense.weight]
    np.testing.assert_array_equal(adam["exp_avg"].T.numpy(),
                                  d_opt["1"]["0"]["mu"]["fc1"]["dense"]["kernel"])
    np.testing.assert_array_equal(
        d.optimizer.state[d.model.block3.conv.weight]["exp_avg_sq"].permute(2, 3, 1, 0).numpy(),
        d_opt["1"]["0"]["nu"]["block3"]["conv"]["kernel"])
    assert float(adam["step"]) == 3
    assert [h["epoch"] for h in run.train()] == [1] and d.step == 4  # one step per epoch


def test_jax_resumes_a_port_gan_checkpoint_with_the_discriminator(tmp_path):
    """The JAX CLI's GAN resume on the port's file: resume_state by the
    "always" rule for G, then D's params, statistics and optax chain
    (flax from_state_dict, as cli/train.py does) equal to the port's, and
    d_step."""
    m = _manifest(tmp_path)
    run = cli_train.Run(cli_train.build_parser().parse_args([
        "--train_json", str(m), "--work_dir", str(tmp_path / "w"), "--batch_size", "2",
        "--shape", "16", "--device", "cpu", "--no_tensorboard", "--rs_deep", "1",
        "--width", "8", "--epochs", "2"]))
    run.step(torch.from_numpy(next(iter(run.loader))))
    run.save(0, [0.5], final=False)
    loaded = jax_ckpt.load_checkpoint(run.ckpt_path)
    jg, jd = _jax_gan_states()
    jg, start = jax_ckpt.resume_state(jg, loaded, epoch_policy="always")
    assert start == 1 and int(jg.step) == 1
    d_opt = serialization.from_state_dict(jd.opt_state, loaded["d_opt_state"])
    assert int(loaded["d_step"]) == 1 and int(d_opt[1][0].count) == 1
    d = run.d_state
    np.testing.assert_array_equal(
        np.asarray(d_opt[1][0].mu["fc1"]["dense"]["kernel"]),
        d.optimizer.state[d.model.fc1.dense.weight]["exp_avg"].T.numpy())
    np.testing.assert_array_equal(
        np.asarray(d_opt[1][0].nu["block5"]["bn"]["scale"]),
        d.optimizer.state[d.model.block5.bn.weight]["exp_avg_sq"].numpy())
    params, stats = variables_to_jax(d.model.state_dict())
    _assert_trees_close(params, loaded["d_params"], 0, "D params")
    _assert_trees_close(stats, loaded["d_batch_stats"], 0, "D batch_stats")
    assert jax.tree_util.tree_structure(loaded["d_params"]) == \
        jax.tree_util.tree_structure(_np(jd.params))
