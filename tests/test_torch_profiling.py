"""Profiling and the run's image dump, the port against the JAX package on
the CPU: ``trace``, ``rs --profile_dir`` (an image, and a video with the
pipeline's stages named), ``train --profile_dir`` (steps 2-4) and the
first 10 hr/lr batches logged as images."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_super_resolution_tpu.data.degrade import downscale as jax_downscale
from image_super_resolution_tpu_torch.cli import rs
from image_super_resolution_tpu_torch.cli import train as cli_train
from image_super_resolution_tpu_torch.models.deploy import (
    DeploySpec,
    init_fused_params,
    save_artifact,
)
from image_super_resolution_tpu_torch.utils import profiling
from image_super_resolution_tpu_torch.utils.logging import MetricsLogger
from image_super_resolution_tpu_torch.utils.png import write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)


def _traces(logdir):
    return sorted(logdir.glob("*.pt.trace.json"))


def test_trace_writes_a_file_with_the_annotated_region(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.trace(logdir):
        with profiling.annotate("isr_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = _traces(logdir)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "isr_region" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


def test_rs_profile_dir(tmp_path):
    """rs --profile_dir on one PNG: the output as without the flag, and a
    trace of the run (the model's convs in it)."""
    spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
    isr = tmp_path / "m.isr"
    save_artifact(isr, spec, init_fused_params(spec, 0))
    src = tmp_path / "a.png"
    write_png(src, np.random.default_rng(0).integers(0, 256, (30, 22, 3), dtype=np.uint8))
    common = ["--model", str(isr), "--src", str(src), "--device", "cpu", "--window_size", "16",
              "--overlap", "4"]
    out = rs.main(common + ["--save_dir", str(tmp_path / "p.png"), "--profile_dir",
                            str(tmp_path / "prof")])
    ref = rs.main(common + ["--save_dir", str(tmp_path / "r.png")])
    np.testing.assert_array_equal(rs._read_image_rgb(out), rs._read_image_rgb(ref))
    (path,) = _traces(tmp_path / "prof")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any("conv" in n for n in names)


def test_rs_profile_dir_on_a_video_names_the_pipeline_stages(tmp_path):
    """rs --profile_dir on a 10-frame clip: the trace holds the pipeline's
    upscale and write regions, one per batch (3 at batch 4; the last write
    after the loop)."""
    cv2 = pytest.importorskip("cv2")
    spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
    isr = tmp_path / "m.isr"
    save_artifact(isr, spec, init_fused_params(spec, 0))
    clip = tmp_path / "in.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    rng = np.random.default_rng(2)
    for _ in range(10):
        writer.write(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    writer.release()
    out = rs.main(["--model", str(isr), "--src", str(clip), "--device", "cpu",
                   "--batch_size", "4", "--save_dir", str(tmp_path / "out.mp4"),
                   "--profile_dir", str(tmp_path / "prof")])
    assert out.is_file()
    (path,) = _traces(tmp_path / "prof")
    names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    assert [names.count(f"video/{s}") for s in ("upscale", "write")] == [3, 3]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """24 small PNGs: 12 steps per epoch at batch 2."""
    tmp = tmp_path_factory.mktemp("prof_train")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(24):
        p = tmp / f"{i}.png"
        write_png(p, rng.integers(0, 256, (20, 18, 3), dtype=np.uint8))
        paths.append(str(p))
    m = tmp / "m.json"
    m.write_text(json.dumps(paths))
    return m


def _train(tmp_path, manifest, *flags):
    return cli_train.main(["--train_json", str(manifest), "--work_dir", str(tmp_path / "w"),
                           "--batch_size", "2", "--shape", "16", "--device", "cpu",
                           "--no_tensorboard", "--rs_deep", "1", "--width", "8",
                           "--epochs", "1", *flags])


def _record_profiled_steps(monkeypatch):
    """Which steps ran with the profiler open, in order."""
    seen = []
    step = cli_train.Run.step

    def recording(self, batch):
        seen.append(self.profiler is not None)
        return step(self, batch)

    monkeypatch.setattr(cli_train.Run, "step", recording)
    return seen


def test_train_profile_dir_traces_steps_2_to_4(tmp_path, manifest, monkeypatch, capsys):
    seen = _record_profiled_steps(monkeypatch)
    _train(tmp_path, manifest, "--resnet", "--profile_dir", str(tmp_path / "prof"))
    assert seen == [False, False, True, True, True] + [False] * 7
    assert len(_traces(tmp_path / "prof")) == 1
    assert "profiler trace written to" in capsys.readouterr().out


def test_train_profile_dir_closes_a_short_run(tmp_path, manifest, monkeypatch):
    """Three steps in all: the trace opens at step 2 and closes when the
    run ends."""
    seen = _record_profiled_steps(monkeypatch)
    short = manifest.parent / "short.json"
    short.write_text(json.dumps(json.loads(manifest.read_text())[:6]))
    _train(tmp_path, short, "--train_denoise", "--profile_dir", str(tmp_path / "prof"))
    assert seen == [False, False, True]
    assert len(_traces(tmp_path / "prof")) == 1


def _record_images(monkeypatch):
    calls = []
    monkeypatch.setattr(MetricsLogger, "images",
                        lambda self, tag, batch, step: calls.append((tag, np.array(batch), step)))
    return calls


@pytest.mark.parametrize("flags,scale", [(["--resnet"], 2), (["--resnet", "--scale", "4",
                                                              "--family", "fast"], 4)])
def test_train_logs_the_first_10_hr_lr_batches(tmp_path, manifest, monkeypatch, flags, scale):
    """MetricsLogger.images 10 times per tag, steps 0-9; each LR batch the
    JAX CLI's: its downscale of the HR batch, truncated to uint8."""
    calls = _record_images(monkeypatch)
    _train(tmp_path, manifest, *flags)
    for tag in ("images/hr", "images/lr"):
        assert [s for t, _, s in calls if t == tag] == list(range(10))
    hrs = [b for t, b, _ in calls if t == "images/hr"]
    lrs = [b for t, b, _ in calls if t == "images/lr"]
    for hr, lr in zip(hrs, lrs):
        assert hr.shape == (2, 16, 16, 3) and hr.dtype == np.uint8
        want = np.asarray(jnp.clip(jax_downscale(jnp.asarray(hr, jnp.float32) / 255.0, scale)
                                   * 255.0, 0, 255)).astype(np.uint8)
        assert lr.dtype == np.uint8
        np.testing.assert_array_equal(lr, want)


@pytest.mark.parametrize("flags", [["--train_denoise"], ["--resnet", "--resume"]])
def test_train_logs_no_images_when_denoising_or_resuming(tmp_path, manifest, monkeypatch, flags):
    calls = _record_images(monkeypatch)
    _train(tmp_path, manifest, *flags)
    assert calls == []


def test_metrics_logger_scalars_flush_and_disabled(tmp_path):
    """scalars writes one JSONL line per key, readable after flush; with
    TensorBoard disabled, images is a no-op."""
    log = MetricsLogger(tmp_path / "on", "run", use_tensorboard=False)
    log.scalars({"loss": torch.tensor(0.5), "psnr": 20.0}, 3)
    log.flush()
    lines = [json.loads(x) for x in (tmp_path / "on" / "run_metrics.jsonl").read_text()
             .splitlines()]
    assert [(x["tag"], x["value"], x["step"]) for x in lines] == [("loss", 0.5, 3),
                                                                   ("psnr", 20.0, 3)]
    log.images("images/hr", np.zeros((1, 4, 4, 3), np.uint8), 0)  # no TensorBoard: no-op
    log.close()
