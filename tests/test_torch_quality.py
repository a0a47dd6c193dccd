"""The port's quality experiments (``scripts/torch_flagship_quality_experiment.py``,
``scripts/torch_denoise_quality_experiment.py``, ``scripts/torch_denoise_severity_sweep.py``,
``scripts/torch_gan_vs_pixel_experiment.py``) against the JAX package's
scripts on the CPU, at a cut size: the synthetic data pixel for pixel, the
results' keys in the JAX script's order, the bicubic baseline against the
JAX eval CLI on the same artifact and val list, every gate key of the
denoise script, the pixel phase's top-up under ``--resume``, the sweep's
keys over one work dir and the GAN-vs-pixel arms scored by both eval CLIs.
The scores themselves are measured on the card (PERF.md)."""

import functools
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_super_resolution_tpu.cli import export as jax_export
from image_super_resolution_tpu.cli import train as jax_train
from image_super_resolution_tpu_torch.train import checkpoint as ckpt
from test_torch_eval import EVAL_ATOL, EXACT_KEYS
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

ROOT = Path(__file__).resolve().parent.parent
# the JAX recorded run of the denoise script with every optional gate arm
DENOISE_RESULTS = ROOT / "docs" / "results" / "denoise_fullres_synthetic_120.json"
# bicubic_* see no model: the eval tests' bound for the keys without one
BASELINE_ATOL = 2e-4
FLAGSHIP_CPU = ["--device", "cpu", "--arms", "F", "--fast_depth", "1", "--epochs", "1",
                "--n_train", "16"]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_fqe = _script("flagship_quality_experiment")
fqe = _script("torch_flagship_quality_experiment")
dqe = _script("torch_denoise_quality_experiment")
jax_sweep = _script("denoise_severity_sweep")
sweep = _script("torch_denoise_severity_sweep")
jax_gvp = _script("gan_vs_pixel_experiment")
gvp = _script("torch_gan_vs_pixel_experiment")


def _names(manifest: Path, root: Path):
    return [str(Path(p).relative_to(root)) for p in json.loads(manifest.read_text())]


def test_make_dataset_is_the_jax_scripts_pixel_for_pixel(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    fqe.make_dataset(port, n_train=4, n_val=2)
    jax_fqe.make_dataset(ref, n_train=4, n_val=2)
    for split, n in (("train", 4), ("val", 2)):
        for i in range(n):
            got = np.asarray(Image.open(port / split / f"img_{i}.png"))
            want = np.asarray(Image.open(ref / split / f"img_{i}.png"))
            assert got.shape == (192, 192, 3)
            np.testing.assert_array_equal(got, want)
    for m in ("train_images.json", "val_images.json"):
        assert _names(port / m, port) == _names(ref / m, ref), m


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """One CPU run of the port's flagship script: arm F at depth 1 (width
    128), one epoch on 16 images; its work dir and results."""
    ws = tmp_path_factory.mktemp("flagship") / "ws"
    return ws, fqe.run([*FLAGSHIP_CPU, "--workdir", str(ws)])


def test_flagship_keys_and_baseline_match_the_jax_script(flagship, tmp_path, monkeypatch):
    """The JAX script run with the same flags, its train and export replaced
    by the port's artifact and its eval the JAX eval CLI on it: the same
    keys in the same order at both levels, the bicubic baseline within
    BASELINE_ATOL, the model's keys within the eval tests' EVAL_ATOL (both
    CLIs score one artifact), and the results written as returned."""
    ws, got = flagship
    assert json.loads((ws / "results.json").read_text()) == got

    def export(argv):
        out = Path(argv[argv.index("--out") + 1])
        shutil.copy(ws / out.name, out)

    monkeypatch.setattr(jax_train, "main", lambda argv: None)
    monkeypatch.setattr(jax_export, "main", export)
    argv = [a for a in FLAGSHIP_CPU[2:]]
    want = jax_fqe.run([*argv, "--workdir", str(tmp_path / "jax")])
    assert list(got) == list(want) == ["F_fast_flagship", "F_fast_flagship_int8",
                                       "int8_ptq_psnr_y_cost"]
    for tag in ("F_fast_flagship", "F_fast_flagship_int8"):
        assert list(got[tag]) == list(want[tag]), tag
        assert got[tag]["n_images"] == want[tag]["n_images"] == 24
        for k in ("bicubic_psnr", "bicubic_psnr_y", "bicubic_hf_ratio"):
            assert abs(got[tag][k] - want[tag][k]) <= BASELINE_ATOL, (tag, k)
        for k, v in got[tag].items():
            if k in EXACT_KEYS:
                assert v == want[tag][k], (tag, k)
            else:
                assert abs(v - want[tag][k]) <= EVAL_ATOL.get(k, BASELINE_ATOL), \
                    (tag, k, v, want[tag][k])
    timings = json.loads((ws / "timings.json").read_text())["F_fast_flagship"]
    assert timings["train"]["epochs"] == 1
    assert timings["F_fast_flagship_int8"]["conv3x3_int8"] == 0  # plain versions on the CPU


def test_flagship_resume_tops_up_the_pixel_phase(flagship, tmp_path, capsys):
    """``--resume`` to a larger ``--epochs`` continues the epoch count from
    the finished run's final checkpoint (the pixel phase's ``matched``
    policy, as the JAX CLI resumes it): only epoch 1 trains, with a fresh
    optimizer, and the checkpoint then says epoch 1."""
    ws = tmp_path / "ws"
    shutil.copytree(flagship[0], ws)
    path = ws / "F_fast_flagship" / "res_f_1_0.2.ckpt"
    assert ckpt.load_checkpoint(path)["meta"]["epoch"] == 0
    capsys.readouterr()
    results = fqe.run([*FLAGSHIP_CPU[:-4], "--epochs", "2", "--n_train", "16", "--resume",
                       "--workdir", str(ws)])
    out = capsys.readouterr().out
    assert "Epoch [1]" in out and "Epoch [0]" not in out
    saved = ckpt.load_checkpoint(path)
    assert saved["meta"]["epoch"] == 1 and saved["meta"]["step"] == 1
    assert "opt_state" not in saved  # the new final epoch
    timings = json.loads((ws / "timings.json").read_text())["F_fast_flagship"]
    assert timings["train"]["epochs"] == 1
    assert np.isfinite(results["F_fast_flagship"]["psnr_y"])
    with pytest.raises(SystemExit, match="no existing workdir"):
        fqe.run([*FLAGSHIP_CPU, "--resume", "--workdir", str(tmp_path / "missing")])


@pytest.fixture(scope="module")
def denoise_smoke(tmp_path_factory):
    """One ``--smoke --device cpu`` run of the port's denoise script with
    the N and W arms: its work dir and results."""
    ws = tmp_path_factory.mktemp("denoise") / "dn"
    return ws, dqe.run(["--smoke", "--device", "cpu", "--refine_blocks", "1",
                        "--fullres_depth", "6", "--workdir", str(ws)])


def test_denoise_smoke_writes_every_gate_key(denoise_smoke):
    """``--smoke --device cpu`` with the N and W arms: results.json holds
    the JAX script's recorded keys in its order, each eval with the JAX
    eval CLI's keys, and every gate key; the values are finite."""
    ws, got = denoise_smoke
    assert json.loads((ws / "results.json").read_text()) == got
    want = json.loads(DENOISE_RESULTS.read_text())
    assert list(got) == list(want)
    assert list(got["gate"]) == list(want["gate"])
    for tag in want:
        if tag != "gate":
            assert list(got[tag]) == list(want[tag]), tag
            assert all(np.isfinite(v) for v in got[tag].values()), tag
    assert got["gate"]["noisy_input_psnr_y"] == got["R_reference_denoiser"]["noisy_psnr_y"]
    timings = json.loads((ws / "timings.json").read_text())
    assert list(timings) == [t for t in want if t != "gate" and not t.endswith("_int8")]


def test_severity_sweep_matches_the_jax_script(denoise_smoke, tmp_path):
    """Both sweeps over one work dir (the port's W artifact and val list)
    with the same flags: the same ``arm@severity[_int8]`` keys in the
    same order, each eval with the same keys; the counts equal and the
    HR-only key within BASELINE_ATOL. The noise streams differ (jax.random,
    torch.Generator), so the scores are held to their order: the light
    draw's noisy PSNR above the heavy one's in both."""
    ws = tmp_path / "dn"
    ws.mkdir()
    for f in ("W_fast_denoiser_fullres.isr", "val_images.json"):
        shutil.copy(denoise_smoke[0] / f, ws / f)
    flags = ["--workdir", str(ws), "--severities", "light,heavy", "--int8_arms", "W"]
    got = sweep.run([*flags, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    want = jax_sweep.run([*flags, "--out", str(tmp_path / "jax.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert list(got) == list(want)
    assert list(got) == ["W_fast_denoiser_fullres@light", "W_fast_denoiser_fullres@light_int8",
                         "W_fast_denoiser_fullres@heavy", "W_fast_denoiser_fullres@heavy_int8"]
    timings = json.loads((tmp_path / "port_timings.json").read_text())
    assert list(timings) == list(got)
    assert all(t["conv3x3_int8"] == t["scatter_rdb"] == 0 for t in timings.values())
    for key in got:
        assert list(got[key]) == list(want[key]), key
        for k in EXACT_KEYS:
            assert got[key][k] == want[key][k], (key, k)
        assert abs(got[key]["sharpness_hr"] - want[key]["sharpness_hr"]) <= BASELINE_ATOL
    for res in (got, want):
        arm = "W_fast_denoiser_fullres"
        assert res[f"{arm}@light"]["noisy_psnr"] > res[f"{arm}@heavy"]["noisy_psnr"]


def test_gan_vs_pixel_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's GAN-vs-pixel protocol on the CPU (depth 1, one epoch per
    phase, 16 training images), then the JAX script with its train CLI
    replaced by the port run's checkpoints and metrics: the same data pixel
    for pixel, the same keys in the same order, each arm's metrics within
    EVAL_ATOL (each package exports and scores the same checkpoint), the
    content-loss summary equal; C resumes A's epoch count, so with ``--e2``
    1 it trains no epoch, in both packages."""
    for mod in (gvp, jax_gvp):
        monkeypatch.setattr(mod, "make_dataset",
                            functools.partial(mod.make_dataset, n_train=16, n_val=2))
    flags = ["--e1", "1", "--e2", "1", "--depth", "1"]
    ws = tmp_path / "port"
    got = gvp.run([*flags, "--device", "cpu", "--workdir", str(ws)])
    assert json.loads((ws / "results.json").read_text()) == got
    timings = json.loads((ws / "timings.json").read_text())
    assert [t["train"]["epochs"] for t in timings.values()] == [1, 1, 0]

    def train(argv):  # the port run's files where the JAX CLI writes them
        wd = Path(argv[argv.index("--work_dir") + 1])
        src = ws / wd.relative_to(tmp_path / "jax")
        for f in ("res_x_1_0.2.ckpt", "gen_x_1_0.2.ckpt", "x_metrics.jsonl"):
            if (src / f).exists():
                shutil.copy(src / f, wd / f)

    monkeypatch.setattr(jax_train, "main", train)
    want = jax_gvp.run([*flags, "--workdir", str(tmp_path / "jax")])
    for split, n in (("train", 16), ("val", 2)):
        for i in range(n):
            png = f"{split}/img_{i}.png"
            np.testing.assert_array_equal(np.asarray(Image.open(ws / png)),
                                          np.asarray(Image.open(tmp_path / "jax" / png)))
    assert list(got) == list(want) == ["A_pixel_pretrain", "B_gan_random_vgg",
                                       "C_pixel_control", "content_loss"]
    assert got["content_loss"] == want["content_loss"]
    for arm in list(got)[:3]:
        assert list(got[arm]) == list(want[arm]), arm
        for k, v in got[arm].items():
            if k in EXACT_KEYS:
                assert v == want[arm][k], (arm, k)
            else:
                assert abs(v - want[arm][k]) <= EVAL_ATOL.get(k, BASELINE_ATOL), \
                    (arm, k, v, want[arm][k])
