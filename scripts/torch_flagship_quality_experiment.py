#!/usr/bin/env python
"""Quality gate of the flagship family, trained and scored by the PyTorch
port (counterpart of ``scripts/flagship_quality_experiment.py``).

Both architectures are trained through the port's CLIs on the synthetic
convergence benchmark at an equal step budget with the same data and seed,
exported to ``.isr`` and scored by the port's eval CLI (PSNR-Y, SSIM and
the texture metrics; bicubic as the baseline). Gate: fast PSNR-Y >=
reference-topology PSNR-Y.

Protocol (x4, the headline scale):
  R. reference topology (ResNet, depth 16, width 64) pixel phase E epochs
  F. fast flagship     (depth 14, width 128)        pixel phase E epochs
  eval both on the held-out synthetic val split; also report bicubic.

The flags, arms, checkpoint names and ``results.json`` keys are those of the
JAX script, so the two packages' results compare key by key; ``--device``
(default ``cuda``) is passed to the port's ``train``, ``export`` and
``evaluate``. Besides ``results.json`` the work dir gets ``timings.json``:
per arm the wall seconds of each CLI call, the mean ms per training step
(from the train CLI's patches/s, the first epoch left out when there are
more) and each eval's launches of the two hand-written kernels (K1
``scatter_rdb``, K2 ``conv3x3_int8``; 0 on the CPU, where their plain
versions run).

    python scripts/torch_flagship_quality_experiment.py --workdir runs/x4
    python scripts/torch_flagship_quality_experiment.py --scale 2 --workdir runs/x2
    python scripts/torch_flagship_quality_experiment.py --device cpu --arms F \
        --fast_depth 1 --epochs 1 --n_train 16 --workdir runs/cpu  # on the CPU
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_dataset(root: Path, n_train: int = 240, n_val: int = 24,
                 size: int = 192, shape: int = 96):
    """Sharp-edge synthetic images (rectangles, thin lines, gradients) —
    high-frequency content with real structure for x4 SR to recover. The
    JAX script's generator, draw for draw (numpy PCG64, seed 7; Pillow
    PNGs), so both packages train and score on the same pixels; the
    manifests are written by the port's ``create_json``."""
    from PIL import Image

    rng = np.random.default_rng(7)
    for split, n in (("train", n_train), ("val", n_val)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = np.full((size, size, 3), rng.integers(0, 255, 3), np.uint8)
            for _ in range(16):
                x0, y0 = rng.integers(0, size - 8, 2)
                w, h = rng.integers(4, size // 2, 2)
                img[y0: y0 + h, x0: x0 + w] = rng.integers(0, 255, 3)
            for _ in range(8):  # thin lines
                y = int(rng.integers(0, size))
                img[y: y + 2, :, :] = rng.integers(0, 255, 3)
            gx = np.linspace(0, rng.integers(30, 90), size, dtype=np.float32)
            img = np.clip(img.astype(np.float32) + gx[None, :, None], 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"img_{i}.png")
    from image_super_resolution_tpu_torch.cli.create_json import main as cj

    cj(["--train_dirs", str(root / "train"), "--val_dirs", str(root / "val"),
        "--shape", str(shape), "--output", str(root)])


def make_photo_dataset(root: Path, size: int = 192, shape: int = 96,
                       n_train: int = 240):
    """Real-photograph benchmark from matplotlib's bundled grace_hopper.jpg
    (512x600 RGB portrait), as the JAX script cuts it: val crops only from
    the top 192-px band (identity and mirror), train crops only from rows
    >= 192, 8-fold dihedral-augmented, shuffled with seed 7 and cut to
    ``n_train``, so train and val share no pixel."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("photo dataset source missing: matplotlib (its "
                         "sample_data/grace_hopper.jpg) is not installed") from None
    from PIL import Image

    src = Path(matplotlib.get_data_path()) / "sample_data" / "grace_hopper.jpg"
    if not src.exists():
        raise SystemExit(f"photo dataset source missing: {src}")
    img = np.asarray(Image.open(src).convert("RGB"))
    h, w = img.shape[:2]
    if h < 2 * size or w < size:
        raise SystemExit(f"photo dataset source too small: {(h, w)}")

    def dihedral(a: np.ndarray, k: int) -> np.ndarray:
        a = np.rot90(a, k % 4)
        return a[:, ::-1] if k >= 4 else a

    stride = 32
    val_dir, train_dir = root / "val", root / "train"
    val_dir.mkdir(parents=True, exist_ok=True)
    train_dir.mkdir(parents=True, exist_ok=True)
    n_val = 0
    for x0 in range(0, w - size + 1, stride):  # top band only
        for k in (0, 4):  # identity + mirror: 22 val crops
            crop = dihedral(img[:size, x0: x0 + size], k)
            Image.fromarray(np.ascontiguousarray(crop)).save(
                val_dir / f"val_{n_val}.png")
            n_val += 1
    ys = list(range(size, h - size + 1, stride))
    if ys[-1] != h - size:
        ys.append(h - size)  # cover the bottom edge
    crops = [(y0, x0, k)
             for y0 in ys
             for x0 in range(0, w - size + 1, stride)
             for k in range(8)]
    rng = np.random.default_rng(7)
    rng.shuffle(crops)
    for i, (y0, x0, k) in enumerate(crops[:n_train]):
        crop = dihedral(img[y0: y0 + size, x0: x0 + size], k)
        Image.fromarray(np.ascontiguousarray(crop)).save(
            train_dir / f"img_{i}.png")
    from image_super_resolution_tpu_torch.cli.create_json import main as cj

    cj(["--train_dirs", str(train_dir), "--val_dirs", str(val_dir),
        "--shape", str(shape), "--output", str(root)])


def _launches() -> dict:
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    return {"scatter_rdb": scatter_rdb.launches, "conv3x3_int8": conv3x3_int8.launches}


def timed_train(tr, argv, batch_size: int) -> dict:
    """``tr(argv)`` (the port's train CLI): wall seconds, epochs run and
    the mean ms per step from each epoch's patches/s (the first epoch, which
    builds cuDNN's plans, left out when there are more; None when no epoch
    had the two steps the CLI's timer needs)."""
    t0 = time.perf_counter()
    history = tr(argv)
    wall = time.perf_counter() - t0
    ms = [1e3 * batch_size / h["patches_per_sec"] for h in history if len(h["losses"]) > 1]
    steady = ms[1:] if len(ms) > 1 else ms
    return {"wall_s": round(wall, 3), "epochs": len(history),
            "ms_per_step": round(float(np.mean(steady)), 3) if steady else None}


def counted_eval(ev, argv) -> tuple:
    """``ev(argv)`` (the port's eval CLI): its result, and its wall seconds
    and kernel launches (counted as differences, so counts kept by a caller
    run on)."""
    before, t0 = _launches(), time.perf_counter()
    result = ev(argv)
    wall, after = time.perf_counter() - t0, _launches()
    return result, {"wall_s": round(wall, 3),
                    **{k: after[k] - before[k] for k in after}}


def run(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=str, required=True,
                        help="the run's directory: emptied first unless "
                             "--resume")
    parser.add_argument("--dataset", choices=("synthetic", "photo"),
                        default="synthetic",
                        help="'photo' trains/evals on spatially-disjoint "
                             "crops of matplotlib's one bundled photograph "
                             "(make_photo_dataset) instead of the synthetic "
                             "sharp-edge generator")
    parser.add_argument("--epochs", type=int, default=120,
                        help="equal pixel-phase budget for both arms "
                             "(240 imgs / batch 16 = 15 steps per epoch)")
    parser.add_argument("--gan_epochs", type=int, default=0,
                        help="optionally follow each arm's pixel phase with "
                             "an equal-budget GAN fine-tune (random-VGG "
                             "perceptual loss) and ALSO eval that checkpoint "
                             "(tag *_gan); the pixel-phase gate numbers are "
                             "always recorded")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--fast_depth", type=int, default=14,
                        help="fast-arm trunk depth (14 = the x4 flagship preset)")
    parser.add_argument("--n_train", type=int, default=240,
                        help="synthetic training-corpus size (240 = the "
                             "standard gate); steps/epoch scales with it")
    parser.add_argument("--arms", type=str, default="R,F",
                        help="comma-set of arms to run (R = reference "
                             "topology, F = fast flagship); the gate dict "
                             "needs both")
    parser.add_argument("--resume", action="store_true",
                        help="extend an existing workdir to a LARGER "
                             "--epochs budget instead of starting over: "
                             "keeps the dataset, resumes every arm's "
                             "checkpoint (the CLI's --resume: the pixel phase "
                             "tops up, only the missing epochs train, with a "
                             "fresh optimizer past a finished run's final "
                             "checkpoint), and re-runs export+eval")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the port's train, export and evaluate "
                             "(cuda, or cpu)")
    opt = parser.parse_args(argv)

    from image_super_resolution_tpu_torch.cli.evaluate import main as ev
    from image_super_resolution_tpu_torch.cli.export import main as ex
    from image_super_resolution_tpu_torch.cli.train import main as tr

    ws = Path(opt.workdir)
    if opt.resume:
        if not ws.exists():
            raise SystemExit(f"--resume: no existing workdir at {ws}")
    else:
        if ws.exists():
            shutil.rmtree(ws)
        ws.mkdir(parents=True)
        if opt.dataset == "photo":
            make_photo_dataset(ws)
        else:
            make_dataset(ws, n_train=opt.n_train)
    device = ["--device", opt.device]
    common = ["--resnet", "--scale", str(opt.scale), "--shape", "96",
              "--batch_size", "16", "--epochs", str(opt.epochs),
              "--ckpt_every", "25", "--seed", "100",
              "--train_json", str(ws / "train_images.json"),
              "--no_tensorboard", "--worker", "4", *device]
    if opt.resume:
        common.append("--resume")

    arms = {
        "R_reference_topology": {
            "train": ["--save_name", "r", *common],
            "ckpt": "res_r_16_0.2.ckpt",
            "gan_ckpt": "gen_r_16_0.2.ckpt",
            "export": ["--family", "sr"],
        },
        "F_fast_flagship": {
            "train": ["--family", "fast", "--rs_deep", str(opt.fast_depth),
                      "--save_name", "f", *common],
            "ckpt": f"res_f_{opt.fast_depth}_0.2.ckpt",
            "gan_ckpt": f"gen_f_{opt.fast_depth}_0.2.ckpt",
            "export": ["--family", "fast"],
        },
    }

    want = {a.strip().upper() for a in opt.arms.split(",") if a.strip()}
    arms = {tag: arm for tag, arm in arms.items() if tag[0] in want}
    if not arms:
        raise SystemExit(f"--arms {opt.arms!r} selects no arm (use R,F)")

    results, timings = {}, {}
    for tag, arm in arms.items():
        wd = ws / tag
        wd.mkdir(exist_ok=opt.resume)
        t_arm = time.perf_counter()
        timings[tag] = {"train": timed_train(tr, ["--work_dir", str(wd), *arm["train"]], 16)}

        def export_and_eval(ckpt_name, eval_tag):
            art = ws / f"{eval_tag}.isr"
            ex(["--checkpoint", str(wd / ckpt_name), "--out", str(art),
                "--scale", str(opt.scale), *arm["export"], *device])
            print(f"--- eval {eval_tag} ---")
            ev_args = ["--model", str(art),
                       "--val_json", str(ws / "val_images.json"),
                       "--shape", "192", "--batch_size", "2", *device]
            results[eval_tag], timings[tag][eval_tag] = counted_eval(ev, ev_args)
            if "fast" in arm["export"]:
                # the quality half of the int8 decision: what does PTQ cost
                # on a TRAINED flagship, same protocol?
                print(f"--- eval {eval_tag} (int8 PTQ) ---")
                results[eval_tag + "_int8"], timings[tag][eval_tag + "_int8"] = \
                    counted_eval(ev, [*ev_args, "--int8"])

        export_and_eval(arm["ckpt"], tag)  # the pixel-phase gate, always
        if opt.gan_epochs:
            # same flags minus --resnet, same warm-start path the CLI uses
            gan_flags = [a for a in arm["train"] if a != "--resnet"]
            gan_flags[gan_flags.index("--epochs") + 1] = str(opt.gan_epochs)
            timings[tag]["gan_train"] = timed_train(
                tr, ["--work_dir", str(wd), *gan_flags], 16)
            export_and_eval(arm["gan_ckpt"], tag + "_gan")
        timings[tag]["wall_s"] = round(time.perf_counter() - t_arm, 3)
        print(f"[arm] {tag} {json.dumps(timings[tag])}", flush=True)

    if "F_fast_flagship" in results:
        f = results["F_fast_flagship"]
        results["int8_ptq_psnr_y_cost"] = round(
            f["psnr_y"] - results["F_fast_flagship_int8"]["psnr_y"], 3)
    if "R_reference_topology" in results and "F_fast_flagship" in results:
        r = results["R_reference_topology"]
        results["gate"] = {
            "psnr_y_delta_fast_minus_ref": round(f["psnr_y"] - r["psnr_y"], 3),
            "passed": bool(f["psnr_y"] >= r["psnr_y"]),
            "int8_ptq_psnr_y_cost": results["int8_ptq_psnr_y_cost"],
        }
    print(json.dumps(results, indent=2))
    (ws / "results.json").write_text(json.dumps(results, indent=2))
    (ws / "timings.json").write_text(json.dumps(timings, indent=2))
    return results


if __name__ == "__main__":
    run()
