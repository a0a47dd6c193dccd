#!/usr/bin/env python
"""The random-VGG GAN phase against pixel-only training, trained and scored
by the PyTorch port (counterpart of ``scripts/gan_vs_pixel_experiment.py``).

Without ImageNet VGG19 weights the GAN phase runs on RMS-calibrated random
VGG features (``losses/perceptual.py``); this measures what that does to
output quality on sharp-edge synthetic images at x2, through the port's
CLIs:

  A. pixel pretrain E1 epochs                        -> eval
  B. A + GAN phase (random-VGG perceptual) E2 epochs -> eval
  C. A + pixel-only for E2 more epochs (control)     -> eval

The data (the JAX script's generator, pixel for pixel), flags, checkpoint
names and ``results.json`` keys are the JAX script's. C keeps its caveat:
``--resume`` on A's final checkpoint restores the params but not the
optimizer, as B's warm start does; the pixel phase's resume also continues
A's epoch count, so C trains only the epochs from E1 up to E2 (none at the
defaults, E1 80 > E2 50), in both packages. ``--device`` (default ``cuda``)
goes to the port's ``train``, ``export`` and ``evaluate``; the work dir also
gets ``timings.json`` (wall per CLI call, ms per step, kernel launches per
eval), as the quality experiments write it.

    python scripts/torch_gan_vs_pixel_experiment.py --workdir runs/gvp
    python scripts/torch_gan_vs_pixel_experiment.py --device cpu --e1 1 --e2 1 \
        --depth 1 --workdir runs/gvp_cpu
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_flagship_quality_experiment import counted_eval, timed_train  # noqa: E402


def make_dataset(root: Path, n_train: int = 240, n_val: int = 8, size: int = 128):
    """Sharp-edge synthetic images: rectangles, lines and gradients (the
    JAX script's generator and seed), and their manifests."""
    from PIL import Image

    rng = np.random.default_rng(7)
    for split, n in (("train", n_train), ("val", n_val)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = np.full((size, size, 3), rng.integers(0, 255, 3), np.uint8)
            for _ in range(12):
                x0, y0 = rng.integers(0, size - 8, 2)
                w, h = rng.integers(4, size // 2, 2)
                img[y0 : y0 + h, x0 : x0 + w] = rng.integers(0, 255, 3)
            for _ in range(6):  # thin lines
                y = int(rng.integers(0, size))
                img[y : y + 2, :, :] = rng.integers(0, 255, 3)
            gx = np.linspace(0, rng.integers(30, 90), size, dtype=np.float32)
            img = np.clip(img.astype(np.float32) + gx[None, :, None], 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(d / f"img_{i}.png")
    from image_super_resolution_tpu_torch.cli.create_json import main as cj

    cj(["--train_dirs", str(root / "train"), "--val_dirs", str(root / "val"),
        "--shape", "48", "--output", str(root)])


def run(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=str, required=True,
                        help="directory of this run's data, checkpoints and "
                             "results; emptied first")
    parser.add_argument("--e1", type=int, default=80, help="pixel pretrain epochs")
    parser.add_argument("--e2", type=int, default=50, help="extra phase epochs")
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the port's train, export and evaluate "
                             "(cuda, or cpu)")
    opt = parser.parse_args(argv)

    from image_super_resolution_tpu_torch.cli.evaluate import main as ev
    from image_super_resolution_tpu_torch.cli.export import main as ex
    from image_super_resolution_tpu_torch.cli.train import main as tr

    ws = Path(opt.workdir)
    if ws.exists():
        shutil.rmtree(ws)
    ws.mkdir(parents=True)
    make_dataset(ws)
    device = ["--device", opt.device]
    batch_size = 16
    common = ["--scale", "2", "--rs_deep", str(opt.depth), "--shape", "48",
              "--batch_size", str(batch_size), "--save_name", "x", "--ckpt_every", "25",
              "--train_json", str(ws / "train_images.json"),
              "--no_tensorboard", "--worker", "4", *device]
    timings = {}

    def train(tag: str, argv) -> None:
        timings[tag] = {"train": timed_train(tr, argv, batch_size)}

    def evaluate(ckpt: str, tag: str, arm: str) -> dict:
        art = ws / f"{tag}.isr"
        ex(["--checkpoint", str(ws / ckpt), "--out", str(art),
            "--rs_deep", str(opt.depth), "--scale", "2", *device])
        print(f"--- eval {tag} ---")
        result, timings[arm][tag] = counted_eval(
            ev, ["--model", str(art), "--val_json", str(ws / "val_images.json"),
                 "--shape", "96", "--batch_size", "2", *device])
        return result

    results = {}
    # A: pixel pretrain.
    train("A_pixel_pretrain", ["--resnet", "--epochs", str(opt.e1), "--work_dir", str(ws),
                               *common])
    results["A_pixel_pretrain"] = evaluate(f"res_x_{opt.depth}_0.2.ckpt", "a",
                                           "A_pixel_pretrain")

    # B: GAN phase on top (warm-starts from the res ckpt automatically).
    gan_dir = ws / "gan"
    gan_dir.mkdir()
    shutil.copy(ws / f"res_x_{opt.depth}_0.2.ckpt", gan_dir)
    train("B_gan_random_vgg", ["--epochs", str(opt.e2), "--work_dir", str(gan_dir), *common])
    results["B_gan_random_vgg"] = evaluate(f"gan/gen_x_{opt.depth}_0.2.ckpt", "b",
                                           "B_gan_random_vgg")

    # C: pixel-only control from the same warm start (the caveat above).
    ctl_dir = ws / "control"
    ctl_dir.mkdir()
    shutil.copy(ws / f"res_x_{opt.depth}_0.2.ckpt", ctl_dir)
    train("C_pixel_control", ["--resnet", "--resume", "--epochs", str(opt.e2),
                              "--work_dir", str(ctl_dir), *common])
    results["C_pixel_control"] = evaluate(f"control/res_x_{opt.depth}_0.2.ckpt", "c",
                                          "C_pixel_control")

    # Content-loss magnitude with the calibrated random-VGG features.
    contents = []
    jsonl = gan_dir / "x_metrics.jsonl"
    if jsonl.exists():
        for line in jsonl.read_text().splitlines():
            rec = json.loads(line)
            if rec["tag"] == "loss/content":
                contents.append(rec["value"])
    if contents:
        results["content_loss"] = {
            "first": round(contents[0], 5),
            "last": round(contents[-1], 5),
            "mean": round(float(np.mean(contents)), 5),
        }

    print(json.dumps(results, indent=2))
    (ws / "results.json").write_text(json.dumps(results, indent=2))
    (ws / "timings.json").write_text(json.dumps(timings, indent=2))
    return results


if __name__ == "__main__":
    run()
