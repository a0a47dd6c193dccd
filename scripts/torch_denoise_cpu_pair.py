#!/usr/bin/env python
"""One arm of the denoise quality protocol trained by both packages on the
CPU, at a cut size, and scored by one eval CLI: whether the port trains to
what the JAX package trains to when the two run on the same machine.

    JAX_PLATFORMS=cpu python scripts/torch_denoise_cpu_pair.py \
        [--depth 2] [--width 32] [--downshuffle 1] [--epochs 30] [--seeds 100 101]

On the quality experiments' data (``make_dataset``: 240 training images,
15 steps an epoch at batch 16, patch 96), each seed trains the fast
denoiser (``--train_denoise --family fast``, default: the W arm's
full-resolution trunk cut to depth 2, width 32) through the JAX package's
train CLI and through the port's (``--device cpu``), exports each with its
own export CLI and scores both ``.isr`` files with the JAX package's eval
CLI under ``--denoise_eval`` (one noise draw for all). Weights, crops and
training noise come from each package's own generators, so the two match
in distribution only: the seeds give the spread. Prints one line per
package and seed and the mean per package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--width", type=int, default=32)
    parser.add_argument("--downshuffle", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--seeds", type=int, nargs="+", default=[100, 101])
    opt = parser.parse_args(argv)

    from image_super_resolution_tpu.cli import evaluate as jax_evaluate
    from image_super_resolution_tpu.cli import export as jax_export
    from image_super_resolution_tpu.cli import train as jax_train
    from image_super_resolution_tpu_torch.cli import export, train
    from image_super_resolution_tpu_torch.train.checkpoint import checkpoint_name
    from torch_flagship_quality_experiment import make_dataset

    packages = {"jax": (jax_train.main, jax_export.main, []),
                "port": (train.main, export.main, ["--device", "cpu"])}
    ckpt = checkpoint_name("denoise", "w", opt.depth, 0.2)
    scores = {name: [] for name in packages}
    with tempfile.TemporaryDirectory() as tmp:
        ws = Path(tmp)
        make_dataset(ws)
        for seed in opt.seeds:
            for name, (tr, ex, device) in packages.items():
                wd = ws / f"{name}_{seed}"
                with contextlib.redirect_stdout(io.StringIO()):
                    tr(["--train_denoise", "--family", "fast", "--downshuffle",
                        str(opt.downshuffle), "--rs_deep", str(opt.depth), "--width",
                        str(opt.width), "--shape", "96", "--batch_size", "16", "--epochs",
                        str(opt.epochs), "--ckpt_every", "25", "--seed", str(seed),
                        "--train_json", str(ws / "train_images.json"), "--no_tensorboard",
                        "--worker", "4", "--save_name", "w", "--work_dir", str(wd), *device])
                    ex(["--checkpoint", str(wd / ckpt), "--out", str(wd / "w.isr"),
                        "--family", "denoise_fast", *device])
                    res = jax_evaluate.main(["--model", str(wd / "w.isr"), "--denoise_eval",
                                             "--val_json", str(ws / "val_images.json"),
                                             "--shape", "192", "--batch_size", "2"])
                scores[name].append(res["psnr_y"])
                print(f"{name} seed {seed}: psnr_y {res['psnr_y']} (noisy "
                      f"{res['noisy_psnr_y']})", flush=True)
    for name, v in scores.items():
        print(f"{name}: mean psnr_y {np.mean(v):.4f} over seeds {opt.seeds}")
    return scores


if __name__ == "__main__":
    main()
