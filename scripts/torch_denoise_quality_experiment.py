#!/usr/bin/env python
"""Quality gate of the denoiser families, trained and scored by the PyTorch
port (counterpart of ``scripts/denoise_quality_experiment.py``).

The flagship experiment's protocol applied to the denoise phase: the
reference denoiser topology (depth 16, width 64) and the fast denoiser
(width-128 trunk at 1/2 resolution, family ``denoise_fast``) are trained
through the port's CLIs at an equal epoch budget on the same synthetic data
and seed, then scored by the port's eval CLI under ``--denoise_eval`` (the
training degradation chain: gauss + ISO noise + JPEG, a fixed seed). Gate:
fast PSNR-Y >= reference PSNR-Y; the int8 PTQ cost of every fast arm is
measured on the same protocol.

Optional arms, as in the JAX script: ``--extra_downshuffle 4`` (X, outside
the gate), ``--refine_blocks 2 [--refine_width 64]`` (N, the full-res
refinement tail; carries the gate when trained) and ``--fullres_depth 6``
(W, the fast trunk at full resolution at FLOP parity with the reference
topology; carries the gate when trained). ``--device`` (default ``cuda``)
is passed to the port's ``train``, ``export`` and ``evaluate``, and
``--seed`` (default 100, the JAX script's) to ``train``; the work dir
gets ``results.json`` with the JAX script's keys and ``timings.json`` as the
flagship script writes it.

    python scripts/torch_denoise_quality_experiment.py --workdir runs/dn \
        --refine_blocks 2 --refine_width 64 --fullres_depth 6
    python scripts/torch_denoise_quality_experiment.py --smoke --device cpu \
        --workdir runs/dn_smoke
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_flagship_quality_experiment import (  # noqa: E402  (same data)
    counted_eval,
    make_dataset,
    make_photo_dataset,
    timed_train,
)


def run(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=str, required=True,
                        help="the run's directory: emptied first unless "
                             "--resume")
    parser.add_argument("--dataset", choices=("synthetic", "photo"),
                        default="synthetic",
                        help="'photo' trains/evals on spatially-disjoint "
                             "crops of matplotlib's one bundled photograph "
                             "(torch_flagship_quality_experiment."
                             "make_photo_dataset)")
    parser.add_argument("--epochs", type=int, default=120,
                        help="equal denoise-phase budget for both arms "
                             "(240 imgs / batch 16 = 15 steps per epoch)")
    parser.add_argument("--downshuffle", type=int, default=2,
                        help="fast arm's sub-pixel front factor")
    parser.add_argument("--extra_downshuffle", type=int, default=0,
                        help="optionally train a THIRD arm at this more "
                             "aggressive factor (e.g. 4 = quarter-res trunk) "
                             "to map the speed/quality curve; it does not "
                             "participate in the gate")
    parser.add_argument("--refine_blocks", type=int, default=0,
                        help="optionally train an N arm: the fast denoiser "
                             "with a full-res refinement tail. When set, the "
                             "family gate is judged on this arm.")
    parser.add_argument("--refine_width", type=int, default=64)
    parser.add_argument("--fullres_depth", type=int, default=0,
                        help="optionally train a W arm: the fast family's "
                             "width-128 trunk at FULL resolution "
                             "(--downshuffle 1) with this many blocks; 6 is "
                             "FLOP parity with the reference denoiser "
                             "topology. When set, THIS arm carries the gate.")
    parser.add_argument("--smoke", action="store_true",
                        help="mechanics check: 1 epoch, tiny nets, tiny "
                             "dataset (the gate numbers are meaningless in "
                             "this mode)")
    parser.add_argument("--resume", action="store_true",
                        help="extend an existing workdir with a FURTHER "
                             "--epochs of training per arm. Denoise-phase "
                             "resume: a finished run's final checkpoint has "
                             "no optimizer state, so each arm WARM-RESTARTS "
                             "its schedule from epoch 0 — totals are prior + "
                             "--epochs, equal across arms. (The pixel-phase "
                             "flagship experiment tops up instead.)")
    parser.add_argument("--seed", type=int, default=100,
                        help="every arm's training seed (weights, crops, noise); "
                             "100 is the JAX script's, others measure the spread "
                             "of a reading over training runs")
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
        if opt.smoke:
            make_dataset(ws, n_train=8, n_val=2)
        elif opt.dataset == "photo":
            make_photo_dataset(ws)
        else:
            make_dataset(ws)
    if opt.smoke:
        opt.epochs = 1
    device = ["--device", opt.device]
    batch_size = 2 if opt.smoke else 16
    common = ["--train_denoise", "--shape", "96",
              "--batch_size", str(batch_size),
              "--epochs", str(opt.epochs), "--ckpt_every", "25",
              "--seed", str(opt.seed), "--train_json", str(ws / "train_images.json"),
              "--no_tensorboard", "--worker", "4", *device]
    if opt.resume:
        common.append("--resume")
    ref_dims = ["--rs_deep", "2"] if opt.smoke else []
    fast_dims = ["--rs_deep", "1", "--width", "8"] if opt.smoke else []
    ref_ckpt = "denoise_r_2_0.2.ckpt" if opt.smoke else "denoise_r_16_0.2.ckpt"
    fast_ckpt = "denoise_f_1_0.2.ckpt" if opt.smoke else "denoise_f_14_0.2.ckpt"

    arms = {
        "R_reference_denoiser": {
            "train": ["--save_name", "r", *ref_dims, *common],
            "ckpt": ref_ckpt,
            "export": ["--family", "denoise"],
        },
        "F_fast_denoiser": {
            "train": ["--family", "fast",
                      "--downshuffle", str(opt.downshuffle),
                      "--save_name", "f", *fast_dims, *common],
            "ckpt": fast_ckpt,
            "export": ["--family", "denoise_fast"],
        },
    }
    if opt.extra_downshuffle:
        arms[f"X_fast_denoiser_ds{opt.extra_downshuffle}"] = {
            "train": ["--family", "fast",
                      "--downshuffle", str(opt.extra_downshuffle),
                      "--save_name", "x", *fast_dims, *common],
            "ckpt": fast_ckpt.replace("_f_", "_x_"),
            "export": ["--family", "denoise_fast"],
        }
    if opt.fullres_depth:
        w_depth = 1 if opt.smoke else opt.fullres_depth
        arms["W_fast_denoiser_fullres"] = {
            "train": ["--family", "fast", "--downshuffle", "1",
                      "--rs_deep", str(w_depth),
                      *(["--width", "8"] if opt.smoke else []),
                      "--save_name", "w", *common],
            "ckpt": f"denoise_w_{w_depth}_0.2.ckpt",
            "export": ["--family", "denoise_fast"],
        }
    if opt.refine_blocks:
        arms["N_fast_denoiser_refine"] = {
            "train": ["--family", "fast",
                      "--downshuffle", str(opt.downshuffle),
                      "--refine_blocks", str(opt.refine_blocks),
                      "--refine_width", str(opt.refine_width),
                      "--save_name", "n", *fast_dims, *common],
            "ckpt": fast_ckpt.replace("_f_", "_n_"),
            "export": ["--family", "denoise_fast"],
        }

    results, timings = {}, {}
    for tag, arm in arms.items():
        wd = ws / tag
        wd.mkdir(exist_ok=opt.resume)
        t_arm = time.perf_counter()
        timings[tag] = {"train": timed_train(
            tr, ["--work_dir", str(wd), *arm["train"]], batch_size)}
        art = ws / f"{tag}.isr"
        ex(["--checkpoint", str(wd / arm["ckpt"]), "--out", str(art),
            *arm["export"], *device])
        print(f"--- eval {tag} ---")
        ev_args = ["--model", str(art), "--denoise_eval",
                   "--val_json", str(ws / "val_images.json"),
                   "--shape", "192", "--batch_size", "2", *device]
        results[tag], timings[tag][tag] = counted_eval(ev, ev_args)
        if "denoise_fast" in arm["export"]:
            print(f"--- eval {tag} (int8 PTQ) ---")
            results[tag + "_int8"], timings[tag][tag + "_int8"] = \
                counted_eval(ev, [*ev_args, "--int8"])
        timings[tag]["wall_s"] = round(time.perf_counter() - t_arm, 3)
        print(f"[arm] {tag} {json.dumps(timings[tag])}", flush=True)

    r = results["R_reference_denoiser"]
    f = results["F_fast_denoiser"]
    results["gate"] = {
        "psnr_y_delta_fast_minus_ref": round(f["psnr_y"] - r["psnr_y"], 3),
        "passed": bool(f["psnr_y"] >= r["psnr_y"]),
        "int8_ptq_psnr_y_cost": round(
            f["psnr_y"] - results["F_fast_denoiser_int8"]["psnr_y"], 3
        ),
        "noisy_input_psnr_y": r["noisy_psnr_y"],
    }
    if opt.refine_blocks:
        # The refine arm is the family's answer to the plain arm's failure:
        # when trained, IT carries the gate.
        n = results["N_fast_denoiser_refine"]
        results["gate"].update({
            "psnr_y_delta_refine_minus_ref": round(
                n["psnr_y"] - r["psnr_y"], 3),
            "passed": bool(n["psnr_y"] >= r["psnr_y"]),
            "refine_int8_ptq_psnr_y_cost": round(
                n["psnr_y"]
                - results["N_fast_denoiser_refine_int8"]["psnr_y"], 3),
        })
    if opt.fullres_depth:
        # The full-res W arm is the family's x1 fidelity answer (full width
        # at full resolution, FLOP parity with the reference topology): when
        # trained, IT carries the gate.
        wm = results["W_fast_denoiser_fullres"]
        results["gate"].update({
            "psnr_y_delta_fullres_minus_ref": round(
                wm["psnr_y"] - r["psnr_y"], 3),
            "passed": bool(wm["psnr_y"] >= r["psnr_y"]),
            "fullres_int8_ptq_psnr_y_cost": round(
                wm["psnr_y"]
                - results["W_fast_denoiser_fullres_int8"]["psnr_y"], 3),
        })
    print(json.dumps(results, indent=2))
    (ws / "results.json").write_text(json.dumps(results, indent=2))
    (ws / "timings.json").write_text(json.dumps(timings, indent=2))
    return results


if __name__ == "__main__":
    run()
