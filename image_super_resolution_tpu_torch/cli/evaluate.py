"""Evaluation CLI: PSNR / PSNR-Y / SSIM and the texture metrics of a
deployed artifact over a validation manifest (counterpart of the JAX
package's ``cli/evaluate.py``, with the same flags, JSON keys and rounding,
plus ``--device``, default ``cuda``).

    python -m image_super_resolution_tpu_torch.cli.evaluate --model a.isr --val_json m.json

Crops come from ``PatchLoader`` with seed 0 on its default backend
(``auto``: the C++ loader where it builds), as in the JAX CLI, so on any
host both CLIs score the same crops. The LR side is the training pipeline's degradation on the device:
``downscale`` for an SR artifact, the denoise chain at ``--severity`` for
``--denoise_eval``, the clean input for any other x1 artifact. The
denoise noise of batch ``i`` is drawn from a ``torch.Generator`` seeded
with ``i``; the JAX CLI draws it from ``fold_in(PRNGKey(0), i)``, a
different stream, so the two CLIs' denoise metrics match in distribution
only. The baseline is the bicubic upsample of the LR (SR) or the noisy
input itself (``noisy_*``, denoise). ``--int8`` calibrates the fast
families' int8 trunk on the first batch's LR and feeds that batch back
into the loop. Each batch's metrics stay on the device until the end,
when they are fetched at once. ``--data_devices N`` splits every batch's
LR over N devices, one replica of the artifact on each (on ``cuda`` the
distinct local cards, 0 = all of them; on ``cpu`` the CPU stands for N),
gathers the outputs on the first device and scores them there, so the
metrics equal the single-device run's.
"""

from __future__ import annotations

import argparse
import itertools
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate PSNR/SSIM of an artifact")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--val_json", type=str, default="./val_images.json")
    parser.add_argument("--shape", type=int, default=192, help="HR eval crop")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_images", type=int, default=256)
    parser.add_argument("--degrade", type=str, default="bilinear",
                        choices=["bilinear", "bicubic"])
    parser.add_argument("--denoise_eval", action="store_true",
                        help="evaluate an x1 (denoise) artifact against the training "
                             "degradation chain (gauss + ISO noise + JPEG) with a fixed "
                             "seed; without it an x1 artifact gets the clean input")
    parser.add_argument("--severity", type=str, default="default",
                        choices=["light", "default", "heavy"],
                        help="denoise-eval severity (data/degrade.DENOISE_SEVERITIES)")
    parser.add_argument("--antialias", action="store_true")
    parser.add_argument("--json_out", type=str, default=None)
    parser.add_argument("--data_devices", type=int, default=1,
                        help="shard eval batches over N devices (0 = all local "
                             "devices) — same data-axis serving as rs.py; on "
                             "--device cpu the CPU stands for N devices")
    parser.add_argument("--int8", action="store_true",
                        help="evaluate the fast families' int8 serving path, "
                             "calibrated on the first eval batch")
    parser.add_argument("--int8_percentile", type=float, default=None,
                        help="with --int8: calibrate activation scales to this "
                             "percentile of |x| instead of the max")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="accepted for parity; the port compiles no XLA programs")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    opt = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..core.mesh import gather, replicate, serving_devices, split_batch
    from ..data import degrade
    from ..data.manifest import load_manifest
    from ..data.pipeline import DevicePrefetcher, LoaderConfig, PatchLoader
    from ..models.deploy import load_artifact
    from ..utils.general import ground_up
    from ..utils.metrics import (gradient_hist_distance, hf_energy_ratio, psnr, psnr_y,
                                 psnr_y_per_image, sharpness, ssim)

    device = resolve_device(opt.device)
    devices = None
    if opt.data_devices != 1:
        if opt.data_devices < 0:
            raise SystemExit(f"--data_devices must be >= 0, got {opt.data_devices}")
        try:
            devices = serving_devices(opt.data_devices, device)
        except ValueError as e:
            raise SystemExit(str(e))
        if opt.batch_size % len(devices):
            raise SystemExit(f"--batch_size {opt.batch_size} must be divisible by "
                             f"--data_devices {len(devices)}")
    deployed = load_artifact(opt.model, device=device)
    scale = deployed.spec.output_scale
    if opt.denoise_eval and scale != 1:
        raise SystemExit(f"--denoise_eval needs an x1 artifact (this one upscales x{scale})")
    shape = ground_up(opt.shape, max(scale, 1))
    samples = load_manifest(opt.val_json)[: opt.max_images]
    loader = PatchLoader(samples, LoaderConfig(batch_size=opt.batch_size, patch_size=shape,
                                               scale=scale, workers=4, seed=0))
    var_rng, iso_rng, q_rng = degrade.DENOISE_SEVERITIES[opt.severity]

    def make_lr01(hr01, i):
        """Downscale for SR artifacts; the training noise chain (generator
        seeded with the batch index, --severity preset) for --denoise_eval;
        identity for plain x1."""
        if scale > 1:
            return degrade.downscale(hr01, scale, opt.degrade, opt.antialias)
        if opt.denoise_eval:
            gen = torch.Generator(device=device).manual_seed(i)
            return torch.clamp(degrade.denoise_degradation(
                gen, hr01, quality_range=q_rng, var_range=var_rng, intensity=iso_rng),
                0.0, 1.0)
        return hr01

    def to_u8(x01):
        return torch.clamp(torch.round(x01 * 255.0), 0, 255).to(torch.uint8)

    base = "noisy" if opt.denoise_eval else "bicubic"

    def serve(lr_u8):
        """The artifact on the LR batch: on one device, or split over the
        data devices' replicas and gathered back on ``device``."""
        if devices is None:
            return deployed(lr_u8)
        shards = split_batch(lr_u8, devices)
        return gather([r(s) for r, s in zip(replicas, shards)], device)

    def eval_batch(hr_u8, i):
        hr01 = hr_u8.float() / 255.0
        lr01 = make_lr01(hr01, i)
        sr01 = serve(to_u8(lr01)).float() / 255.0
        # the no-model baseline: the bicubic upsample, or the noisy input
        base01 = torch.clamp(degrade.upscale(lr01, scale) if scale > 1 else lr01, 0, 1)
        return {
            "psnr": psnr(sr01, hr01),
            "psnr_y": psnr_y(sr01, hr01),
            "ssim": ssim(sr01, hr01),
            "hf_ratio": hf_energy_ratio(sr01, hr01),
            "grad_dist": gradient_hist_distance(sr01, hr01),
            "sharpness": sharpness(sr01),
            "sharpness_hr": sharpness(hr01),
            f"{base}_psnr": psnr(base01, hr01),
            f"{base}_psnr_y": psnr_y(base01, hr01),
            f"{base}_hf_ratio": hf_energy_ratio(base01, hr01),
            "psnr_y_per_image": psnr_y_per_image(sr01, hr01),
        }

    scalars, per_image = [], []
    with DevicePrefetcher(iter(loader), device) as batches:
        first = next(batches)  # PatchLoader always yields at least one batch
        if opt.int8:
            # calibrated on the LR of the first batch, which the loop reuses
            from ..models.quantized import quantize_deployed

            lr_u8 = to_u8(make_lr01(first.float() / 255.0, 0))
            try:  # quantize_deployed owns the family whitelist
                deployed = quantize_deployed(deployed, [lr_u8], percentile=opt.int8_percentile)
            except ValueError as e:
                raise SystemExit(str(e)) from None
        if devices is not None:  # calibrated once, then replicated
            replicas = replicate(deployed, devices)
        for i, batch in enumerate(itertools.chain([first], batches)):
            metrics = eval_batch(batch, i)
            per_image.append(metrics.pop("psnr_y_per_image"))
            keys = sorted(metrics)  # the JAX CLI's order (a jitted dict comes back sorted)
            scalars.append(torch.stack([metrics[k].float() for k in keys]))
    rows = torch.stack(scalars).cpu().tolist()  # the run's one fetch
    n = len(rows)
    result = {k: round(sum(row[j] for row in rows) / n, 4) for j, k in enumerate(keys)}
    pi = torch.cat(per_image).cpu().numpy()
    result["psnr_y_min"] = round(float(pi.min()), 4)
    result["psnr_y_max"] = round(float(pi.max()), 4)
    result["psnr_y_std"] = round(float(pi.std()), 4)
    result["psnr_y_median"] = round(float(np.median(pi)), 4)
    result["n_images"] = int(pi.size)
    result["n_batches"] = n
    result["hr_crop"] = shape
    result["scale"] = scale
    print(json.dumps(result))
    if opt.json_out:
        with open(opt.json_out, "w") as fh:
            json.dump(result, fh)
    return result


if __name__ == "__main__":
    main()
