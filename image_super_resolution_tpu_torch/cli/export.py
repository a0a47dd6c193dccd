"""Export CLI: training checkpoint -> frozen uint8 -> uint8 ``.isr`` artifact
(counterpart of the JAX package's ``cli/export.py``).

    python -m image_super_resolution_tpu_torch.cli.export \
        --checkpoint gen_checkpoint_16_0.2.ckpt --out model.isr --scale 2

EMA weights (raw with ``--no_ema``), BN folded, the dataset mean/std of the
checkpoint baked in; the artifact is the JAX package's file, so either
package serves it. Depth, width, the fast denoiser's ``--downshuffle`` and
the refinement tail are read from the checkpoint when their flags are
absent. ``--smoke`` serves one 96x96 batch from the written file and times
a second call. ``--device`` (default ``cuda``) is where the model is built
and smoke-served.

``--stablehlo``, ``--tf_saved_model``, ``--torch_state_dict`` and
``--torch_discriminator`` exit naming the slice that brings them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

FORMATS_SLICE = "slice 5 (interop and export formats)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export a deployment artifact")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--out", type=str, default="model.isr")
    parser.add_argument("--family", type=str, default="sr",
                        choices=["sr", "fast", "denoise", "denoise_fast"])
    parser.add_argument("--rs_deep", type=int, default=None,
                        help="trunk depth (default: read from the checkpoint, else 16 "
                             "for sr/denoise and 14 for the fast families)")
    parser.add_argument("--downshuffle", type=int, default=None,
                        help="denoise_fast sub-pixel front factor (default: read from "
                             "the checkpoint's head conv, else 2)")
    parser.add_argument("--width", type=int, default=None,
                        help="trunk width (default: read from the checkpoint, else 64 "
                             "for sr and 128 for fast)")
    parser.add_argument("--add_rate", type=float, default=0.2)
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--enchant", action="store_true")
    parser.add_argument("--no_ema", action="store_true", help="export raw weights")
    parser.add_argument("--stablehlo", type=str, default=None, help=FORMATS_SLICE)
    parser.add_argument("--tf_saved_model", type=str, default=None, help=FORMATS_SLICE)
    parser.add_argument("--torch_state_dict", type=str, default=None, help=FORMATS_SLICE)
    parser.add_argument("--torch_discriminator", type=str, default=None, help=FORMATS_SLICE)
    parser.add_argument("--smoke", action="store_true",
                        help="run + time one forward after export")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="accepted for parity; the port compiles no XLA programs")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """Export; returns the ``DeploySpec`` written."""
    opt = build_parser().parse_args(argv)

    import torch

    from ..models.deploy import (DeploySpec, build_deployed, family_defaults,
                                 infer_downshuffle, infer_family_dims, infer_refine,
                                 load_artifact, save_artifact)
    from ..train.checkpoint import load_checkpoint
    from ..utils.general import flatten_tree

    for flag in ("stablehlo", "tf_saved_model", "torch_state_dict", "torch_discriminator"):
        if getattr(opt, flag):
            raise SystemExit(f"--{flag} is not ported yet: it comes with {FORMATS_SLICE}")
    if opt.downshuffle is not None and opt.family != "denoise_fast":
        raise SystemExit("--downshuffle applies to --family denoise_fast only")
    if opt.downshuffle is not None and opt.downshuffle < 1:
        raise SystemExit(f"--downshuffle must be >= 1, got {opt.downshuffle}")
    ckpt = load_checkpoint(opt.checkpoint)
    params = ckpt.get("params", {})
    inf_depth, inf_width = infer_family_dims(params, opt.family)
    depth, width = family_defaults(
        opt.family,
        opt.rs_deep if opt.rs_deep is not None else inf_depth,
        opt.width if opt.width is not None else inf_width)
    downshuffle = 1
    if opt.family == "denoise_fast":
        inferred = infer_downshuffle(params)
        if opt.downshuffle is not None and inferred is not None and opt.downshuffle != inferred:
            raise SystemExit(
                f"--downshuffle {opt.downshuffle} contradicts the checkpoint (its head "
                f"conv sees 3*{inferred}^2 input channels => the model was trained with "
                f"downshuffle {inferred})")
        downshuffle = opt.downshuffle or inferred or 2
    refine_blocks, refine_width = 0, 32
    if opt.family in ("fast", "denoise_fast"):
        refine_blocks, refine_width = infer_refine(params)
    if ckpt["meta"].get("loss"):
        print("mean loss:", float(np.mean(ckpt["meta"]["loss"])))
    spec = DeploySpec(
        family=opt.family, depth=depth, add_rate=opt.add_rate,
        scale=1 if opt.family.startswith("denoise") else opt.scale,  # denoisers are x1
        enchant=opt.enchant, width=width, downshuffle=downshuffle,
        refine_blocks=refine_blocks, refine_width=refine_width)
    deployed, fused = build_deployed(ckpt, spec, use_ema=not opt.no_ema, device=opt.device)
    save_artifact(opt.out, deployed.spec, fused)
    n_p = sum(np.asarray(leaf).size for leaf in flatten_tree(fused).values())
    print(f"{n_p:,} parameters -> {opt.out}")

    if opt.smoke:
        reloaded = load_artifact(opt.out, device=opt.device)
        feed = np.zeros((1, 96, 96, 3), np.uint8)
        out = reloaded(feed)
        sync = torch.cuda.synchronize if reloaded.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        reloaded(feed)
        sync()
        print(f"smoke: {feed.shape} uint8 -> {tuple(out.shape)} {out.dtype}, "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms/iter")
    return deployed.spec


if __name__ == "__main__":
    main()
