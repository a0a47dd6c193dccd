"""Import CLI: reference PyTorch artifact -> ``.isr`` artifact (counterpart of
the JAX package's ``cli/import_torch.py``).

Converts a reference TorchScript deployment artifact (e.g. the bundled
``model.pt``, reference utils/models.py:801-802) into the ``.isr`` file that
``rs``, ``TiledUpscaler`` and either package serve:

    python -m image_super_resolution_tpu_torch.cli.import_torch --src model.pt --out model.isr
    python -m image_super_resolution_tpu_torch.cli.rs --model model.isr --src photo.png

``--smoke`` runs the TorchScript artifact on the CPU in fp32 and the
imported ``DeployedModel`` on ``--device`` (default ``cuda``) on one seeded
(1, 96, 96, 3) uint8 batch and prints the largest uint8 difference and the
share of pixels that differ. Training checkpoints pickle whole reference
modules and are a library path
(``interop.state_dict_from_reference_checkpoint`` and the
``import_*_state`` mappers).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert reference torch artifacts to .isr")
    parser.add_argument("--src", type=str, required=True, help=".pt artifact")
    parser.add_argument("--out", type=str, default="model.isr")
    parser.add_argument("--reference_root", type=str, default=None,
                        help="reference repo path (training ckpts only)")
    parser.add_argument("--key", type=str, default="ema",
                        help="module key inside a training ckpt (ema/gen_net/model)")
    parser.add_argument("--smoke", action="store_true",
                        help="run one forward on both runtimes and compare")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """Import; returns (spec, None) or, with ``--smoke``, (spec, (largest
    uint8 difference, share of values that differ))."""
    opt = build_parser().parse_args(argv)

    from ..interop.torch_import import import_torchscript_artifact
    from ..models.deploy import save_artifact
    from ..utils.general import flatten_tree

    if opt.reference_root:
        raise SystemExit(
            "training-checkpoint import is a library API "
            "(interop.state_dict_from_reference_checkpoint + the per-family "
            "import_*_state mappers) — the artifact path only takes "
            "TorchScript files")

    deployed, spec, params = import_torchscript_artifact(opt.src, device=opt.device)
    save_artifact(opt.out, spec, params)
    n = sum(np.asarray(leaf).size for leaf in flatten_tree(params).values())
    print(f"{n:,} parameters ({spec.family}, depth {spec.depth}) -> {opt.out}")
    if not opt.smoke:
        return spec, None

    x = np.random.default_rng(0).integers(0, 255, (1, 96, 96, 3), dtype=np.uint8)
    with torch.no_grad():
        want = torch.jit.load(opt.src, map_location="cpu")(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    got = deployed(x).cpu().numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    worst, share = int(diff.max()), float((diff > 0).mean())
    print(f"torch-vs-port uint8 max diff: {worst} (mismatching pixels: {share:.2%})")
    return spec, (worst, share)


if __name__ == "__main__":
    main()
