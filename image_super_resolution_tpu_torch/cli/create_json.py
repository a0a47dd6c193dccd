"""Manifest-writing CLI (counterpart of the JAX package's
``cli/create_json.py``, the same flags):

    python -m image_super_resolution_tpu_torch.cli.create_json \
        --train_dirs data/train --val_dirs data/val --shape 96 --output ./

writes ``train_images.json`` and ``val_images.json`` under ``--output``,
keeping the images at least ``--shape`` pixels on both sides.
"""

from __future__ import annotations

import argparse

from ..data.manifest import create_data_lists


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Build train/val image manifests")
    parser.add_argument("--train_dirs", type=str, nargs="+", default=[])
    parser.add_argument("--val_dirs", type=str, nargs="+", default=[])
    parser.add_argument("--shape", type=int, default=96, help="minimum image size")
    parser.add_argument("--output", type=str, default="./")
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None):
    """Returns the paths of the two manifests written."""
    opt = build_parser().parse_args(argv)
    return create_data_lists(train_folders=opt.train_dirs, val_folders=opt.val_dirs,
                             min_size=opt.shape, output_folder=opt.output,
                             verbose=opt.verbose)


if __name__ == "__main__":
    main()
