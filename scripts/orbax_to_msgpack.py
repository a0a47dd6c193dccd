#!/usr/bin/env python
"""Rewrite a checkpoint that the JAX package saved with ``--ckpt_backend
orbax`` (a directory) as the msgpack checkpoint file that both packages'
``--resume`` read (``train/checkpoint.py``'s format).

    python scripts/orbax_to_msgpack.py runs/res_r_16_0.2.ckpt.orbax runs/res_r_16_0.2.ckpt

It runs under JAX: the directory is read by the JAX package's
``load_any_checkpoint`` (an Orbax ``<name>.old`` survivor of a crashed save
too), and the payload is written as the JAX package's msgpack save writes
it: params, BN statistics and their EMA as fp16, ``meta`` as JSON, the
optimizer state (absent after a run's final epoch) and the GAN phase's
discriminator entries as they are. The PyTorch port does not import Orbax,
so a JAX run trained with the Orbax backend resumes in the port from the
file this writes (same ``--work_dir`` and checkpoint name: move the
directory aside first, as in the example).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FP16_TREES = ("params", "batch_stats", "ema_params", "ema_batch_stats")


def convert(src: str | Path, dst: str | Path) -> dict:
    """Read the Orbax checkpoint at ``src``, write the msgpack file ``dst``
    (through ``<dst>.tmp`` and a rename); returns its meta."""
    from flax import serialization

    from image_super_resolution_tpu.train.checkpoint import _to_fp16, load_any_checkpoint

    src, dst = Path(src), Path(dst)
    if dst.resolve() == src.resolve() or dst.is_dir():
        raise SystemExit(f"{dst}: write the msgpack file beside the Orbax directory, "
                         f"not over it (move the directory aside first)")
    raw = load_any_checkpoint(src)
    meta = {k: np.asarray(v).tolist() for k, v in raw["meta"].items()}
    payload = {k: _to_fp16(v) if k in FP16_TREES else v
               for k, v in raw.items() if k != "meta"}
    payload["meta"] = json.dumps(meta)
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(dst.name + ".tmp")
    tmp.write_bytes(serialization.msgpack_serialize(payload))
    os.replace(tmp, dst)
    return meta


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="the Orbax checkpoint directory")
    parser.add_argument("dst", help="the msgpack checkpoint file to write")
    opt = parser.parse_args(argv)
    meta = convert(opt.src, opt.dst)
    print(f"{opt.src} -> {opt.dst}: epoch {meta['epoch']}, step {meta['step']}")
    return meta


if __name__ == "__main__":
    main()
