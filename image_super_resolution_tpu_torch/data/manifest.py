"""Dataset manifest (counterpart of the JAX package's ``data/manifest.py``):
a JSON file holding a flat list of image paths, as ``create_json.py``
writes it. Writing manifests comes with the small CLIs (slice 5)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import List


def load_manifest(json_path: str | Path) -> List[str]:
    with open(Path(json_path)) as fh:
        samples = json.load(fh)
    if not isinstance(samples, list):
        raise ValueError(f"{json_path} is not a flat list of image paths")
    return samples
