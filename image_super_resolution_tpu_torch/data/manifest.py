"""Dataset manifests (counterpart of the JAX package's ``data/manifest.py``):
JSON files holding a flat list of image paths.

``create_data_lists`` scans folders recursively and keeps every image that
decodes and is at least ``min_size`` on both sides, writing
``train_images.json`` and ``val_images.json``. A file that is too small or
cannot be read is skipped and counted, never deleted or rewritten. Images
are decoded by ``utils/image_io.py`` (OpenCV, else Pillow, else the
package's own PNG reader), so the scan runs on hosts without either
library.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

from ..utils.general import IMG_FORMATS
from ..utils.image_io import read_image_rgb


def _scan(folders: Iterable[str | Path], min_size: int, verbose: bool) -> Tuple[List[str], int]:
    kept: List[str] = []
    skipped = 0
    for folder in folders:
        for path in sorted(Path(folder).rglob("*")):
            if path.suffix.lower() not in IMG_FORMATS:
                continue
            try:
                h, w = read_image_rgb(path).shape[:2]
            except Exception:  # any decoder's failure
                skipped += 1
                if verbose:
                    print(f"skip unreadable image {path}")
                continue
            if w < min_size or h < min_size:
                skipped += 1
                if verbose:
                    print(f"skip small image {path} (< {min_size}px)")
                continue
            kept.append(path.as_posix())
    return kept, skipped


def create_data_lists(
    train_folders: Sequence[str | Path],
    val_folders: Sequence[str | Path],
    min_size: int,
    output_folder: str | Path = "./",
    verbose: bool = False,
) -> Tuple[Path, Path]:
    """Write train_images.json / val_images.json; returns their paths."""
    out_dir = Path(output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for split, folders in (("train", train_folders), ("val", val_folders)):
        kept, skipped = _scan(folders, min_size, verbose)
        what = "training" if split == "train" else "validating"
        print(f"There are {len(kept)} images in the {what} data ({skipped} skipped).")
        out = out_dir / f"{split}_images.json"
        out.write_text(json.dumps(kept))
        paths.append(out)
    return paths[0], paths[1]


def load_manifest(json_path: str | Path) -> List[str]:
    with open(Path(json_path)) as fh:
        samples = json.load(fh)
    if not isinstance(samples, list):
        raise ValueError(f"{json_path} is not a flat list of image paths")
    return samples
