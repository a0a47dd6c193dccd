"""Image decoding for the CLIs and the training loader: OpenCV, else Pillow,
else the package's own PNG reader (``utils/png.py``), which exists only for
hosts that have neither library and reads PNG alone."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_image_rgb(path: str | Path) -> np.ndarray:
    """HWC uint8 RGB; raises when no available decoder reads the file."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    img = None if cv2 is None else cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is not None:
        return img[..., ::-1].copy()
    try:
        from PIL import Image
    except ImportError:
        from .png import read_png

        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
