"""Shared constants and helpers (counterpart of the JAX package's
``utils/general.py``, limited to what the port uses)."""

from __future__ import annotations

# Acceptable image/video suffixes (reference: utils/general.py:13-16).
IMG_FORMATS = (
    ".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".dng",
    ".webp", ".mpo", ".pfm", ".ppm", ".pgm",
)
VID_FORMATS = (
    ".asf", ".mov", ".avi", ".mp4", ".mpg", ".mpeg", ".m4v",
    ".wmv", ".mkv", ".gif",
)


def autopad(kernel_size: int, pad_size: int | None = None, dilation: int = 1) -> int:
    """'same' padding for odd kernels, incl. dilation."""
    if dilation > 1:
        kernel_size = dilation * (kernel_size - 1) + 1
    if pad_size is None:
        pad_size = kernel_size // 2
    return pad_size
