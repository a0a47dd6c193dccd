"""Shared constants and helpers (counterpart of the JAX package's
``utils/general.py``, limited to what the port uses)."""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Tuple

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


def ground_up(value: int, stride: int) -> int:
    """Round ``value`` up to the next multiple of ``stride``."""
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    return math.ceil(value / stride) * stride


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict into {'a/b/c': leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = out
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def intersect_trees(source: Mapping[str, Any], target: Mapping[str, Any],
                    exclude: Iterable[str] = ()) -> Tuple[Dict[str, Any], int, int]:
    """``target`` with every leaf whose path and shape match in ``source``
    replaced by the source's, plus (n_matched, n_total): the reference's
    ``intersect_dicts`` on nested trees ("Loaded pre-trained k/n model")."""
    flat_src = flatten_tree(source)
    flat_tgt = flatten_tree(target)
    matched = 0
    merged: Dict[str, Any] = {}
    for key, tgt_leaf in flat_tgt.items():
        src_leaf = flat_src.get(key)
        if (src_leaf is not None and not any(x in key for x in exclude)
                and getattr(src_leaf, "shape", None) == getattr(tgt_leaf, "shape", None)):
            merged[key] = src_leaf
            matched += 1
        else:
            merged[key] = tgt_leaf
    return unflatten_tree(merged), matched, len(flat_tgt)
