"""BatchNorm -> conv folding as a pure param-tree transform (counterpart of
the JAX package's ``ops/fuse.py``), on flax-layout trees of numpy arrays.

A model built with ``use_bn=True`` has ``conv``/``bn`` siblings in every
ConvBlock; the fused tree drops the ``bn`` nodes and gives each such
``conv`` the folded bias, which is the layout of the same architecture built
with ``use_bn=False``:

    W' = W * g / sqrt(var + eps);  b' = beta - g * mean / sqrt(var + eps)

in fp32, the ops in the JAX package's order.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .conv import BN_EPS


def fuse_conv_bn(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                 eps: float = BN_EPS) -> Dict[str, Any]:
    """Fold every conv+bn pair; returns a params tree for the no-BN model."""

    def f32(x):
        return np.asarray(x, np.float32)

    def rec(p: Mapping[str, Any], s: Mapping[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, val in p.items():
            if key == "bn":
                continue  # consumed alongside its sibling conv
            if key == "conv" and "bn" in p:
                bn_p, bn_s = p["bn"], s.get("bn", {})
                scale = f32(bn_p["scale"]) / np.sqrt(f32(bn_s["var"]) + np.float32(eps))
                kernel = np.asarray(val["kernel"])
                bias = f32(bn_p["bias"]) - f32(bn_s["mean"]) * scale
                if val.get("bias") is not None:
                    bias = bias + f32(val["bias"]) * scale
                out["conv"] = {"kernel": (f32(kernel) * scale).astype(kernel.dtype),
                               "bias": bias.astype(kernel.dtype)}
            elif isinstance(val, Mapping):
                out[key] = rec(val, s.get(key, {}) if isinstance(s, Mapping) else {})
            else:
                out[key] = val
        return out

    return rec(params, batch_stats)
