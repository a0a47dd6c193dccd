"""Inference-only generator in its optimized form (counterpart of the JAX
package's ``models/optimized.py``): an exact rewrite of the fused
``SRGenerator`` up to float reassociation.

1. every RDB in scatter form (ops/scatter.py), computed on the card by the
   fused kernel ``ops/kernels/fused_rdb.py``, or, with ``wino_m`` 2 or 4,
   through Winograd F(wino_m, 3) convs (ops/winograd.py);
2. the 9x9 HR tail conv folded through the final pixel shuffle
   (``tail_fold=1``: 5x5 conv, 12 outputs) or through both shuffles of a x4
   generator (``tail_fold=2``: 6x6 stride-2 conv, padding 2, 48 outputs).

The last Upsampler's act commutes with depth_to_space, so its shuffle is
deferred: ... -> up_conv -> act -> folded_tail -> tanh -> d2s.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.activations import apply_act, dtype_scalar
from ..ops.blocks import Upsampler
from ..ops.conv import ConvBlock, conv_nhwc
from ..ops.fold_tail import fold_tail_params, fold_tail_params_x4
from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.scatter import ScatterRDB, rdb_params_to_scatter


class ScatterRRDB(nn.Module):
    """3 x ScatterRDB with the RRDB residual scale-add. With ``wino_m`` the
    rate is rounded to the activations' dtype first, as the JAX module
    scales by it."""

    def __init__(self, features: int = 64, add_rate: float = 0.2, wino_m: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.add_rate = dtype_scalar(add_rate, dtype) if wino_m else add_rate
        for j in range(3):
            self.add_module(f"rdb{j}", ScatterRDB(
                features, ("leaky_relu", 0.01), add_rate, wino_m=wino_m,
                dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rdb2(self.rdb1(self.rdb0(x)))
        return h * self.add_rate + x


class _DeferredShuffleUp(nn.Module):
    """Last x2 stage with its shuffle deferred past the tail: conv + act.
    Same parameter layout as ``Upsampler`` (a ``conv`` ConvBlock child)."""

    def __init__(self, features: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.conv = ConvBlock(features, features * 4, 3, act=None,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.conv(x), ("leaky_relu", 0.01))


class _StridedTail(nn.Module):
    """6x6 stride-2 conv, padding 2: the double-folded x4 tail."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 6, stride=2, padding=2,
                              dtype=dtype, device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv)


class OptimizedSRGenerator(nn.Module):
    """Fused, scatter-form, tail-folded generator. Inference only. NHWC in,
    fp32 NHWC in [-1, 1] out."""

    def __init__(self, depth: int = 16, add_rate: float = 0.2, scale: int = 2,
                 width: int = 64, enchant: bool = False, wino_m: int = 0,
                 tail_fold: int = 1, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError("optimized generator supports scale 2 or 4")
        if tail_fold == 2 and scale != 4:
            raise ValueError("tail_fold=2 needs two x2 stages (scale 4)")
        if tail_fold not in (1, 2):
            raise ValueError(f"tail_fold must be 1 or 2, got {tail_fold}")
        self.depth = depth
        self.dtype = dtype
        self.tail_fold = tail_fold
        kw = dict(dtype=dtype, device=device)
        head_act = ("leaky_relu", 0.01 if enchant else 0.2)
        self.head = ConvBlock(3, width, 9, act=head_act, **kw)
        for i in range(depth):
            self.add_module(f"rrdb{i}", ScatterRRDB(width, add_rate, wino_m, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, **kw)
        # all but the last x2 stage run in full (conv -> d2s -> act)
        self.n_full = scale // 2 - 1
        for i in range(self.n_full):
            self.add_module(f"up{i}", Upsampler(width, 2, 3,
                                                act=("leaky_relu", 0.01), **kw))
        self.add_module(f"up{self.n_full}", _DeferredShuffleUp(width, **kw))
        if tail_fold == 2:
            self.tail_folded2 = _StridedTail(width * 4, 48, **kw)
        else:
            self.tail_folded = ConvBlock(width * 4, 12, 5, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        h = x
        for i in range(self.depth):
            h = getattr(self, f"rrdb{i}")(h)
        x = x + self.trunk_conv(h)
        for i in range(self.n_full + 1):
            x = getattr(self, f"up{i}")(x)
        if self.tail_fold == 2:
            x = torch.tanh(self.tail_folded2(x))
            return pixel_shuffle(pixel_shuffle(x, 2), 2).float()
        return pixel_shuffle(self.tail_folded(x), 2).float()


def optimize_generator_params(fused: Dict[str, Any], wino_m: int = 0,
                              tail_fold: int = 1) -> Dict[str, Any]:
    """Fused standard SRGenerator params -> OptimizedSRGenerator params
    (flax trees of numpy arrays; the RDB kernels in the Winograd domain when
    ``wino_m`` is 2 or 4)."""
    out: Dict[str, Any] = {}
    for name, node in fused.items():
        if name.startswith("rrdb"):
            out[name] = {
                rdb_name: rdb_params_to_scatter(rdb_node, wino_m)
                for rdb_name, rdb_node in node.items()
            }
        elif name == "tail":
            if tail_fold == 2:
                out["tail_folded2"] = fold_tail_params_x4(node)
            else:
                out["tail_folded"] = fold_tail_params(node)
        else:
            out[name] = node
    return out
