"""Truncated VGG19 feature extractor for the perceptual loss (counterpart of
the JAX package's ``models/vgg.py``).

``TruncatedVGG19(i, j, before_act)`` keeps VGG19's feature stack up to the
j-th conv after the (i-1)-th max-pool; ``before_act=True`` stops right after
that conv (pre-activation features, the ``--enchant`` flavour), else it
includes the ReLU. Convs are named ``conv{k}`` as flax names them. The model
is frozen: its params never require a gradient.

Weights: a local npz of ``conv{k}/kernel`` (HWIO) and ``conv{k}/bias``
(``load_vgg19_npz``), or a local torchvision VGG19 ``.pth``/``.pt`` state
dict loaded directly (``load_vgg19_torch``). Nothing is downloaded. Without
either, ``init_vgg_params`` draws He-normal random features from a
``torch.Generator`` (the JAX package's ``PRNGKey(0)`` draws the same
distribution, not the same values) and warns.
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.conv import conv_bias_nhwc

# VGG19 'features': conv channel counts, 'M' = 2x2/2 max-pool.
VGG19_PLAN: Tuple[Union[int, str], ...] = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512, "M",
)
# He-normal as flax draws it: a normal truncated at two standard deviations,
# rescaled so that the variance stays 2 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _truncation_point(i: int, j: int) -> int:
    """Number of conv layers to keep: the j-th conv after the (i-1)-th pool."""
    pools = convs_after = keep = 0
    for item in VGG19_PLAN:
        if item == "M":
            pools += 1
            convs_after = 0
        else:
            keep += 1
            convs_after += 1
        if pools == i - 1 and convs_after == j:
            return keep
    raise ValueError(f"invalid (i={i}, j={j}) for VGG19")


class TruncatedVGG19(nn.Module):
    """VGG19 features truncated at (i, j): normalized NHWC images in, fp32
    NHWC features out. Params are held in ``dtype`` (bf16 for training: the
    values flax's fp32 params round to in its bf16 convs)."""

    def __init__(self, i: int = 5, j: int = 4, before_act: bool = False,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.i, self.j, self.before_act = i, j, before_act
        self.dtype = dtype
        self.keep = _truncation_point(i, j)
        dev = resolve_device(device)
        self.plan = []  # VGG19_PLAN up to the last kept conv
        n, cin = 0, 3
        for item in VGG19_PLAN:
            if n == self.keep:
                break
            if item != "M":
                self.add_module(f"conv{n}", nn.Conv2d(cin, int(item), 3, padding=1,
                                                      dtype=dtype, device=dev))
                cin, n = int(item), n + 1
            self.plan.append(item)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        k = 0
        for item in self.plan:
            if item == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                continue
            conv = getattr(self, f"conv{k}")
            k += 1
            x = conv_bias_nhwc(x, conv.weight, conv.bias, padding=1)
            if not (k == self.keep and self.before_act):
                x = torch.relu(x)
        return x.float()


@torch.no_grad()
def load_vgg19_npz(path: Union[str, Path], model: TruncatedVGG19) -> TruncatedVGG19:
    """Fill ``model`` from an npz of ``conv{k}/kernel`` (HWIO) and
    ``conv{k}/bias`` arrays; raises on a shape that differs."""
    data = np.load(Path(path))
    for k in range(model.keep):
        conv = getattr(model, f"conv{k}")
        kernel = data[f"conv{k}/kernel"]
        want = tuple(conv.weight.shape[2:]) + tuple(conv.weight.shape[1::-1])
        if kernel.shape != want:
            raise ValueError(f"conv{k}: shape {kernel.shape} != {want}")
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(np.asarray(data[f"conv{k}/bias"])))
    return model


@torch.no_grad()
def load_vgg19_torch(path: Union[str, Path], model: TruncatedVGG19) -> TruncatedVGG19:
    """Fill ``model`` from a torchvision VGG19 state dict (``features.{n}``
    conv weights, OIHW, in layer order)."""
    sd = torch.load(Path(path), map_location="cpu", weights_only=True)
    keys = sorted((key for key in sd if key.startswith("features.")
                   and key.endswith(".weight") and sd[key].ndim == 4),
                  key=lambda key: int(key.split(".")[1]))
    for k in range(model.keep):
        conv = getattr(model, f"conv{k}")
        w = sd[keys[k]]
        if tuple(w.shape) != tuple(conv.weight.shape):
            raise ValueError(f"conv{k}: shape {tuple(w.shape)} != {tuple(conv.weight.shape)}")
        conv.weight.copy_(w)
        conv.bias.copy_(sd[keys[k].replace(".weight", ".bias")])
    return model


@torch.no_grad()
def init_random_vgg(model: TruncatedVGG19, seed: int = 0) -> TruncatedVGG19:
    """He-normal kernels (truncated at 2 sigma, std sqrt(2/fan_in)) and zero
    biases, drawn in layer order from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(int(seed))
    for k in range(model.keep):
        conv = getattr(model, f"conv{k}")
        std = math.sqrt(2.0 / conv.weight[0].numel()) / _TRUNC_STD
        w = torch.empty(conv.weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        conv.weight.copy_(w)
        conv.bias.zero_()
    return model


def init_vgg_params(model: TruncatedVGG19, weights_path: Optional[Union[str, Path]] = None,
                    with_status: bool = False):
    """Load ``weights_path`` (npz, or a torchvision ``.pth``/``.pt``) into
    ``model`` when the file exists, else draw random features with a warning.
    Returns the model, or ``(model, loaded)`` with ``with_status``; callers
    switch the perceptual loss to its feature-normalized mode when
    ``loaded`` is False."""
    p = Path(weights_path) if weights_path is not None else None
    if p is not None and p.exists():
        (load_vgg19_torch if p.suffix in (".pth", ".pt") else load_vgg19_npz)(p, model)
        loaded = True
    else:
        init_random_vgg(model)
        loaded = False
        if p is not None:
            warnings.warn(f"VGG weights {weights_path} not found; using random features")
        else:
            warnings.warn("TruncatedVGG19 running with RANDOM weights (no ImageNet "
                          "checkpoint available). Perceptual loss is a structural proxy; "
                          "pass --vgg_weights for parity with the reference.")
    return (model, loaded) if with_status else model
