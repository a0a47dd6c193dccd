"""Export flax-layout param trees back to reference-layout torch state_dicts
(counterpart of the JAX package's ``interop/torch_export.py``; the inverse
of ``torch_import.py``).

A user who trained with the port hands the result to anyone still running
the PyTorch reference: the dict loads with ``strict=True`` into the
reference's ResNet/EResNet, Denoise or Discriminator (key layout of
utils/models.py:513-706).

- conv kernels go HWIO -> OIHW (``from_jax.conv_kernel_to_torch``);
- BatchNorm: the tree splits trainables (``bn/scale``, ``bn/bias``) from
  running statistics (batch_stats ``bn/mean``, ``bn/var``); torch keeps all
  four plus ``num_batches_tracked``, written as 0 (torch reads it only for
  its momentum ramp in training).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .from_jax import conv_kernel_to_torch


def _emit_block(sd: Dict[str, np.ndarray], tprefix: str, params: Dict[str, Any],
                stats: Optional[Dict[str, Any]] = None) -> None:
    """ConvBlock subtree -> reference Conv/ConvWithoutBN state-dict keys."""
    sd[f"{tprefix}.conv.weight"] = conv_kernel_to_torch(params["conv"]["kernel"])
    if "bias" in params["conv"]:
        sd[f"{tprefix}.conv.bias"] = np.ascontiguousarray(params["conv"]["bias"])
    if "bn" in params:
        scale = np.asarray(params["bn"]["scale"])
        bn_stats = (stats or {}).get("bn", {})
        sd[f"{tprefix}.bn.weight"] = scale
        sd[f"{tprefix}.bn.bias"] = np.asarray(params["bn"]["bias"])
        sd[f"{tprefix}.bn.running_mean"] = np.asarray(bn_stats.get("mean", np.zeros_like(scale)))
        sd[f"{tprefix}.bn.running_var"] = np.asarray(bn_stats.get("var", np.ones_like(scale)))
        sd[f"{tprefix}.bn.num_batches_tracked"] = np.asarray(0, np.int64)


def export_generator_state(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]] = None,
                           prefix: str = "") -> Dict[str, np.ndarray]:
    """SRGenerator (params, batch_stats) -> reference ResNet/EResNet
    state_dict. Pass ``prefix="res_net."`` for the SRGAN wrapper layout."""
    stats = batch_stats or {}
    g = lambda k: f"{prefix}{k}"
    sd: Dict[str, np.ndarray] = {}
    _emit_block(sd, g("conv0"), params["head"], stats.get("head"))
    depth = 0
    while f"rrdb{depth}" in params:
        rrdb_p = params[f"rrdb{depth}"]
        rrdb_s = stats.get(f"rrdb{depth}", {})
        for j in range(3):
            rdb_p = rrdb_p[f"rdb{j}"]
            rdb_s = rrdb_s.get(f"rdb{j}", {})
            for k in range(4):
                _emit_block(sd, g(f"residual.{depth}.net.{j}.conv{k}"), rdb_p[f"conv{k}"],
                            rdb_s.get(f"conv{k}"))
            _emit_block(sd, g(f"residual.{depth}.net.{j}.conv"), rdb_p["conv_fuse"],
                        rdb_s.get("conv_fuse"))
        depth += 1
    _emit_block(sd, g("conv1"), params["trunk_conv"], stats.get("trunk_conv"))
    n_up = 0
    while f"up{n_up}" in params:  # Upsampler nests its ConvBlock under "conv"
        _emit_block(sd, g(f"scaler.{n_up}.net.0"), params[f"up{n_up}"]["conv"])
        n_up += 1
    _emit_block(sd, g("conv2"), params["tail"], None)
    return sd


def linear_to_torch(w_in_out: np.ndarray, feature_hwc: Optional[tuple] = None) -> np.ndarray:
    """flax Dense (in, out) -> torch Linear (out, in); with ``feature_hwc``
    the input columns go back from (H, W, C) to torch's (C, H, W) order."""
    w = conv_kernel_to_torch(w_in_out)  # a 2-D kernel is transposed
    if feature_hwc is not None:
        h, w_, c = feature_hwc
        out = w.shape[0]
        w = w.reshape(out, h, w_, c).transpose(0, 3, 1, 2).reshape(out, c * h * w_)
    return np.ascontiguousarray(w)


def export_discriminator_state(params: Dict[str, Any],
                               batch_stats: Optional[Dict[str, Any]] = None,
                               prefix: str = "", pooled_hw: tuple = (6, 6)) -> Dict[str, np.ndarray]:
    """Discriminator (params, batch_stats) -> reference Discriminator
    state_dict."""
    stats = batch_stats or {}
    g = lambda k: f"{prefix}{k}"
    sd: Dict[str, np.ndarray] = {}
    i = 0
    out_ch = 0
    while f"block{i}" in params:
        _emit_block(sd, g(f"conv_blocks.{i}"), params[f"block{i}"], stats.get(f"block{i}"))
        out_ch = params[f"block{i}"]["conv"]["kernel"].shape[-1]
        i += 1
    h, w = pooled_hw
    fc1, fc2 = params["fc1"]["dense"], params["fc2"]["dense"]
    sd[g("fc1.0.weight")] = linear_to_torch(fc1["kernel"], (h, w, out_ch))
    sd[g("fc1.0.bias")] = np.asarray(fc1["bias"])
    sd[g("fc2.weight")] = linear_to_torch(fc2["kernel"])
    sd[g("fc2.bias")] = np.asarray(fc2["bias"])
    return sd


def export_denoiser_state(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]] = None,
                          prefix: str = "") -> Dict[str, np.ndarray]:
    """Denoiser (params, batch_stats) -> reference Denoise state_dict
    (current revision)."""
    stats = batch_stats or {}
    g = lambda k: f"{prefix}{k}"
    sd: Dict[str, np.ndarray] = {}
    _emit_block(sd, g("conv0.0"), params["head"], stats.get("head"))
    for out_name, seq_key in (("res0_", "residual_0"), ("res1_", "residual_1"),
                              ("res2_", "residual_2")):
        n = 0
        while f"{out_name}{n}" in params:
            block_p, block_s = params[f"{out_name}{n}"], stats.get(f"{out_name}{n}") or {}
            for k in range(2):
                _emit_block(sd, g(f"{seq_key}.{n}.m.{k}"), block_p[f"conv{k}"],
                            block_s.get(f"conv{k}"))
            n += 1
    _emit_block(sd, g("residual_conv0"), params["down"], stats.get("down"))
    _emit_block(sd, g("conv1"), params["trunk_conv"], stats.get("trunk_conv"))
    _emit_block(sd, g("conv2.0"), params["tail"], stats.get("tail"))
    return sd


_EXPORTERS = {"sr": export_generator_state, "denoise": export_denoiser_state,
              "discriminator": export_discriminator_state}


def save_torch_state_dict(path, params: Dict[str, Any],
                          batch_stats: Optional[Dict[str, Any]] = None, prefix: str = "",
                          meta: Optional[Dict[str, Any]] = None, family: str = "sr") -> None:
    """``torch.save`` a reference-layout state_dict to ``path`` as
    ``{"state_dict": {key: tensor}, "meta": {...}}``, float tensors in fp32.

    It loads on any torch install with
    ``net.load_state_dict(torch.load(path)["state_dict"], strict=True)``
    into the reference class of ``family``: "sr" -> ResNet/EResNet,
    "denoise" -> Denoise, "discriminator" -> Discriminator.
    """
    if family not in _EXPORTERS:
        raise ValueError(f"unknown family {family!r}; one of {sorted(_EXPORTERS)}")
    sd = _EXPORTERS[family](params, batch_stats, prefix=prefix)
    tensors = {}
    for k, v in sd.items():
        v = np.asarray(v)
        tensors[k] = torch.from_numpy(np.array(v, np.float32 if v.dtype.kind == "f" else v.dtype))
    torch.save({"state_dict": tensors, "meta": dict(meta or {})}, str(path))
