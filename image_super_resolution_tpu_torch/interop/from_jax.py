"""The weight bridge: the JAX package's param trees <-> the port's modules.

A flax param tree (nested dicts of numpy arrays, as an ``.isr`` artifact
stores it) maps onto the port's ``state_dict`` by name: flax path
``rrdb0/rdb1/conv2/conv/kernel`` is ``rrdb0.rdb1.conv2.conv.weight``.

- conv kernels go HWIO -> OIHW (``transpose(3, 2, 0, 1)``), biases as they are;
- a BatchNorm node ``bn/scale``, ``bn/bias`` is ``bn.weight``, ``bn.bias``,
  and its batch_stats ``bn/mean``, ``bn/var`` are the buffers
  ``bn.running_mean``, ``bn.running_var``;
- ``prelu/alpha`` is ``prelu.alpha``;
- a scatter-form RDB node (``sx``..``s3`` + ``bias``) becomes the kernel's
  (9*Cin, Cout) matmul forms and a (1, 4g+C) bias
  (``ops/kernels/fused_rdb.scatter_params_to_matmul``).

Every tensor comes out fp32 on the CPU; ``load_state_dict`` casts it into
the module's own dtype and device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..ops.kernels.fused_rdb import scatter_params_to_matmul

_SCATTER_KEYS = ("sx", "s0", "s1", "s2", "s3", "bias")


def conv_kernel_to_torch(w_hwio) -> np.ndarray:
    """flax HWIO -> torch Conv2d OIHW."""
    return np.ascontiguousarray(np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1))


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax param tree of numpy arrays -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if not isinstance(node, Mapping):
            raise ValueError(f"unexpected leaf {key!r} outside a conv, bn, prelu "
                             f"or scatter node")
        if "sx" in node:
            mats = scatter_params_to_matmul(node, dtype=torch.float32)
            sd.update({f"{key}.{k}": t for k, t in zip(_SCATTER_KEYS, mats)})
        elif "kernel" in node:
            sd[f"{key}.weight"] = torch.from_numpy(conv_kernel_to_torch(node["kernel"]))
            if "bias" in node:
                sd[f"{key}.bias"] = _f32(node["bias"])
        elif "scale" in node:  # BatchNorm
            sd[f"{key}.weight"] = _f32(node["scale"])
            sd[f"{key}.bias"] = _f32(node["bias"])
        elif "alpha" in node:  # PReLU
            sd[f"{key}.alpha"] = _f32(node["alpha"])
        else:
            sd.update(params_from_jax(node, key + "."))
    return sd


def batch_stats_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax batch_stats tree (``.../bn/mean``, ``.../bn/var``) -> the BN
    buffers of the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if "mean" in node:
            sd[f"{key}.running_mean"] = _f32(node["mean"])
            sd[f"{key}.running_var"] = _f32(node["var"])
        else:
            sd.update(batch_stats_from_jax(node, key + "."))
    return sd


def variables_from_jax(params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any] | None = None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` -> one state_dict."""
    return {**params_from_jax(params), **batch_stats_from_jax(batch_stats or {})}


_STATS = {"running_mean": "mean", "running_var": "var"}


def variables_to_jax(state_dict: Mapping[str, torch.Tensor]):
    """Inverse for the standard (conv, bn, prelu) layout: state_dict ->
    (params, batch_stats), flax trees of fp32 numpy arrays (OIHW -> HWIO)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        tree = params
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and path[-1:] == ["bn"]:
            leaf = "scale"
        elif leaf in _STATS:
            tree, leaf = stats, _STATS[leaf]
        elif leaf not in ("bias", "alpha"):
            raise ValueError(f"no flax counterpart for {key!r}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return params, stats


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``variables_to_jax`` for a model without BatchNorm: the params tree."""
    params, stats = variables_to_jax(state_dict)
    if stats:
        raise ValueError("state_dict holds BatchNorm statistics: use variables_to_jax")
    return params
