"""The weight bridge: the JAX package's param trees <-> the port's modules.

A flax param tree (nested dicts of numpy arrays, as an ``.isr`` artifact
stores it) maps onto the port's ``state_dict`` by name: flax path
``rrdb0/rdb1/conv2/conv/kernel`` is ``rrdb0.rdb1.conv2.conv.weight``.

- conv kernels go HWIO -> OIHW (``transpose(3, 2, 0, 1)``), biases as they are;
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


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax param tree of numpy arrays -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if not isinstance(node, Mapping):
            raise ValueError(f"unexpected leaf {key!r} outside a conv or scatter node")
        if "sx" in node:
            mats = scatter_params_to_matmul(node, dtype=torch.float32)
            sd.update({f"{key}.{k}": t for k, t in zip(_SCATTER_KEYS, mats)})
        elif "kernel" in node:
            sd[f"{key}.weight"] = torch.from_numpy(conv_kernel_to_torch(node["kernel"]))
            if "bias" in node:
                sd[f"{key}.bias"] = torch.from_numpy(
                    np.array(node["bias"], np.float32))
        else:
            sd.update(params_from_jax(node, key + "."))
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse for the standard (conv-only) layout: state_dict -> flax tree
    of fp32 numpy arrays (OIHW -> HWIO)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif leaf != "bias":
            raise ValueError(f"no flax counterpart for {key!r}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
