"""The system under test, built from a configuration file: the port's
``DeployedModel`` over the benchmark's seeded weights, and for
``"precision": "int8"`` its post-training quantization
(``models/quantized.quantize_deployed``, max-calibrated) on the traffic's
own calibration batches. Every key of the configuration that names a
``DeploySpec`` field (``family``, ``depth``, ``width``, ``scale``,
``downshuffle``, ``refine_blocks``, ...) or a ``DeployedModel`` option
(``optimize``, ``wino_m``, ``tail_fold``) is passed on; the rest describe.
Everything the port derives from the weights (the optimized graph, folded
tail, scales, quantized and K-major weights) it derives here, in set-up.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List

import numpy as np
import torch


def deploy_arguments(config: dict) -> tuple:
    """(``DeploySpec`` keyword arguments, ``DeployedModel`` options) that the
    configuration holds."""
    from image_super_resolution_tpu_torch.models.deploy import DeployedModel, DeploySpec

    fields = {f.name for f in dataclasses.fields(DeploySpec)}
    spec = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items() if k in fields}
    options = set(inspect.signature(DeployedModel.__init__).parameters) - {
        "self", "spec", "fused_params", "dtype", "device"}
    return spec, {k: v for k, v in config.items() if k in options}


def build(config: dict, weights: Dict[str, torch.Tensor], calibration: List[np.ndarray],
          device: torch.device):
    """The deployed model (``__call__``: uint8 NHWC -> uint8 NHWC on the
    device). The weights' names and shapes must be the serving graph's."""
    from image_super_resolution_tpu_torch.interop.from_jax import params_to_jax
    from image_super_resolution_tpu_torch.models.deploy import DeployedModel, DeploySpec

    if device.type == "cuda":
        # Every kernel source of the port, built at fixed paths inside the
        # checkout (build/kernels/): only a checkout's first run compiles.
        from image_super_resolution_tpu_torch.ops.kernels import _build

        _build.build(*sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    spec, options = deploy_arguments(config)
    s = DeploySpec(**spec)
    want = {k: tuple(v.shape) for k, v in s.build_model(device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in weights.items()}
    if want != got:
        raise ValueError(f"weights do not match the {s.family} serving graph: "
                         f"{sorted(set(want.items()) ^ set(got.items()))[:6]}")
    deployed = DeployedModel(s, params_to_jax(weights), dtype=getattr(torch, config["dtype"]),
                             device=device, **options)
    if config["precision"] == "int8":
        from image_super_resolution_tpu_torch.models.quantized import quantize_deployed

        deployed = quantize_deployed(deployed, calibration)
    elif config["precision"] != config["dtype"]:
        raise ValueError(f"unknown precision {config['precision']!r}")
    return deployed
