"""Frozen deployment artifact: uint8 image in -> uint8 image out (counterpart
of the JAX package's ``models/deploy.py``).

- ``DeployedModel`` wraps ``normalize`` -> generator -> ``tanh_to_uint8``
  on one device. For ``sr`` at x2/x4 it builds the optimized graph
  (scatter-form RDBs through the fused kernel, folded tail); the weight
  transforms run once, at construction. The fast families (``fast``,
  ``denoise_fast``) serve their own graph (``models/fast.py``), whose
  training graph is already the serving graph; their int8 form is
  ``models/quantized.py``. The x1 denoisers (``denoise``,
  ``denoise_legacy``, ``models/denoiser.py``) serve their BN-folded graph.
  Every family but the optimized ``sr`` commits its params in the compute
  dtype.
- ``build_deployed`` turns a training checkpoint into a ``DeployedModel``:
  EMA weights unless ``use_ema=False`` (``cli/export.py --no_ema``), BN
  folded (``ops/fuse.py``), mean/std from the checkpoint's meta.
- ``save_artifact``/``load_artifact`` read and write the ``.isr`` file that
  the JAX package writes, with ``msgpack`` alone: ``{"spec": json,
  "params": fp16 tree, "format_version": 1}``, each array a msgpack ext
  type 1 whose payload is ``msgpack.packb((shape, dtype_name, C-order
  bytes))`` -- flax's own ndarray encoding.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize, tanh_to_uint8
from ..interop.from_jax import params_from_jax, params_to_jax
from ..ops.fuse import fuse_conv_bn
from ..utils.serialization import (map_tree, msgpack_restore, msgpack_serialize,
                                   to_fp16, to_fp32)
from .denoiser import Denoiser, LegacyDenoiser
from .fast import FastSRGenerator
from .generator import SRGenerator
from .optimized import OptimizedSRGenerator, optimize_generator_params

FAMILIES = ("sr", "fast", "denoise", "denoise_fast", "denoise_legacy")

# Largest uint8 difference allowed between a bf16 and an fp32 run of one
# sr x4 artifact at full depth 16. Measured on the CPU: 3
# (tests/test_torch_deploy.py); one more LSB leaves room for the card's own
# order of sums. Against the JAX DeployedModel (which rounds every conv
# output to bf16, where the port follows the Pallas kernel's fp32 sums
# inside each RDB) the measured difference at depth 1 is 1.
BF16_MAX_LSB = 4
# The same for sr at x2, depth 16: measured on the CPU at most 7 with random
# weights and inputs, where the JAX package's bf16 graph drifts from its
# fp32 one by the same 7 (tests/test_torch_deploy.py); one more for the
# card.
BF16_X2_MAX_LSB = 8
# The same for a fast x4 artifact at full depth 14, width 128: measured on
# the CPU at most 2 (tests/test_torch_fast.py), one more for the card.
FAST_BF16_MAX_LSB = 3
# The same for a denoise artifact at full depth 16, width 64: measured on
# the CPU at most 1 over four weight seeds (tests/test_torch_denoiser.py),
# one more for the card.
DENOISE_BF16_MAX_LSB = 2


def family_defaults(family: str, rs_deep=None, width=None) -> Tuple[int, int]:
    """Resolve (depth, width) CLI defaults per model family."""
    fast = family in ("fast", "denoise_fast")
    if rs_deep is None:
        rs_deep = 14 if fast else 16
    if width is None:
        width = 128 if fast else 64
    return rs_deep, width


def infer_family_dims(params, family: str):
    """(depth, width) read from a checkpoint's param TREE, or (None, None)."""
    prefixes = {"sr": ("rrdb", 1), "fast": ("block", 1),
                "denoise_fast": ("block", 1),
                "denoise": ("res0_", 2), "denoise_legacy": ("res", 1)}
    try:
        prefix, per_unit = prefixes[family]
        depth = per_unit * sum(1 for k in params
                               if str(k).startswith(prefix))
        width = int(params["head"]["conv"]["kernel"].shape[-1])
    except Exception:
        return None, None
    return (depth, width) if depth > 0 and width > 0 else (None, None)


def infer_downshuffle(params) -> int | None:
    """The fast graph's sub-pixel front factor f, read from the tree: the
    head conv sees 3*f^2 input channels. None when the tree does not look
    like a fast family."""
    try:
        cin = int(params["head"]["conv"]["kernel"].shape[2])
    except Exception:
        return None
    if cin % 3:
        return None
    f = round((cin // 3) ** 0.5)
    return f if 3 * f * f == cin else None


def infer_refine(params) -> Tuple[int, int]:
    """(refine_blocks, refine_width) read from a fast-family tree: a
    ``refine_proj`` conv, ``refine0..refine{k-1}`` blocks, and a tail conv
    whose input width is the refine width. (0, 32), the spec's defaults,
    when the tree has no refinement stage."""
    if not isinstance(params, dict) or "refine_proj" not in params:
        return 0, 32
    blocks = sum(1 for k in params
                 if str(k).startswith("refine") and str(k)[6:].isdigit())
    width = int(params["tail"]["conv"]["kernel"].shape[2])
    return blocks, width


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}; one of {FAMILIES}")


@dataclass(frozen=True)
class DeploySpec:
    """Everything needed to rebuild the inference graph."""

    family: str = "sr"  # "sr" | "fast" | "denoise" | "denoise_fast" | "denoise_legacy"
    depth: int = 16
    width: int = 64
    add_rate: float = 0.2
    scale: int = 2
    enchant: bool = False
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    hidden: int = 0
    downshuffle: int = 1
    refine_blocks: int = 0
    refine_width: int = 32

    def build_model(self, dtype=torch.float32, device="cuda"):
        """The fused (BN-folded) serving graph of this family."""
        _check_family(self.family)
        if self.family == "denoise":
            return Denoiser(depth=self.depth, width=self.width, fused=True,
                            dtype=dtype, device=device)
        if self.family == "denoise_legacy":
            return LegacyDenoiser(depth=self.depth, width=self.width,
                                  hidden=self.hidden or 32, fused=True, dtype=dtype,
                                  device=device)
        if self.family in ("fast", "denoise_fast"):
            return FastSRGenerator(
                depth=self.depth, add_rate=self.add_rate, scale=self.output_scale,
                width=self.width, downshuffle=self.downshuffle or 1,
                refine_blocks=self.refine_blocks or 0,
                refine_width=self.refine_width or 32, dtype=dtype, device=device)
        return SRGenerator(depth=self.depth, add_rate=self.add_rate,
                           scale=self.scale, width=self.width,
                           enchant=self.enchant, fused=True, dtype=dtype,
                           device=device)

    @property
    def output_scale(self) -> int:
        return 1 if self.family.startswith("denoise") else self.scale


class DeployedModel:
    """uint8 NHWC -> uint8 NHWC super-resolver on one device.

    ``optimize=True`` (the default) builds the optimized graph for ``sr``
    at x2/x4 (``tail_fold`` 0 = auto: 2 for x4, 1 for x2). Artifacts store
    the standard fused layout; the transform happens here, once. On the card
    the scatter-form RDBs need ``dtype=torch.bfloat16``. The other families
    have no rewrite; their params are committed in ``dtype`` once, here.
    """

    def __init__(self, spec: DeploySpec, fused_params: Mapping[str, Any],
                 dtype=torch.bfloat16, device="cuda", optimize: bool = True,
                 tail_fold: int = 0):
        _check_family(spec.family)
        self.spec = spec
        self.dtype = dtype
        self.device = resolve_device(device)
        self.optimized = bool(optimize and spec.family == "sr"
                              and spec.scale in (2, 4))
        if self.optimized:
            tail_fold = tail_fold or (2 if spec.scale == 4 else 1)
            params = optimize_generator_params(fused_params, tail_fold=tail_fold)
            model = OptimizedSRGenerator(
                depth=spec.depth, add_rate=spec.add_rate, scale=spec.scale,
                width=spec.width, enchant=spec.enchant, tail_fold=tail_fold,
                dtype=dtype, device=self.device)
        else:
            params = fused_params
            model = spec.build_model(dtype, self.device)
        model.load_state_dict(params_from_jax(params))
        self.model = model.eval()
        self._mean = tuple(float(v) for v in spec.mean)
        self._std = tuple(float(v) for v in spec.std)

    @torch.inference_mode()
    def __call__(self, u8_batch) -> torch.Tensor:
        """uint8 NHWC (numpy or tensor) -> uint8 NHWC tensor on the device."""
        x = torch.as_tensor(u8_batch).to(self.device)
        return tanh_to_uint8(self.model(normalize(x, self._mean, self._std)))


# ------------------------------------------------------------ persistence --

def save_artifact(path: str | Path, spec: DeploySpec,
                  fused_params: Mapping[str, Any]) -> None:
    """Write ``fused_params`` (flax tree of numpy arrays) as an ``.isr``."""
    payload = {  # keys in sorted order, as flax writes them
        "format_version": 1,
        "params": map_tree(to_fp16, fused_params),
        "spec": json.dumps(asdict(spec)),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(payload))


def read_artifact(path: str | Path) -> Tuple[DeploySpec, Dict[str, Any]]:
    """(spec, params tree as stored: fp16 numpy arrays)."""
    payload = msgpack_restore(Path(path).read_bytes())
    spec_dict = json.loads(payload["spec"])
    spec_dict["mean"] = tuple(spec_dict["mean"])
    spec_dict["std"] = tuple(spec_dict["std"])
    return DeploySpec(**spec_dict), payload["params"]


def load_artifact(path: str | Path, dtype=torch.bfloat16,
                  device="cuda") -> DeployedModel:
    spec, params = read_artifact(path)
    return DeployedModel(spec, map_tree(to_fp32, params), dtype, device)


def init_fused_params(spec: DeploySpec, seed: int = 0) -> Dict[str, Any]:
    """Random fused-layout params for ``spec`` (flax tree of fp32 numpy
    arrays) from a numpy seed: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every
    kernel and bias, torch's default Conv2d init."""
    rng = np.random.default_rng(seed)
    shapes = spec.build_model(device="meta").state_dict()
    sd = {}
    for key, t in shapes.items():
        w = shapes[key.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / np.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
        sd[key] = torch.from_numpy(
            rng.uniform(-bound, bound, tuple(t.shape)).astype(np.float32))
    return params_to_jax(sd)


def build_deployed(ckpt: Mapping[str, Any], spec: DeploySpec, use_ema: bool = True,
                   dtype=torch.bfloat16,
                   device="cuda") -> Tuple[DeployedModel, Dict[str, Any]]:
    """Training checkpoint (``train/checkpoint.load_checkpoint``) -> fused
    ``DeployedModel`` and the fused params tree, as the reference export
    does it: EMA weights unless ``use_ema=False``, the dataset mean/std of
    the checkpoint's meta baked in, BN folded. Raw params go with the raw
    batch_stats, EMA params with the EMA statistics (also when a checkpoint
    without EMA falls back to its raw ones)."""
    use = use_ema and bool(ckpt.get("ema_params"))
    params = ckpt["ema_params"] if use else ckpt["params"]
    stats = (ckpt.get("ema_batch_stats") if use else ckpt.get("batch_stats")) or {}
    fused = fuse_conv_bn(params, stats)
    meta = ckpt.get("meta", {})
    if meta.get("mean") and meta.get("std"):
        spec = DeploySpec(**{**asdict(spec), "mean": tuple(meta["mean"]),
                             "std": tuple(meta["std"])})
    return DeployedModel(spec, fused, dtype, device), fused
