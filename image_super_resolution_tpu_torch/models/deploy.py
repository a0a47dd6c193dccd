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
  A model with its own output map (``to_uint8``: ``rcan``,
  ``models/rcan.py``, ``y + 255 mean`` clamped and rounded; ``basicvsr``,
  ``models/basicvsr.py``, ``255 y`` clamped and rounded) is mapped with
  it, the others with ``tanh_to_uint8``. ``basicvsr`` is a sequence model:
  a call takes one segment of frames (T, H, W, 3) and returns its T
  frames. Every family but the optimized ``sr`` commits its params in the
  compute dtype.
- ``build_deployed`` turns a training checkpoint into a ``DeployedModel``:
  EMA weights unless ``use_ema=False`` (``cli/export.py --no_ema``), BN
  folded (``ops/fuse.py``), mean/std from the checkpoint's meta.
- ``save_artifact``/``load_artifact`` read and write the ``.isr`` file that
  the JAX package writes, with ``msgpack`` alone: ``{"spec": json,
  "params": fp16 tree, "format_version": 1}``, each array a msgpack ext
  type 1 whose payload is ``msgpack.packb((shape, dtype_name, C-order
  bytes))`` -- flax's own ndarray encoding.
- ``export_program``/``load_program`` write and read a ``torch.export``
  program (``.pt2``) of the whole uint8 -> uint8 request, the port's
  counterpart of the JAX package's StableHLO export. Each hand-written
  kernel's call is one node of it (the ops ``isr::scatter_rdb``,
  ``isr::ca_residual``), so the loaded program launches the kernels on
  the card.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.transforms import (IMAGENET_MEAN, IMAGENET_STD, normalize,
                               tanh_to_uint8, to_float01)
from ..interop.from_jax import params_from_jax, params_to_jax
from ..ops.fuse import fuse_conv_bn
from ..utils.profiling import annotate
from ..utils.serialization import (map_tree, msgpack_restore, msgpack_serialize,
                                   to_fp16, to_fp32)
from .basicvsr import BasicVSR
from .denoiser import Denoiser, LegacyDenoiser
from .fast import FastSRGenerator
from .generator import SRGenerator
from .optimized import OptimizedSRGenerator, optimize_generator_params
from .rcan import RCAN

FAMILIES = ("sr", "fast", "denoise", "denoise_fast", "denoise_legacy", "rcan", "basicvsr")

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
# The same for the Winograd trunk (``wino_m``) of an sr x4 artifact at full
# depth 16, against the fp32 direct path: bf16 F(2,3) measured on the CPU
# at most 4 on one 96x96 input for each of weight seeds 0-2 (the direct
# bf16 path 3-4 there; tests/test_torch_deploy.py pins seed 0), one more for
# the card; fp32 F(4,3) at most 1 there, one more for the card.
WINO_BF16_MAX_LSB = 5
WINO_FP32_MAX_LSB = 2
# The same for a fast x4 artifact at full depth 14, width 128: measured on
# the CPU at most 2 (tests/test_torch_fast.py), one more for the card.
FAST_BF16_MAX_LSB = 3
# The same for a denoise artifact at full depth 16, width 64: measured on
# the CPU at most 1 over four weight seeds (tests/test_torch_denoiser.py),
# one more for the card.
DENOISE_BF16_MAX_LSB = 2


def family_defaults(family: str, rs_deep=None, width=None) -> Tuple[int, int]:
    """Resolve (depth, width) CLI defaults per model family (``rcan``: its
    residual groups and features; ``basicvsr``: its residual blocks a
    branch, ``DeploySpec.blocks``, and features)."""
    fast = family in ("fast", "denoise_fast")
    if rs_deep is None:
        rs_deep = {"rcan": 10, "basicvsr": 30}.get(family, 14 if fast else 16)
    if width is None:
        width = 128 if fast else 64
    return rs_deep, width


def infer_family_dims(params, family: str):
    """(depth, width) read from a checkpoint's param TREE, or (None, None)."""
    prefixes = {"sr": ("rrdb", 1), "fast": ("block", 1),
                "denoise_fast": ("block", 1),
                "denoise": ("res0_", 2), "denoise_legacy": ("res", 1),
                "rcan": ("group", 1), "basicvsr": ("block", 1)}
    try:
        prefix, per_unit = prefixes[family]
        tree = params["backward_trunk"] if family == "basicvsr" else params
        depth = per_unit * sum(1 for k in tree
                               if str(k).startswith(prefix))
        head = tree["conv_in"] if family == "basicvsr" else params["head"]
        width = int(head["conv"]["kernel"].shape[-1])
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

    family: str = "sr"  # one of FAMILIES: sr, fast, denoise, denoise_fast, denoise_legacy, rcan, basicvsr
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
    # rcan: RCABs per residual group (``depth`` counts the groups) and the
    # channel attention's reduction; basicvsr: residual blocks a branch
    # (``depth`` unused). The port's own fields: an ``.isr`` file holds them
    # only where they differ from these defaults.
    blocks: int = 20
    reduction: int = 16

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
        if self.family == "basicvsr":
            return BasicVSR(width=self.width, blocks=self.blocks, scale=self.scale,
                            dtype=dtype, device=device)
        if self.family == "rcan":
            return RCAN(groups=self.depth, blocks=self.blocks, width=self.width,
                        reduction=self.reduction, scale=self.scale, dtype=dtype,
                        device=device)
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
    the scatter-form RDBs need ``dtype=torch.bfloat16``. ``wino_m`` 2 or 4
    runs the optimized graph's RDB convs as Winograd F(wino_m, 3) on any
    device and dtype, the JAX option of that name (F(4,3) is for fp32: its
    transforms amplify bf16 rounding); the fused kernel is then not
    launched. The other families have no rewrite; their params are
    committed in ``dtype`` once, here.
    """

    def __init__(self, spec: DeploySpec, fused_params: Mapping[str, Any],
                 dtype=torch.bfloat16, device="cuda", optimize: bool = True,
                 wino_m: int = 0, tail_fold: int = 0):
        _check_family(spec.family)
        self.spec = spec
        self.dtype = dtype
        self.device = resolve_device(device)
        self.optimized = bool(optimize and spec.family == "sr"
                              and spec.scale in (2, 4))
        self.wino_m = wino_m if self.optimized else 0
        if self.optimized:
            tail_fold = tail_fold or (2 if spec.scale == 4 else 1)
            params = optimize_generator_params(fused_params, wino_m=wino_m,
                                               tail_fold=tail_fold)
            model = OptimizedSRGenerator(
                depth=spec.depth, add_rate=spec.add_rate, scale=spec.scale,
                width=spec.width, enchant=spec.enchant, wino_m=wino_m,
                tail_fold=tail_fold, dtype=dtype, device=self.device)
        else:
            params = fused_params
            model = spec.build_model(dtype, self.device)
        model.load_state_dict(params_from_jax(params))
        self.model = model.eval()
        self._mean = tuple(float(v) for v in spec.mean)
        self._std = tuple(float(v) for v in spec.std)
        self._build = (fused_params, optimize, wino_m, tail_fold)

    def replica(self, device) -> "DeployedModel":
        """The same model on ``device``, built from the same fused params
        and options (the serving paths over several devices hold one per
        device)."""
        fused_params, optimize, wino_m, tail_fold = self._build
        return DeployedModel(self.spec, fused_params, self.dtype, device, optimize,
                             wino_m, tail_fold)

    @torch.inference_mode()
    def __call__(self, u8_batch) -> torch.Tensor:
        """uint8 NHWC (numpy or tensor) -> uint8 NHWC tensor on the device.
        The spans ``model/upload`` and ``model/forward`` (its host dispatch)."""
        x = upload(u8_batch, self.device)
        with annotate("model/forward"):
            return to_uint8(self.model, self.model(normalize(x, self._mean, self._std)),
                            self._mean)


def to_uint8(model: torch.nn.Module, y: torch.Tensor, mean) -> torch.Tensor:
    """The model's output map: its own ``to_uint8`` where it has one
    (``rcan``), else ``tanh_to_uint8``."""
    own = getattr(model, "to_uint8", None)
    return own(y, mean) if own is not None else tanh_to_uint8(y)


def upload(u8_batch, device: torch.device) -> torch.Tensor:
    """The batch as a tensor on ``device``: the span ``model/upload`` when
    it is a host array or a tensor on another device, nothing when it is a
    tensor there already (the engine's video path uploads before the call)."""
    x = u8_batch
    if (isinstance(x, torch.Tensor) and x.device.type == device.type
            and device.index in (None, x.device.index)):
        return x.to(device)
    with annotate("model/upload"):
        return torch.as_tensor(x).to(device)


class _Program(torch.nn.Module):
    """``DeployedModel.__call__`` as one module, for ``torch.export``: the
    same ops, with mean and std as buffers."""

    def __init__(self, deployed: DeployedModel):
        super().__init__()
        self.model = deployed.model
        kw = dict(dtype=torch.float32, device=deployed.device)
        self.register_buffer("mean", torch.tensor(deployed._mean, **kw))
        self.register_buffer("std", torch.tensor(deployed._std, **kw))

    def forward(self, u8: torch.Tensor) -> torch.Tensor:
        return to_uint8(self.model, self.model((to_float01(u8) - self.mean) / self.std),
                        self.mean)


def export_program(deployed: DeployedModel, batch: int, height: int, width: int,
                   out_path: str | Path, polymorphic: bool = False) -> None:
    """Write the request (uint8 NHWC -> uint8 NHWC: normalize, the model,
    the family's output map) as a ``torch.export`` program on the model's
    device. Each hand-written kernel's call is one ``isr::`` node.

    Static: for a (batch, height, width, 3) input. ``polymorphic=True``:
    N, H and W are ``torch.export.Dim``s, the counterpart of the JAX
    package's symbolic StableHLO dims. For ``downshuffle > 1`` H and W are
    constrained to multiples of the factor, as JAX constrains them: the
    edge pad of other sizes is shape arithmetic an export cannot keep
    symbolic. The ``denoise`` family's H and W are even: its stride-2 trunk
    comes back through a x2 pixel shuffle onto the full-size skip. A
    Winograd model's (``wino_m``) are multiples of ``wino_m``: the program
    keeps the tiling of the size it was traced at. Load with
    ``load_program``.
    """
    f = 2 if deployed.spec.family == "denoise" else deployed.spec.downshuffle or 1
    f = deployed.wino_m or f
    dynamic = None
    if polymorphic:
        Dim = torch.export.Dim
        hdim, wdim = (f * Dim("h_f"), f * Dim("w_f")) if f > 1 else (Dim("h"), Dim("w"))
        dynamic = ({0: Dim("n"), 1: hdim, 2: wdim},)
        # sizes 0 and 1 would specialize a dim: trace at two or more
        batch = max(batch, 2)
        height, width = (f * max(2, -(-v // f)) for v in (height, width))
    x = torch.zeros((batch, height, width, 3), dtype=torch.uint8, device=deployed.device)
    # Shape checks that the tracer cannot prove symbolically (stride
    # comparisons such as min(128w, 256w) == 128w, true for every w) stay in
    # the program as runtime asserts instead of failing the export.
    program = torch.export.export(_Program(deployed).eval(), (x,), dynamic_shapes=dynamic,
                                  strict=False,
                                  prefer_deferred_runtime_asserts_over_guards=polymorphic)
    torch.export.save(program, str(out_path))


def load_program(path: str | Path):
    """A program written by ``export_program``, as a callable module (uint8
    NHWC in, uint8 NHWC out) on the device it was exported on. Importing
    ``ops.kernels`` registers every ``isr::`` op before the program is read."""
    from ..ops import kernels  # noqa: F401  registers the isr:: ops

    return torch.export.load(str(path)).module()


# ------------------------------------------------------------ persistence --

# DeploySpec's fields that the JAX package's spec lacks, with their defaults
PORT_ONLY_FIELDS = {"blocks": DeploySpec.blocks, "reduction": DeploySpec.reduction}


def save_artifact(path: str | Path, spec: DeploySpec,
                  fused_params: Mapping[str, Any]) -> None:
    """Write ``fused_params`` (flax tree of numpy arrays) as an ``.isr``."""
    fields = asdict(spec)
    for name, default in PORT_ONLY_FIELDS.items():
        if fields[name] == default:
            del fields[name]
    payload = {  # keys in sorted order, as flax writes them
        "format_version": 1,
        "params": map_tree(to_fp16, fused_params),
        "spec": json.dumps(fields),
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
