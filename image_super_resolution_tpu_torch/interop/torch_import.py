"""Import reference PyTorch artifacts (counterpart of the JAX package's
``interop/torch_import.py``).

Three kinds of reference artifact are read:

1. **TorchScript deployment artifacts** (``model.pt``: ``Normalize`` ->
   net -> ``TanhToArrayImage``, reference utils/models.py:723-761,
   801-802). ``torch.jit.load`` needs no reference code.
   ``import_torchscript_artifact`` reads the state_dict, detects the
   family from its key layout and returns a ``DeployedModel`` with the
   spec and params for ``save_artifact``. The reference's bundled
   ``model.pt`` (the legacy denoiser) maps onto ``LegacyDenoiser``.
2. **Training checkpoints** (``{res|gen|denoise}_*.pt``): ``torch.save``
   pickles of whole fp16 modules, so unpickling needs the reference classes
   (``state_dict_from_reference_checkpoint``, given the reference repo's
   path). The per-family mappers turn a state_dict into the flax-layout
   (params, batch_stats) trees that the rest of the port reads.
3. **RCAN state dicts** in the layout of RCAN's own source
   (``import_rcan_state``), as its published checkpoints hold them, and
   **BasicVSR state dicts** in BasicSR's layout (``import_basicvsr_state``).

Every mapper returns nested dicts of numpy arrays in the JAX package's
layout, so ``save_artifact`` writes the JAX package's ``.isr`` and
``interop/from_jax.params_from_jax`` loads them into the port's modules.

Layout rules:
- conv weight OIHW -> HWIO: ``transpose(2, 3, 1, 0)``;
- linear weight (out, in) -> (in, out); a linear that consumes a flattened
  feature map also has its input axis permuted from torch's C-major
  (C, H, W) flattening to NHWC's (H, W, C);
- BatchNorm weight/bias/running_mean/running_var -> ``bn/scale``,
  ``bn/bias`` and the batch_stats ``bn/mean``, ``bn/var``;
- a fused reference conv (after ``fuse()``) carries a bias and a vestigial
  ``store_bn``, already folded in and ignored.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------- loading ----

def _numpy_state_dict(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().numpy() if v.dtype.is_floating_point
            else v.detach().numpy()
            for k, v in sd.items()}


def torchscript_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """state_dict of a TorchScript artifact as fp32 numpy, no class deps."""
    return _numpy_state_dict(torch.jit.load(str(path), map_location="cpu").state_dict())


def state_dict_from_reference_checkpoint(path: str | Path, reference_root: str | Path,
                                         key: str = "ema") -> Dict[str, np.ndarray]:
    """A state_dict from a reference *training* checkpoint.

    Reference checkpoints pickle whole modules (train.py:294-302), so torch
    needs the reference package importable to unpickle them. ``key`` picks
    the stored module: ``ema`` (the export's default), ``gen_net``,
    ``dis_net`` or ``model``. SECURITY: unpickling executes code from
    ``reference_root``; only point this at a checkout you trust.
    """
    root = str(Path(reference_root).resolve())
    added = root not in sys.path
    if added:
        sys.path.insert(0, root)
    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    finally:
        if added:
            sys.path.remove(root)
    module = ckpt[key] if isinstance(ckpt, dict) else ckpt
    if hasattr(module, "float"):
        module = module.float()  # checkpoints are stored fp16
    return _numpy_state_dict(module.state_dict() if hasattr(module, "state_dict")
                             else module)


# ------------------------------------------------------------ primitives ----

def conv_kernel_to_flax(w_oihw: np.ndarray) -> np.ndarray:
    """torch Conv2d OIHW -> flax HWIO."""
    return np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0))


def linear_to_flax(w: np.ndarray,
                   feature_hwc: Optional[Tuple[int, int, int]] = None) -> np.ndarray:
    """torch Linear (out, in) -> flax (in, out). ``feature_hwc=(H, W, C)``
    declares a flattened feature map as input: its columns go from torch's
    (C, H, W) order to (H, W, C)."""
    if feature_hwc is not None:
        h, w_, c = feature_hwc
        out = w.shape[0]
        w = w.reshape(out, c, h, w_).transpose(0, 2, 3, 1).reshape(out, h * w_ * c)
    return np.ascontiguousarray(w.T)


def _conv_params(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    entry = {"kernel": conv_kernel_to_flax(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        entry["bias"] = np.ascontiguousarray(sd[f"{prefix}.bias"])
    return entry


def _block(sd: Dict[str, np.ndarray], tprefix: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One reference Conv/ConvWithoutBN (prefix without the trailing
    ``.conv``) -> a ConvBlock subtree: ({params}, {batch_stats})."""
    params: Dict[str, Any] = {"conv": _conv_params(sd, f"{tprefix}.conv")}
    stats: Dict[str, Any] = {}
    if f"{tprefix}.bn.weight" in sd:  # unfused BN
        params["bn"] = {"scale": sd[f"{tprefix}.bn.weight"], "bias": sd[f"{tprefix}.bn.bias"]}
        stats["bn"] = {"mean": sd[f"{tprefix}.bn.running_mean"],
                       "var": sd[f"{tprefix}.bn.running_var"]}
    return params, stats


def _residual_block(sd: Dict[str, np.ndarray], tprefix: str):
    """Reference ResidualBlock1 (``m.0``/``m.1``) -> ResidualBlock
    (``conv0``/``conv1``)."""
    p0, s0 = _block(sd, f"{tprefix}.m.0")
    p1, s1 = _block(sd, f"{tprefix}.m.1")
    return {"conv0": p0, "conv1": p1}, {k: v for k, v in (("conv0", s0), ("conv1", s1)) if v}


def _looks_fused(sd: Dict[str, np.ndarray], tprefix: str) -> bool:
    """A reference Conv that went through fuse(): bias present, BN swapped
    to store_bn (utils/models.py:103-106)."""
    return (f"{tprefix}.conv.bias" in sd and f"{tprefix}.bn.weight" not in sd
            and f"{tprefix}.store_bn.weight" in sd)


# ------------------------------------------------------------- families ----

def import_generator_state(sd: Dict[str, np.ndarray], prefix: str = ""):
    """Reference ResNet/EResNet state_dict -> SRGenerator (params,
    batch_stats, config).

    Key layout (utils/models.py:592-650): ``conv0`` head,
    ``residual.{i}.net.{j}.conv{k}|conv`` RRDB trunk, ``conv1`` trunk conv,
    ``scaler.{s}.net.0`` upsamplers, ``conv2`` tail. SRGAN checkpoints
    prefix everything with ``res_net.``: pass ``prefix="res_net."``.
    """
    g = lambda k: f"{prefix}{k}"
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["head"], _ = _block(sd, g("conv0"))

    depth = 0
    while f"{g(f'residual.{depth}')}.net.0.conv0.conv.weight" in sd:
        depth += 1
    for i in range(depth):
        rrdb_p: Dict[str, Any] = {}
        rrdb_s: Dict[str, Any] = {}
        for j in range(3):
            rdb_p: Dict[str, Any] = {}
            rdb_s: Dict[str, Any] = {}
            for name, ref in [(f"conv{k}", f"conv{k}") for k in range(4)] + [("conv_fuse", "conv")]:
                p, s = _block(sd, g(f"residual.{i}.net.{j}.{ref}"))
                rdb_p[name] = p
                if s:
                    rdb_s[name] = s
            rrdb_p[f"rdb{j}"] = rdb_p
            if rdb_s:
                rrdb_s[f"rdb{j}"] = rdb_s
        params[f"rrdb{i}"] = rrdb_p
        if rrdb_s:
            stats[f"rrdb{i}"] = rrdb_s

    p, s = _block(sd, g("conv1"))
    params["trunk_conv"] = p
    if s:
        stats["trunk_conv"] = s

    n_up = 0
    while f"{g(f'scaler.{n_up}')}.net.0.conv.weight" in sd:
        params[f"up{n_up}"] = {"conv": _block(sd, g(f"scaler.{n_up}.net.0"))[0]}
        n_up += 1

    params["tail"], _ = _block(sd, g("conv2"))

    fused = _looks_fused(sd, g("conv1"))
    config = {
        "depth": depth,
        "scale": 2 ** n_up if n_up else 1,
        "width": sd[g("conv0") + ".conv.weight"].shape[0],
        "enchant": bool(f"{g('conv1')}.bn.weight" not in sd and not fused),
        "fused": fused,
    }
    return params, stats, config


def import_discriminator_state(sd: Dict[str, np.ndarray], prefix: str = "",
                               pooled_hw: Tuple[int, int] = (6, 6)):
    """Reference Discriminator state_dict -> (params, batch_stats).

    Layout (utils/models.py:513-555): ``conv_blocks.{i}`` convs, ``fc1.0``
    and ``fc2`` linears. fc1 consumes the 6x6 adaptive-pooled feature map,
    so its kernel gets the CHW -> HWC input permutation.
    """
    g = lambda k: f"{prefix}{k}"
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    i = 0
    out_ch = 0
    while f"{g(f'conv_blocks.{i}')}.conv.weight" in sd:
        p, s = _block(sd, g(f"conv_blocks.{i}"))
        params[f"block{i}"] = p
        if s:
            stats[f"block{i}"] = s
        out_ch = sd[g(f"conv_blocks.{i}") + ".conv.weight"].shape[0]
        i += 1
    h, w = pooled_hw
    params["fc1"] = {"dense": {"kernel": linear_to_flax(sd[g("fc1.0.weight")], (h, w, out_ch)),
                               "bias": sd[g("fc1.0.bias")]}}
    params["fc2"] = {"dense": {"kernel": linear_to_flax(sd[g("fc2.weight")]),
                               "bias": sd[g("fc2.bias")]}}
    return params, stats


def import_denoiser_state(sd: Dict[str, np.ndarray], prefix: str = ""):
    """Reference Denoise (current revision, utils/models.py:672-706) ->
    Denoiser (params, batch_stats, config)."""
    g = lambda k: f"{prefix}{k}"
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["head"], _ = _block(sd, g("conv0.0"))

    def run(seq_key: str, out_name: str) -> int:
        n = 0
        while f"{g(f'{seq_key}.{n}')}.m.0.conv.weight" in sd:
            p, s = _residual_block(sd, g(f"{seq_key}.{n}"))
            params[f"{out_name}{n}"] = p
            if s:
                stats[f"{out_name}{n}"] = s
            n += 1
        return n

    n0 = run("residual_0", "res0_")
    params["down"], _ = _block(sd, g("residual_conv0"))
    run("residual_1", "res1_")
    run("residual_2", "res2_")
    p, s = _block(sd, g("conv1"))
    params["trunk_conv"] = p
    if s:
        stats["trunk_conv"] = s
    params["tail"], _ = _block(sd, g("conv2.0"))
    config = {"depth": n0 * 2, "width": sd[g("conv0.0") + ".conv.weight"].shape[0],
              "fused": _looks_fused(sd, g("conv1"))}
    return params, stats, config


def import_legacy_denoiser_state(sd: Dict[str, np.ndarray], prefix: str = ""):
    """The bundled model.pt's older Denoise revision (no down/up trunk,
    ``residual.{i}`` blocks) -> LegacyDenoiser (params, config)."""
    g = lambda k: f"{prefix}{k}"
    params: Dict[str, Any] = {}
    params["head"], _ = _block(sd, g("conv0.0"))
    depth = 0
    while f"{g(f'residual.{depth}')}.m.0.conv.weight" in sd:
        params[f"res{depth}"], _ = _residual_block(sd, g(f"residual.{depth}"))
        depth += 1
    params["trunk_conv"], _ = _block(sd, g("conv1"))
    params["tail"], _ = _block(sd, g("conv2.0"))
    config = {"depth": depth, "width": sd[g("conv0.0") + ".conv.weight"].shape[0],
              "hidden": sd[g("residual.0") + ".m.0.conv.weight"].shape[0]}
    return params, config


def import_rcan_state(sd: Dict[str, np.ndarray], mean: Tuple[float, float, float] | None = None,
                      prefix: str = ""):
    """A state_dict in the layout of RCAN's source (``model/rcan.py`` of
    RCAN_TrainCode and of EDSR-PyTorch, as its published checkpoints such as
    ``RCAN_BIX4.pt`` hold it) -> the port's ``rcan`` (spec, params tree).

    ``head.0`` -> ``head``; ``body.{g}.body.{b}.body.{0,2}`` -> ``group{g}/
    block{b}/conv{0,1}``; ``body.{g}.body.{b}.body.3.conv_du.{0,2}`` ->
    ``ca_down``, ``ca_up``; ``body.{g}.body.{blocks}`` -> ``group{g}/conv``;
    ``body.{groups}`` -> ``trunk_conv``; ``tail.0.{2u}`` -> ``up{u}``;
    ``tail.1`` -> ``tail``. Sizes are read from the shapes. ``sub_mean`` and
    ``add_mean`` are not loaded: they are checked to be the shift by 255
    ``mean`` (``models/rcan.RCAN_MEAN`` by default) with unit std, which the
    spec's normalize and output map apply."""
    from ..models.deploy import DeploySpec
    from ..models.rcan import RCAN_MEAN, RCAN_STD

    mean = tuple(RCAN_MEAN if mean is None else mean)
    sd = {k[len(prefix):]: np.asarray(v, np.float32) for k, v in sd.items()
          if k.startswith(prefix)}
    shift = 255.0 * np.asarray(mean, np.float32)
    for name, sign in (("sub_mean", -1.0), ("add_mean", 1.0)):
        if f"{name}.weight" not in sd:
            continue
        if not (np.allclose(sd[f"{name}.weight"].reshape(3, 3), np.eye(3), atol=1e-6)
                and np.allclose(sd[f"{name}.bias"], sign * shift, atol=1e-3)):
            raise ValueError(f"{name} is not the shift by {sign:+.0f} x 255 x {mean} with "
                             f"unit std: bias {sd[f'{name}.bias'].tolist()}")
    groups = sum(1 for k in sd if k.startswith("body.") and k.endswith(".body.0.body.0.weight")
                 and k.count(".") == 6)
    blocks = sum(1 for k in sd if k.startswith("body.0.body.") and k.endswith(".body.0.weight"))
    n_up = sum(1 for k in sd if k.startswith("tail.0.") and k.endswith(".weight"))
    if not groups or not blocks or not n_up:
        raise ValueError(f"not an RCAN state_dict: sample keys {sorted(sd)[:5]}")
    width = sd["head.0.weight"].shape[0]
    hidden = sd["body.0.body.0.body.3.conv_du.0.weight"].shape[0]
    params: Dict[str, Any] = {"head": {"conv": _conv_params(sd, "head.0")}}
    for g in range(groups):
        group: Dict[str, Any] = {"conv": {"conv": _conv_params(sd, f"body.{g}.body.{blocks}")}}
        for b in range(blocks):
            t = f"body.{g}.body.{b}.body"
            group[f"block{b}"] = {
                "conv0": {"conv": _conv_params(sd, f"{t}.0")},
                "conv1": {"conv": _conv_params(sd, f"{t}.2")},
                "ca_down": {"conv": _conv_params(sd, f"{t}.3.conv_du.0")},
                "ca_up": {"conv": _conv_params(sd, f"{t}.3.conv_du.2")}}
        params[f"group{g}"] = group
    params["trunk_conv"] = {"conv": _conv_params(sd, f"body.{groups}")}
    for u in range(n_up):
        params[f"up{u}"] = {"conv": _conv_params(sd, f"tail.0.{2 * u}")}
    params["tail"] = {"conv": _conv_params(sd, "tail.1")}
    spec = DeploySpec(family="rcan", depth=groups, blocks=blocks, width=width,
                      reduction=width // hidden, scale=2 ** n_up, mean=mean, std=RCAN_STD)
    return spec, params


def import_basicvsr_state(sd: Dict[str, np.ndarray], prefix: str = ""):
    """A state_dict in the layout of BasicSR's ``BasicVSR``
    (``basicsr/archs/basicvsr_arch.py``, as its published
    ``BasicVSR_REDS4.pth`` holds it under ``params``) -> the port's
    ``basicvsr`` (spec, params tree).

    ``spynet.basic_module.{l}.basic_module.{0,2,4,6,8}`` ->
    ``spynet/level{l}/conv{0..4}``; ``{backward,forward}_trunk.main.0`` ->
    ``{backward,forward}_trunk/conv_in``; ``..._trunk.main.2.{b}.conv{1,2}``
    -> ``..._trunk/block{b}/conv{0,1}``; ``fusion``, ``upconv1`` -> ``up0``,
    ``upconv2`` -> ``up1``, ``conv_hr``, ``conv_last``. Widths and blocks
    are read from the shapes and checked against the architecture (six
    SPyNet levels of 8 -> 32 -> 64 -> 32 -> 16 -> 2, trunks of 3 + width
    inputs); SPyNet's ``mean``/``std`` buffers, where present, must be its
    ImageNet normalisation. A wrong layout raises ``ValueError``."""
    from ..models.basicvsr import (BASICVSR_MEAN, BASICVSR_STD, HR_WIDTH, SPYNET_LEVELS,
                                   SPYNET_MEAN, SPYNET_STD, SPYNET_WIDTHS)
    from ..models.deploy import DeploySpec

    sd = {k[len(prefix):]: np.asarray(v, np.float32) for k, v in sd.items()
          if k.startswith(prefix)}
    for name, want in (("mean", SPYNET_MEAN), ("std", SPYNET_STD)):
        got = sd.pop(f"spynet.{name}", None)
        if got is not None and not np.allclose(got.reshape(-1), want, atol=1e-6):
            raise ValueError(f"spynet.{name} is {got.reshape(-1).tolist()}, not SPyNet's {want}")
    if "backward_trunk.main.0.weight" not in sd:
        raise ValueError(f"not a BasicVSR state_dict: sample keys {sorted(sd)[:5]}")
    width, cin = sd["backward_trunk.main.0.weight"].shape[:2]
    blocks = sum(1 for k in sd if k.startswith("backward_trunk.main.2.")
                 and k.endswith(".conv1.weight"))
    layers = []  # (port name, source name, cin, cout, kernel)
    for level in range(SPYNET_LEVELS):
        layers += [(f"spynet/level{level}/conv{k}",
                    f"spynet.basic_module.{level}.basic_module.{2 * k}", ci, co, 7)
                   for k, (ci, co) in enumerate(zip(SPYNET_WIDTHS, SPYNET_WIDTHS[1:]))]
    for branch in ("backward_trunk", "forward_trunk"):
        layers.append((f"{branch}/conv_in", f"{branch}.main.0", 3 + width, width, 3))
        layers += [(f"{branch}/block{b}/conv{k}", f"{branch}.main.2.{b}.conv{k + 1}",
                    width, width, 3) for b in range(blocks) for k in (0, 1)]
    layers += [("fusion", "fusion", 2 * width, width, 1),
               ("up0", "upconv1", width, 4 * width, 3), ("up1", "upconv2", width, 4 * HR_WIDTH, 3),
               ("conv_hr", "conv_hr", HR_WIDTH, HR_WIDTH, 3),
               ("conv_last", "conv_last", HR_WIDTH, 3, 3)]
    want = {}
    for _, src, ci, co, k in layers:
        want[f"{src}.weight"], want[f"{src}.bias"] = (co, ci, k, k), (co,)
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if cin != 3 + width or got != want:
        off = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise ValueError(f"not BasicVSR's layout: conv_in takes {cin} channels for width "
                         f"{width}; keys missing, unknown or of another shape: {off[:4]}")
    params: Dict[str, Any] = {}
    for dst, src, *_ in layers:
        node = params
        for part in dst.split("/"):
            node = node.setdefault(part, {})
        node["conv"] = _conv_params(sd, src)
    spec = DeploySpec(family="basicvsr", blocks=blocks, width=width, scale=4,
                      mean=BASICVSR_MEAN, std=BASICVSR_STD)
    return spec, params


# ---------------------------------------------------- deployed artifacts ----

def import_torchscript_artifact(path: str | Path, dtype=torch.bfloat16, device="cuda"):
    """TorchScript deployment artifact (Normalize -> net -> TanhToArrayImage)
    -> ``DeployedModel`` on ``device``.

    Detects the inner net's family from the state-dict key layout and reads
    the baked normalization from the Normalize buffers (``net.0``). Returns
    (deployed, spec, params); pass spec and params to
    ``models.deploy.save_artifact`` for an ``.isr`` file.
    """
    from ..models.deploy import DeployedModel, DeploySpec

    sd = torchscript_state_dict(path)
    mean = tuple(float(v) for v in sd["net.0.mean"].reshape(-1))
    std = tuple(float(v) for v in sd["net.0.std"].reshape(-1))
    inner = {k[len("net.1."):]: v for k, v in sd.items() if k.startswith("net.1.")}

    if "residual.0.m.0.conv.weight" in inner:  # legacy denoiser (model.pt)
        params, cfg = import_legacy_denoiser_state(inner)
        spec = DeploySpec(family="denoise_legacy", depth=cfg["depth"], width=cfg["width"],
                          hidden=cfg["hidden"], scale=1, mean=mean, std=std)
    elif "residual_0.0.m.0.conv.weight" in inner:  # current denoiser
        params, _, cfg = import_denoiser_state(inner)
        if not cfg["fused"]:
            raise ValueError("deployment artifact expected fused convs")
        spec = DeploySpec(family="denoise", depth=cfg["depth"], width=cfg["width"],
                          scale=1, mean=mean, std=std)
    elif "residual.0.net.0.conv0.conv.weight" in inner:  # SR generator
        params, stats, cfg = import_generator_state(inner)
        if stats:
            raise ValueError("deployment artifact expected fused convs")
        spec = DeploySpec(family="sr", depth=cfg["depth"], width=cfg["width"],
                          scale=cfg["scale"], enchant=cfg["enchant"], mean=mean, std=std)
    else:
        raise ValueError(f"unrecognized TorchScript layout in {path}: "
                         f"sample keys {sorted(inner)[:5]}")
    return DeployedModel(spec, params, dtype, device), spec, params
