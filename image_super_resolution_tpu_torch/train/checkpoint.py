"""Checkpoint save, tolerant resume (counterpart of the JAX package's
``train/checkpoint.py``), in the JAX package's own file format, so each
package resumes the other's checkpoints, optimizer included.

- One file per phase, overwritten every epoch:
  ``{res|gen|denoise}_{save_name}_{rs_deep}_{add_rate}.ckpt``.
- A msgpack file in flax's encoding (``utils/serialization.py``):
  ``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats`` as fp16
  flax trees (HWIO kernels), ``ema_updates``, a JSON ``meta`` (epoch,
  dataset mean/std, the epoch's losses, step) and, except on the final
  epoch, the fp32 ``opt_state``.
- ``opt_state`` has the layout of ``flax.serialization.to_state_dict`` of
  the JAX package's optax chain: ``{"0": {}, "1": {"0": {"count", "mu",
  "nu"}, "1": {"count"}}}`` (clip, Adam, schedule), with an empty ``"1"``
  for the coupled L2 and Adam moved to ``"2"`` when ``--weight_decay > 0``.
- ``extra`` entries go in as they are: the GAN phase's discriminator
  (``discriminator_payload``: ``d_params`` and ``d_batch_stats`` in fp32,
  and, but on the final epoch, ``d_opt_state`` and ``d_step``).
- Written to ``<name>.tmp``, then renamed over the old file. An Orbax
  checkpoint directory at the path (a JAX ``--ckpt_backend orbax`` run) is
  first moved to ``<name>.old`` and removed after the rename, so the disk
  always holds a checkpoint; a stale ``<name>.old`` directory is removed.
- Resume restores every leaf whose path and shape match, and the optimizer
  and epoch only when all matched, by the reference's per-phase rules
  (``resume_state``; the discriminator: ``resume_discriminator``).
- The GAN phase starts its generator from the pixel phase's EMA weights
  (``warm_start_generator``).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..interop.from_jax import params_from_jax, variables_from_jax, variables_to_jax
from ..utils.general import intersect_trees
from ..utils.serialization import map_tree, msgpack_restore, msgpack_serialize, to_fp16, to_fp32
from .state import EMA, TrainState


def checkpoint_name(phase: str, save_name: str, depth: int, add_rate: float) -> str:
    prefix = {"pixel": "res", "gan": "gen", "denoise": "denoise"}[phase]
    return f"{prefix}_{save_name}_{depth}_{add_rate}.ckpt"


def checkpoint_exists(path: str | Path) -> bool:
    """The checkpoint file, or the Orbax directory a crashed JAX save left
    at ``<path>.old`` (which ``load_checkpoint`` refuses by name)."""
    p = Path(path)
    return p.exists() or p.with_name(p.name + ".old").is_dir()


def _adam_index(state: TrainState) -> str:
    return "2" if state.optimizer.param_groups[0]["weight_decay"] > 0 else "1"


def opt_state_to_jax(state: TrainState) -> Dict[str, Any]:
    """Adam's moments and counts as the optax chain's state dict."""
    names = {p: k for k, p in state.model.named_parameters()}
    mu, nu = {}, {}
    for p in state.params:
        st = state.optimizer.state.get(p, {})
        mu[names[p]] = st.get("exp_avg", torch.zeros_like(p))
        nu[names[p]] = st.get("exp_avg_sq", torch.zeros_like(p))
    count = np.asarray(state.step, np.int32)
    tree: Dict[str, Any] = {"0": {}}
    if _adam_index(state) == "2":
        tree["1"] = {}
    tree[_adam_index(state)] = {
        "0": {"count": count, "mu": variables_to_jax(mu)[0], "nu": variables_to_jax(nu)[0]},
        "1": {"count": count},
    }
    return tree


def opt_state_from_jax(state: TrainState, tree: Dict[str, Any]) -> None:
    """Restore Adam from the optax chain's state dict; raises ValueError or
    KeyError when the chain or the params differ from this state's."""
    want = {"0", "1", "2"} if _adam_index(state) == "2" else {"0", "1"}
    if set(tree) != want:
        raise ValueError(f"optimizer chain has entries {sorted(tree)}, want {sorted(want)}")
    adam = tree[_adam_index(state)]["0"]
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    fused = bool(state.optimizer.defaults.get("fused"))
    for name, p in state.model.named_parameters():
        m, v = mu[name], nu[name]
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"optimizer moment {name} has shape {tuple(m.shape)}, "
                             f"want {tuple(p.shape)}")
        state.optimizer.state[p] = {
            "step": torch.tensor(float(adam["count"]), dtype=torch.float32,
                                 device=p.device if fused else "cpu"),
            "exp_avg": m.to(p.device, p.dtype),
            "exp_avg_sq": v.to(p.device, p.dtype),
        }


def save_checkpoint(path: str | Path, state: TrainState, epoch: int, mean, std,
                    loss_history=None, final: bool = False,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    params, stats = variables_to_jax(state.model.state_dict())
    payload: Dict[str, Any] = {
        "params": map_tree(to_fp16, params),
        "batch_stats": map_tree(to_fp16, stats),
        "meta": json.dumps({
            "epoch": int(epoch),
            "mean": [float(v) for v in mean],
            "std": [float(v) for v in std],
            "loss": [float(v) for v in (loss_history or [])],
            "step": int(state.step),
        }),
    }
    e_params, e_stats = variables_to_jax(state.ema.state_dict())
    payload["ema_params"] = map_tree(to_fp16, e_params)
    payload["ema_batch_stats"] = map_tree(to_fp16, e_stats)
    payload["ema_updates"] = int(state.ema.updates)
    if not final:  # the reference drops the optimizer on the last epoch
        payload["opt_state"] = opt_state_to_jax(state)  # fp32: nu underflows fp16
    payload.update(extra or {})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(msgpack_serialize(payload))
    old = path.with_name(path.name + ".old")
    if path.is_dir():  # an Orbax checkpoint: a file cannot be renamed onto it
        if old.is_dir():
            shutil.rmtree(old)
        elif old.exists():
            old.unlink()
        path.rename(old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
        if old.is_dir():  # left by a crash inside an Orbax save; superseded now
            shutil.rmtree(old)


def discriminator_payload(d_state: TrainState, final: bool = False) -> Dict[str, Any]:
    """The GAN checkpoint's ``extra`` entries for D, as the JAX CLI writes
    them: fp32 ``d_params`` and ``d_batch_stats``, and, but on the final
    epoch, ``d_opt_state`` (the optax chain's state dict) and ``d_step``."""
    params, stats = variables_to_jax(d_state.model.state_dict())
    out: Dict[str, Any] = {"d_params": params, "d_batch_stats": stats}
    if not final:
        out["d_opt_state"] = opt_state_to_jax(d_state)
        out["d_step"] = int(d_state.step)
    return out


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The payload with fp32 trees and ``meta`` parsed."""
    p = Path(path)
    if p.is_dir() or (not p.exists() and p.with_name(p.name + ".old").is_dir()):
        raise ValueError(f"{p} is an Orbax checkpoint directory; reading Orbax "
                         f"comes with slice 5")
    raw = msgpack_restore(p.read_bytes())
    raw["meta"] = json.loads(raw["meta"])
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        if key in raw:
            raw[key] = map_tree(to_fp32, raw[key])
    return raw


def resume_state(state: TrainState, ckpt: Dict[str, Any], verbose: bool = True,
                 epoch_policy: str = "opt") -> Tuple[TrainState, int]:
    """Tolerant resume in place; returns (state, start_epoch).

    The epoch counter continues, by the reference's per-phase rules (the
    final checkpoint has no optimizer):
    - ``"opt"`` (denoise): only when the optimizer was restored;
    - ``"matched"`` (pixel): whenever every parameter matched;
    - ``"always"`` (GAN): unconditionally.
    """
    params, stats = variables_to_jax(state.model.state_dict())
    params, matched, total = intersect_trees(ckpt["params"], params)
    stats, _, _ = intersect_trees(ckpt.get("batch_stats", {}), stats)
    state.model.load_state_dict(variables_from_jax(params, stats))

    if "ema_params" in ckpt:
        e_params, e_stats = variables_to_jax(state.ema.state_dict())
        e_params, _, _ = intersect_trees(ckpt["ema_params"], e_params)
        e_stats, _, _ = intersect_trees(ckpt.get("ema_batch_stats", {}), e_stats)
        with torch.no_grad():
            for k, t in variables_from_jax(e_params, e_stats).items():
                state.ema.state_dict()[k].copy_(t)
        state.ema.updates = int(ckpt.get("ema_updates", 0))

    meta = ckpt.get("meta", {})
    start_epoch = 0
    if matched == total and "opt_state" in ckpt:
        try:
            opt_state_from_jax(state, ckpt["opt_state"])
        except (ValueError, KeyError) as e:
            print("WARNING: optimizer state in checkpoint is incompatible with the "
                  f"current optimizer ({e}); resuming weights only")
        else:
            state.step = int(meta.get("step", 0))
            start_epoch = int(meta["epoch"]) + 1
    if start_epoch == 0 and "epoch" in meta:
        if epoch_policy == "always" or (epoch_policy == "matched" and matched == total):
            start_epoch = int(meta["epoch"]) + 1
    if verbose:
        print(f"Loaded pre-trained {matched}/{total} model")
    return state, start_epoch


def resume_discriminator(d_state: TrainState, ckpt: Dict[str, Any]) -> TrainState:
    """D's params and statistics from a GAN checkpoint (matching leaves),
    and its optimizer and step when ``d_opt_state`` is there and fits; a
    checkpoint without ``d_params`` leaves D as it is."""
    if "d_params" not in ckpt:
        return d_state
    params, stats = variables_to_jax(d_state.model.state_dict())
    params, _, _ = intersect_trees(ckpt["d_params"], params)
    stats, _, _ = intersect_trees(ckpt.get("d_batch_stats", {}), stats)
    d_state.model.load_state_dict(variables_from_jax(params, stats))
    if "d_opt_state" in ckpt:
        try:
            opt_state_from_jax(d_state, ckpt["d_opt_state"])
        except (ValueError, KeyError) as e:
            print("WARNING: discriminator optimizer state in checkpoint is incompatible "
                  f"({e}); resuming D weights only")
        else:
            d_state.step = int(ckpt.get("d_step", 0))
    return d_state


def warm_start_generator(g_state: TrainState, pretrain_ckpt_path: str | Path,
                         verbose: bool = True) -> TrainState:
    """The GAN generator from the pixel phase's checkpoint: its EMA params
    and statistics (the raw ones without an EMA), matching leaves only; the
    EMA restarts from them. A checkpoint that cannot be read leaves the
    fresh generator, with a message."""
    try:
        ckpt = load_checkpoint(pretrain_ckpt_path)
    except Exception:
        if verbose:
            print("Could not load pretrain checkpoint.")
        return g_state
    params, stats = variables_to_jax(g_state.model.state_dict())
    params, matched, total = intersect_trees(ckpt.get("ema_params", ckpt.get("params")), params)
    stats, _, _ = intersect_trees(ckpt.get("ema_batch_stats", ckpt.get("batch_stats", {})),
                                  stats)
    g_state.model.load_state_dict(variables_from_jax(params, stats))
    if g_state.ema is not None:
        g_state.ema = EMA(g_state.model, g_state.ema.tau)
    if verbose:
        print(f"loaded pre-trained generator ({matched}/{total} leaves)")
    return g_state
