"""Train state: optimizer, schedule and EMA (counterpart of the JAX package's
``train/state.py``).

One step after ``loss.backward()`` runs, in the JAX package's order:
1. clip the gradients to a global norm of 10 (optax ``clip_by_global_norm``:
   ``g * 10 / norm`` when ``norm >= 10``, no epsilon);
2. coupled L2 (``--weight_decay``: ``wd * w`` added to the clipped
   gradient, optax ``add_decayed_weights``), then Adam(0.9, ``b2``,
   eps 1e-8) -- ``torch.optim.Adam``'s ``weight_decay`` is exactly that;
3. at a learning rate decayed linearly from ``lr`` to ``lr * lr2`` over all
   steps, stepped per batch (optax ``linear_schedule``);
4. BatchNorm running statistics folded in (``ops/conv.commit_batch_stats``);
5. the ramped EMA ``d = 0.9999 (1 - exp(-u / tau))``, ``e = e d + w (1 - d)``
   over the params and the BN running statistics, in fp32 (none for the
   GAN phase's discriminator, ``with_ema=False``).

Under data-parallel training (a data group from ``core.mesh``), step 1
starts with the gradients averaged over the group: one flat fp32 buffer in
parameter order, one all-reduce, divided by the group size, so every rank
applies the same update (JAX's gradient ``psum`` over the data mesh).

Nothing here reads a value back from the device.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.mesh import all_reduce_, data_group, local_mesh
from ..ops.conv import batch_norms, commit_batch_stats

EMA_DECAY = 0.9999
ADAM_B1 = 0.9
CLIP_NORM = 10.0


def ema_decay(updates: int, tau: float) -> float:
    return EMA_DECAY * (1.0 - math.exp(-updates / tau))


class EMA:
    """fp32 shadow of a model's params and BN running statistics."""

    def __init__(self, model: nn.Module, tau: float):
        self.tau = float(tau)
        self.updates = 0
        self.params = {k: p.detach().float().clone() for k, p in model.named_parameters()}
        self.buffers = {k: b.detach().float().clone() for k, b in model.named_buffers()}
        # the live tensors, updated in place by Adam and commit_batch_stats
        self._live = [*model.parameters(), *model.buffers()]

    @torch.no_grad()
    def update(self) -> None:
        self.updates += 1
        d = ema_decay(self.updates, self.tau)
        shadow = [*self.params.values(), *self.buffers.values()]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, [t.float() for t in self._live], alpha=1.0 - d)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {**self.params, **self.buffers}


def linear_lr(step: int, lr: float, lr2: float, total_steps: int) -> float:
    """optax ``linear_schedule(lr, lr * lr2, total_steps)`` at ``step``."""
    total = max(total_steps, 1)
    frac = 1.0 - min(max(step, 0), total) / total
    return (lr - lr * lr2) * frac + lr * lr2


class TrainState:
    """One network's training state: the model (train mode), Adam, the
    schedule's step count and the EMA."""

    def __init__(self, model: nn.Module, lr: float = 1e-4, lr2: float = 0.01,
                 total_steps: int = 1, weight_decay: float = 0.0, b2: float = 0.999,
                 ema_tau: Optional[float] = 2000.0, with_ema: bool = True):
        self.model = model.train()
        self.params: List[nn.Parameter] = list(model.parameters())
        on_card = self.params[0].device.type == "cuda"
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(ADAM_B1, b2), eps=1e-8,
                                          weight_decay=weight_decay,
                                          fused=True if on_card else None)
        self.lr, self.lr2, self.total_steps = lr, lr2, total_steps
        self.step = 0
        self.ema = EMA(model, ema_tau or 2000.0) if with_ema else None
        self._batch_norms = batch_norms(model)
        self._eval_model = None

    def backward(self, loss: torch.Tensor) -> None:
        """This model's gradients of ``loss``, and no other's: a loss that
        also runs through another network (G's loss through D) leaves that
        network's ``.grad`` untouched, as ``jax.grad`` over these params."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        for p, g in zip(self.params, grads):
            # None where the loss does not reach p, as backward() leaves it; in
            # p's own layout (a conv's gradient comes channels-last), which the
            # fused Adam requires
            p.grad = None if g is None else g.contiguous()

    def average_grads(self) -> None:
        """Each gradient averaged over the data group (no-op in one
        process). A param without a gradient adds zeros, so every rank's
        buffer lines up, and keeps no gradient."""
        if data_group() is None:
            return
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in self.params])
        all_reduce_(flat).div_(local_mesh().size)
        offset = 0
        for p in self.params:
            if p.grad is not None:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()

    def clip_and_adam(self) -> None:
        """Steps 1-3: global-norm clip, coupled L2 + Adam at this step's lr
        (after ``average_grads``)."""
        self.average_grads()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, (CLIP_NORM / norm).clamp(max=1.0))
        for group in self.optimizer.param_groups:
            group["lr"] = linear_lr(self.step, self.lr, self.lr2, self.total_steps)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def commit_and_ema(self) -> None:
        """Steps 4-5: the BN statistics of this step's forward, then the EMA."""
        commit_batch_stats(self._batch_norms)
        if self.ema is not None:
            self.ema.update()

    def discard_batch_stats(self) -> None:
        """Drop the statistics of the last train forward without folding
        them in (the GAN step's D forward inside G's loss)."""
        for m in self._batch_norms:
            m.batch_stats = None

    def eval_model(self) -> nn.Module:
        """A copy of the model in eval mode holding the EMA's params and
        statistics as they are now (the live ones without an EMA)."""
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model).eval().requires_grad_(False)
        source = self.ema.state_dict() if self.ema is not None else self.model.state_dict()
        self._eval_model.load_state_dict(source)
        return self._eval_model

    def fit(self, x: torch.Tensor, target: torch.Tensor, loss_fn) -> torch.Tensor:
        """One step on (input, target); returns the loss as a device tensor."""
        loss = loss_fn(self.model(x), target)
        loss.backward()
        self.clip_and_adam()
        self.commit_and_ema()
        return loss.detach()
