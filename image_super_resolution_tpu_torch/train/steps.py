"""Train steps, one per phase (counterpart of the JAX package's
``train/steps.py``): a uint8 batch on the device in, the loss out as a
device tensor (never read back here; the CLI fetches an epoch's losses at
once).

- pixel: the pretrain phase (``--resnet``): LR = normalize(downscale(x)),
  HR = tanh(x), MSE (L1 with ``--enchant`` or ``--L1_loss``);
- denoise: the denoise phase (``--train_denoise``): LR = the noise/JPEG
  chain of ``data/degrade.py`` drawn from a ``torch.Generator``, MSE.

Each step carries its ``batch_fn`` and ``loss_fn`` as attributes, so a
caller can time the step's parts (``chip_smoke.py`` does).

The GAN phase and the eval step come with the next slice.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..data import degrade
from ..data.pipeline import make_denoise_batch_fn, make_sr_batch_fn
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..losses.pixel import l1_loss, mse_loss
from .state import TrainState


def make_pixel_train_step(
    scale: int,
    pixel_loss: str = "mse",
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """Generator pretraining step on uint8 HR crops."""
    batch_fn = make_sr_batch_fn(scale, mean, std)
    loss_fn = mse_loss if pixel_loss == "mse" else l1_loss

    def step(state: TrainState, batch_u8: torch.Tensor) -> torch.Tensor:
        hr, lr = batch_fn(batch_u8)
        return state.fit(lr, hr, loss_fn)

    step.batch_fn, step.loss_fn = batch_fn, loss_fn
    return step


def make_denoise_train_step(
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    degradation: Callable = degrade.denoise_degradation,
) -> Callable[[TrainState, torch.Tensor, torch.Generator], torch.Tensor]:
    """Denoiser step: the degradation runs on the device from ``gen``."""
    batch_fn = make_denoise_batch_fn(mean, std, degradation)

    def step(state: TrainState, batch_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        hr, lr = batch_fn(batch_u8, gen)
        return state.fit(lr, hr, mse_loss)

    step.batch_fn, step.loss_fn = batch_fn, mse_loss
    return step
