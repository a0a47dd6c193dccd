"""Train steps, one per phase (counterpart of the JAX package's
``train/steps.py``): a uint8 batch on the device in, the loss out as a
device tensor (never read back here; the CLI fetches an epoch's losses at
once).

- pixel: the pretrain phase (``--resnet``): LR = normalize(downscale(x)),
  HR = tanh(x), MSE (L1 with ``--enchant`` or ``--L1_loss``);
- denoise: the denoise phase (``--train_denoise``): LR = the noise/JPEG
  chain of ``data/degrade.py`` drawn from a ``torch.Generator``, MSE;
- gan: the SRGAN fine-tune (neither flag): G, then D, in one step;
- eval: PSNR, PSNR-Y and SSIM of the EMA model (``--eval_every``).

The pixel and denoise steps carry their ``batch_fn`` and ``loss_fn`` as
attributes (the GAN step its ``batch_fn`` and ``perceptual``), and the GAN
step takes a ``mark`` callback called at the end of each of its parts, so
a caller can time the parts (``chip_smoke.py`` does) or check the
gradients before the optimizers take them.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..data import degrade
from ..data.pipeline import make_denoise_batch_fn, make_sr_batch_fn
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, tanh_to_01, tanh_to_norm
from ..losses.adversarial import discriminator_loss
from ..losses.perceptual import PerceptualLoss
from ..losses.pixel import l1_loss, mse_loss
from ..utils.metrics import psnr, psnr_y, ssim
from .state import TrainState

Metrics = Dict[str, torch.Tensor]

# The GAN step's parts, in order; ``mark`` is called with each at its end.
GAN_PARTS = ("batch prep", "G forward + loss", "G backward", "G clip + Adam",
             "D forwards + BN commits", "D backward", "D clip + Adam", "G BN commit + EMA")


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


def make_gan_train_step(
    scale: int,
    perceptual: PerceptualLoss,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Callable[..., Metrics]:
    """SRGAN step, G then D, as the JAX package's (``train/steps.py``):

    - sr = G(lr), re-normalized with the dataset mean/std; G's loss is the
      VGG content loss + 1e-3 BCE(D(sr), 1) on HR normalized the same way.
      Its gradients reach G's params only (``TrainState.backward``): D's
      ``.grad`` stays untouched and VGG is frozen. The statistics of D's
      train forward inside G's loss are dropped, not folded in.
    - D then trains on (sr detached, hr): BCE(sr, 0) + BCE(hr, 1). Its
      BatchNorms fold the statistics of the sr forward, then those of the
      hr forward, in turn, as flax threads them through the two forwards.

    Returns the metrics ``loss/content``, ``loss/adv`` and ``loss/dis`` as
    device tensors."""
    batch_fn = make_sr_batch_fn(scale, mean, std, hr_mode="norm")

    def step(g_state: TrainState, d_state: TrainState, batch_u8: torch.Tensor,
             mark: Callable[[str], None] = lambda part: None) -> Metrics:
        hr_norm, lr = batch_fn(batch_u8)
        mark(GAN_PARTS[0])
        sr_norm = tanh_to_norm(g_state.model(lr), mean, std)
        sr_logits = d_state.model(sr_norm)
        d_state.discard_batch_stats()
        perceptual_l, adv_l, content_l = perceptual(sr_norm, hr_norm, sr_logits)
        mark(GAN_PARTS[1])
        g_state.backward(perceptual_l)
        mark(GAN_PARTS[2])
        g_state.clip_and_adam()
        mark(GAN_PARTS[3])
        sr_logits = d_state.model(sr_norm.detach())
        d_state.commit_and_ema()
        hr_logits = d_state.model(hr_norm)
        d_state.commit_and_ema()
        d_loss = discriminator_loss(sr_logits, hr_logits)
        mark(GAN_PARTS[4])
        d_state.backward(d_loss)
        mark(GAN_PARTS[5])
        d_state.clip_and_adam()
        mark(GAN_PARTS[6])
        g_state.commit_and_ema()
        mark(GAN_PARTS[7])
        return {"loss/content": content_l.detach(), "loss/adv": adv_l.detach(),
                "loss/dis": d_loss.detach()}

    step.batch_fn, step.perceptual = batch_fn, perceptual
    return step


def make_eval_step(
    scale: int,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Callable[[TrainState, torch.Tensor], Metrics]:
    """PSNR, PSNR-Y and SSIM of the EMA model (params and BN statistics;
    the live ones without an EMA) in eval mode on uint8 HR crops, LR =
    normalize(downscale(x))."""
    batch_fn = make_sr_batch_fn(scale, mean, std)

    @torch.no_grad()
    def step(state: TrainState, batch_u8: torch.Tensor) -> Metrics:
        hr, lr = batch_fn(batch_u8)
        sr01, hr01 = tanh_to_01(state.eval_model()(lr)), tanh_to_01(hr)
        return {"psnr": psnr(sr01, hr01), "psnr_y": psnr_y(sr01, hr01),
                "ssim": ssim(sr01, hr01)}

    return step
