"""Adversarial (BCE-with-logits) losses (counterpart of the JAX package's
``losses/adversarial.py``):

- generator: BCE(D(sr), 1);
- discriminator: BCE(D(sr), 0) + BCE(D(hr), 1).
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits in fp32, in the stable form
    max(x, 0) - x t + log1p(exp(-|x|))."""
    x, t = logits.float(), targets.float()
    return torch.mean(torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs())))


def generator_adversarial_loss(sr_logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(sr_logits, torch.ones_like(sr_logits))


def discriminator_loss(sr_logits: torch.Tensor, hr_logits: torch.Tensor) -> torch.Tensor:
    return (bce_with_logits(sr_logits, torch.zeros_like(sr_logits))
            + bce_with_logits(hr_logits, torch.ones_like(hr_logits)))
