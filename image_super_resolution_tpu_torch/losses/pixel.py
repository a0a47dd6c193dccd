"""Pixel-space losses (counterpart of the JAX package's ``losses/pixel.py``),
each a mean over every element in fp32."""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return weight * torch.mean(torch.abs(pred.float() - target.float()))


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Smooth L1: mean(sqrt(d^2 + eps^2))."""
    diff = pred.float() - target.float()
    return torch.mean(torch.sqrt(diff * diff + eps * eps))

