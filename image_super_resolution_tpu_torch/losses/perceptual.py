"""VGG perceptual (content) loss (counterpart of the JAX package's
``losses/perceptual.py``): content = dist(VGG(sr), VGG(hr)), the HR
features taken without a gradient; MSE for post-activation features, L1
for ``before_act`` (``--enchant``); perceptual = content + beta * BCE(D(sr),
1), beta = 1e-3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.vgg import TruncatedVGG19
from .adversarial import generator_adversarial_loss
from .pixel import l1_loss, mse_loss


class PerceptualLoss:
    """Truncated-VGG feature distance (the model is frozen) plus the
    adversarial term.

    ``feature_norm=True`` divides both feature maps by the HR features' RMS
    (+ 1e-6, without a gradient) before the distance: with random VGG
    weights the raw features make ``loss/content`` vanishingly small. Leave
    it off with real ImageNet weights."""

    def __init__(self, vgg: TruncatedVGG19, beta: float = 1e-3, feature_norm: bool = False):
        self.vgg = vgg
        self.beta = beta
        self.feature_norm = feature_norm
        self._dist = l1_loss if vgg.before_act else mse_loss

    def __call__(self, sr_norm: torch.Tensor, hr_norm: torch.Tensor,
                 sr_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(perceptual, adversarial, content)."""
        sr_feat = self.vgg(sr_norm)
        with torch.no_grad():
            hr_feat = self.vgg(hr_norm)
        if self.feature_norm:
            scale = torch.sqrt(torch.mean(torch.square(hr_feat))) + 1e-6
            sr_feat, hr_feat = sr_feat / scale, hr_feat / scale
        content = self._dist(sr_feat, hr_feat)
        adversarial = generator_adversarial_loss(sr_logits)
        return content + self.beta * adversarial, adversarial, content
