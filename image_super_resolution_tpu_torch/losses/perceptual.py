"""VGG perceptual (content) loss (counterpart of the JAX package's
``losses/perceptual.py``): content = dist(VGG(sr), VGG(hr)), the HR
features taken without a gradient; MSE for post-activation features, L1
for ``before_act`` (``--enchant``); perceptual = content + beta * BCE(D(sr),
1), beta = 1e-3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.mesh import data_group, gather_rows
from ..models.vgg import TruncatedVGG19
from .adversarial import generator_adversarial_loss
from .pixel import l1_loss, mse_loss


class PerceptualLoss:
    """Truncated-VGG feature distance (the model is frozen) plus the
    adversarial term.

    ``feature_norm=True`` divides both feature maps by the HR features' RMS
    (+ 1e-6, without a gradient) before the distance: with random VGG
    weights the raw features make ``loss/content`` vanishingly small. Leave
    it off with real ImageNet weights. In data-parallel training the RMS is
    the global batch's, as JAX takes it over the batch sharded across its
    data mesh (every rank's sum of squares and count, gathered in rank
    order)."""

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
            if data_group() is None:
                scale = torch.sqrt(torch.mean(torch.square(hr_feat))) + 1e-6
            else:
                local = torch.stack([torch.square(hr_feat).sum(),
                                     hr_feat.new_tensor(hr_feat.numel())])
                total = gather_rows(local).sum(0)
                scale = torch.sqrt(total[0] / total[1]) + 1e-6
            sr_feat, hr_feat = sr_feat / scale, hr_feat / scale
        content = self._dist(sr_feat, hr_feat)
        adversarial = generator_adversarial_loss(sr_logits)
        return content + self.beta * adversarial, adversarial, content
