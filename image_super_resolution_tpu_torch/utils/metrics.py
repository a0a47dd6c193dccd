"""PSNR, PSNR-Y and SSIM (counterpart of the JAX package's
``utils/metrics.py``, the metrics of the in-training eval). Inputs are
NHWC [0,1] batches; everything is computed in fp32. The texture metrics
come with the eval CLI.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.transforms import y_channel


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the whole tensor (dB)."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12))


def psnr_y(a01: torch.Tensor, b01: torch.Tensor, border: int = 4) -> torch.Tensor:
    """PSNR on the BT.601 Y channel, ``border`` pixels cropped (the SR
    benchmark protocol)."""
    return psnr(y_channel(a01.float(), border) / 255.0, y_channel(b01.float(), border) / 255.0)


def _gaussian_window(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=like.device) - (size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """SSIM (Wang et al.) with an 11x11 Gaussian window (sigma 1.5), VALID,
    per channel, averaged over everything. The window sums run in full fp32
    (no TF32): E[x^2] - E[x]^2 cancels."""
    a, b = a.float().permute(0, 3, 1, 2), b.float().permute(0, 3, 1, 2)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    ch = a.shape[1]
    win = _gaussian_window(11, 1.5, a).expand(ch, 1, 11, 11)

    def filt(img):
        return F.conv2d(img, win, groups=ch)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mu_a, mu_b = filt(a), filt(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sig_a = filt(a * a) - mu_aa
        sig_b = filt(b * b) - mu_bb
        sig_ab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2)
    return torch.mean(num / den)
