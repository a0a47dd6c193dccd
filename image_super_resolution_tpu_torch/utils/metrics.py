"""PSNR, PSNR-Y, SSIM and the texture metrics (counterpart of the JAX
package's ``utils/metrics.py``). Inputs are NHWC [0,1] batches; everything
is computed in fp32, the window sums without TF32.

The texture metrics make the GAN phase falsifiable: ``hf_energy_ratio``
(RMS of the Y channel's high-frequency band, Y minus its Gaussian blur,
output over ground truth: 1 matched, < 1 oversmoothed, > 1 noisy) and
``gradient_hist_distance`` (total-variation distance between the
gradient-magnitude histograms of output and ground truth); ``sharpness``
is the no-reference RMS gradient magnitude.
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


def psnr_y_per_image(a01: torch.Tensor, b01: torch.Tensor, border: int = 4) -> torch.Tensor:
    """PSNR-Y of each image of the batch, shape (N,) dB (the eval CLI's
    per-crop dispersion)."""
    ya = y_channel(a01.float(), border) / 255.0
    yb = y_channel(b01.float(), border) / 255.0
    mse = torch.mean((ya - yb) ** 2, dim=(1, 2))
    return 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-12))


def _grad_mag(y: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude of an (N,H,W) luma stack on the common interior."""
    gx = y[:, 1:, 1:] - y[:, 1:, :-1]
    gy = y[:, 1:, 1:] - y[:, :-1, 1:]
    return torch.sqrt(gx ** 2 + gy ** 2)


def sharpness(x01: torch.Tensor, border: int = 4) -> torch.Tensor:
    """No-reference sharpness: RMS gradient magnitude of the Y channel, in
    [0,1] luma units."""
    y = y_channel(x01.float(), border) / 255.0
    return torch.sqrt(torch.mean(_grad_mag(y) ** 2))


def _blur_y(y: torch.Tensor, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian blur of an (N,H,W) luma stack, SAME zero padding, in full
    fp32."""
    win = _gaussian_window(size, sigma, y)[None, None]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(y[:, None], win, padding=size // 2)[:, 0]


def hf_energy_ratio(a01: torch.Tensor, b01: torch.Tensor, border: int = 4,
                    sigma: float = 1.5) -> torch.Tensor:
    """RMS energy of the high-frequency band (Y minus its Gaussian blur) of
    ``a`` over that of the ground truth ``b``."""
    ya = y_channel(a01.float(), border) / 255.0
    yb = y_channel(b01.float(), border) / 255.0
    ea = torch.sqrt(torch.mean((ya - _blur_y(ya, sigma=sigma)) ** 2))
    eb = torch.sqrt(torch.mean((yb - _blur_y(yb, sigma=sigma)) ** 2))
    return ea / torch.clamp_min(eb, 1e-8)


def histogram_edges(max_grad: float, bins: int, device) -> torch.Tensor:
    """``jnp.linspace(0, max_grad, bins + 1)`` in float32, value for value:
    stop * (i * (1 / bins)) with the reciprocal rounded to float32 first (XLA
    multiplies by it in place of the division), then the stop itself.
    The gradients of a flat region are exact ties, so an edge one ulp off
    would move counts between bins."""
    recip = torch.tensor(1.0, dtype=torch.float32, device=device) / bins
    t = torch.arange(bins, dtype=torch.float32, device=device) * recip
    stop = torch.tensor([max_grad], dtype=torch.float32, device=device)
    return torch.cat([stop * t, stop])


def _histogram(g: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Counts per bin as ``jnp.histogram``: right-open bins, the last one
    closed (the index ``searchsorted(side="right")`` gives)."""
    idx = torch.searchsorted(edges, g, right=True)
    idx = torch.where(g == edges[-1], len(edges) - 1, idx)
    return torch.bincount(idx, minlength=len(edges) + 1)[1:len(edges)]


def gradient_hist_distance(a01: torch.Tensor, b01: torch.Tensor, border: int = 4,
                           bins: int = 32, max_grad: float = 0.5) -> torch.Tensor:
    """Total-variation distance (0..1) between the gradient-magnitude
    histograms of the Y channels of ``a`` and ``b``, over fixed bins on
    [0, max_grad] (values above land in the last bin)."""
    ya = y_channel(a01.float(), border) / 255.0
    yb = y_channel(b01.float(), border) / 255.0
    ga = torch.clamp(_grad_mag(ya), 0.0, max_grad).reshape(-1)
    gb = torch.clamp(_grad_mag(yb), 0.0, max_grad).reshape(-1)
    edges = histogram_edges(max_grad, bins, ga.device)
    ha = _histogram(ga, edges).float() / ga.numel()
    hb = _histogram(gb, edges).float() / gb.numel()
    return 0.5 * torch.sum(torch.abs(ha - hb))


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
