"""On-device degradations for training pairs (counterpart of the JAX
package's ``data/degrade.py``), on fp32 NHWC batches in [0, 1].

The random ones draw from an explicit ``torch.Generator`` on the batch's
device. ``jax.random`` and ``torch.Generator`` are different streams, so the
noise matches the JAX package in distribution, not value; at a fixed JPEG
quality ``jpeg_compress`` matches it by value (``torch.round`` and
``jnp.round`` both round half to even).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 (``jax.image.resize``'s; torch's
    bicubic interpolation uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str, antialias: bool,
                   device=None) -> torch.Tensor:
    """The (n_in, n_out) float32 weights of a 1-D resize, as
    ``jax.image.resize`` builds them (scale-and-translate): half-pixel
    centres, the kernel widened by the downscale factor under
    ``antialias``, each column renormalized to sum to 1, and columns whose
    sample lies outside the input zeroed."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; one of {sorted(_KERNELS)}")
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x01: torch.Tensor, h: int, w: int, method: str, antialias: bool) -> torch.Tensor:
    """Resize an NHWC float batch to (h, w) as ``jax.image.resize`` does: two
    separable weight matrices, applied as matmuls in full fp32 (no TF32)."""
    n, h0, w0, c = x01.shape
    x = x01.float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if w != w0:
            ww = resize_weights(w0, w, method, antialias, x.device)
            x = torch.einsum("nhwc,wv->nhvc", x, ww)
        if h != h0:
            wh = resize_weights(h0, h, method, antialias, x.device)
            x = torch.einsum("nhwc,hu->nuwc", x, wh)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return x


def downscale(x01: torch.Tensor, scale: int, method: str = "bilinear",
              antialias: bool = False) -> torch.Tensor:
    """Downscale an NHWC [0,1] batch by an integer factor.

    The default (bilinear, no antialias) is cv2.INTER_LINEAR with
    half-pixel centres and no prefilter (the reference's albumentations
    Resize). At sizes divisible by the factor it has a closed form: with the
    sample point midway between the two middle pixels of each block (even
    factor) or on the centre pixel (odd factor), it is two averages of
    neighbours, in the JAX package's order, so the two agree bit for bit.
    Every other case (``bicubic``, ``antialias``, other sizes) goes through
    :func:`resize`, ``jax.image.resize``'s weights."""
    n, h, w, c = x01.shape
    if method == "bilinear" and not antialias and h % scale == 0 and w % scale == 0:
        if scale == 1:
            return x01
        blocks = x01.reshape(n, h // scale, scale, w // scale, scale, c)
        m = scale // 2
        if scale % 2:
            return blocks[:, :, m, :, m, :]
        rows = (blocks[:, :, m - 1] + blocks[:, :, m]) * 0.5  # (n, H/s, W/s, s, c)
        return (rows[:, :, :, m - 1] + rows[:, :, :, m]) * 0.5
    return resize(x01, h // scale, w // scale, method, antialias)


def upscale(x01: torch.Tensor, scale: int, method: str = "bicubic") -> torch.Tensor:
    """Upscale an NHWC [0,1] batch by an integer factor (no antialias), as
    ``jax.image.resize``: the eval CLI's bicubic baseline."""
    n, h, w, c = x01.shape
    return resize(x01, h * scale, w * scale, method, antialias=False)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: torch.Tensor):
    u = torch.rand(shape, generator=gen, device=like.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _normal(gen: torch.Generator, shape, like: torch.Tensor):
    return torch.randn(shape, generator=gen, device=like.device, dtype=torch.float32)


def gaussian_noise(gen: torch.Generator, x01: torch.Tensor,
                   var_range: Tuple[float, float] = (10.0, 50.0)) -> torch.Tensor:
    """Additive Gaussian noise, its variance drawn per image on the 0-255
    scale (albumentations GaussNoise)."""
    var = _uniform(gen, (x01.shape[0], 1, 1, 1), *var_range, x01)
    sigma = torch.sqrt(var) / 255.0
    return torch.clamp(x01 + _normal(gen, x01.shape, x01) * sigma, 0.0, 1.0)


def iso_noise(gen: torch.Generator, x01: torch.Tensor,
              color_shift: Tuple[float, float] = (0.01, 0.05),
              intensity: Tuple[float, float] = (0.1, 0.5)) -> torch.Tensor:
    """Camera-sensor (ISO) noise: luminance shot noise as sqrt(luma)-scaled
    Gaussian plus a chrominance shift (albumentations ISONoise)."""
    n = x01.shape[0]
    inten = _uniform(gen, (n, 1, 1, 1), *intensity, x01)
    cshift = _uniform(gen, (n, 1, 1, 1), *color_shift, x01)
    luma = x01.mean(dim=-1, keepdim=True)
    shot = _normal(gen, luma.shape, x01) * torch.sqrt(luma.clamp_min(1e-6)) * inten * 0.1
    chroma = _normal(gen, x01.shape, x01) * cshift
    return torch.clamp(x01 + shot + chroma, 0.0, 1.0)


# Standard Annex-K luminance / chrominance quantization tables.
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_Q_CHROMA = np.full((8, 8), 99, np.float32)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
_RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)
_YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                        [1.0, -0.344136, -0.714136],
                        [1.0, 1.772, 0.0]], np.float32)


def _dct_matrix() -> np.ndarray:
    """8x8 orthonormal DCT-II basis."""
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0, :] = m[0, :] / np.sqrt(2.0)
    return (m * 0.5).astype(np.float32)


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The JPEG chain's constant tables on ``device``, copied there once: a
    copy from host memory per step would wait for the card's queued work."""
    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return {"luma": put(_Q_LUMA), "chroma": put(_Q_CHROMA), "to_ycc": put(_RGB_TO_YCC.T),
            "to_rgb": put(_YCC_TO_RGB.T), "dct": put(_dct_matrix()),
            "offset": put([0.0, 128.0, 128.0])}


def _quality_tables(quality: torch.Tensor, tables: dict):
    """libjpeg quality scaling: scale = 5000/q (q < 50) else 200 - 2q."""
    q = torch.clamp(quality, 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)

    def scaled(base):
        return torch.clamp(torch.floor((base[None] * scale[:, None, None] + 50.0) / 100.0),
                           1.0, 255.0)

    return scaled(tables["luma"]), scaled(tables["chroma"])


def jpeg_compress(gen: torch.Generator, x01: torch.Tensor,
                  quality_range: Tuple[float, float] = (50.0, 75.0)) -> torch.Tensor:
    """JPEG round trip with a per-image quality: YCbCr -> 8x8 DCT -> quantize
    -> dequantize -> IDCT -> RGB, 4:4:4 (no chroma subsampling), sizes not
    divisible by 8 edge-padded."""
    n, h, w, c = x01.shape
    if c != 3:
        raise ValueError("jpeg_compress expects RGB input")
    tables = _tables(x01.device)
    quality = _uniform(gen, (n,), *quality_range, x01)
    q_luma, q_chroma = _quality_tables(quality, tables)
    qtab = torch.stack([q_luma, q_chroma, q_chroma], dim=1)  # (N, 3, 8, 8)

    offset = tables["offset"]
    ycc = x01 @ tables["to_ycc"] * 255.0 + offset - 128.0
    ph, pw = -h % 8, -w % 8
    if ph or pw:
        ycc = F.pad(ycc.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    hb, wb = ycc.shape[1] // 8, ycc.shape[2] // 8
    blocks = ycc.reshape(n, hb, 8, wb, 8, 3).permute(0, 5, 1, 3, 2, 4)  # (N, C, hb, wb, 8, 8)
    d = tables["dct"]
    coeffs = torch.einsum("ij,nchwjk,lk->nchwil", d, blocks, d)
    qt = qtab[:, :, None, None, :, :]
    coeffs = torch.round(coeffs / qt) * qt
    blocks = torch.einsum("ji,nchwjk,kl->nchwil", d, coeffs, d)
    ycc = blocks.permute(0, 2, 4, 3, 5, 1).reshape(n, hb * 8, wb * 8, 3)
    ycc = ycc[:, :h, :w, :] + 128.0
    rgb = (ycc - offset) @ tables["to_rgb"] / 255.0
    return torch.clamp(rgb, 0.0, 1.0)


# Named severities of the denoise chain: (gauss variance range on the 0-255
# scale, ISO intensity range, JPEG quality range). "default" is the
# reference's training distribution.
DENOISE_SEVERITIES: dict = {
    "light": ((5.0, 15.0), (0.05, 0.2), (75.0, 90.0)),
    "default": ((10.0, 50.0), (0.1, 0.5), (50.0, 75.0)),
    "heavy": ((50.0, 100.0), (0.5, 1.0), (25.0, 50.0)),
}


def denoise_degradation(gen: torch.Generator, x01: torch.Tensor,
                        quality_range: Tuple[float, float] = (50.0, 75.0),
                        var_range: Tuple[float, float] = (10.0, 50.0),
                        intensity: Tuple[float, float] = (0.1, 0.5)) -> torch.Tensor:
    """The reference denoiser's LR chain: GaussNoise -> ISONoise -> JPEG."""
    x = gaussian_noise(gen, x01, var_range)
    x = iso_noise(gen, x, intensity=intensity)
    return jpeg_compress(gen, x, quality_range)
