"""Plain float32 building blocks of the reference models.

Images are uint8 NHWC on the way in and out; inside, activations are NCHW
float32 and every convolution is ``torch.nn.functional.conv2d``. Nothing
here imports the system under test. ``no_tf32`` turns TF32 off for the
duration of a reference computation, since on the card a float32
convolution would otherwise run in TF32.

``cast`` hooks let a caller round the operands of every convolution to a
lower precision: the controls that show the comparison can fail
(``fp8_cast``: per-tensor scaled float8 e4m3).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def normalize(x_u8: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, ``(x / 255 - mean) / std`` per channel."""
    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, -1, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, -1, 1, 1)
    return (x - m) / s


def tanh_to_uint8(y: torch.Tensor) -> torch.Tensor:
    """float32 NCHW in [-1, 1] -> uint8 NHWC: ``round((y + 1) / 2 * 255)``
    clipped to [0, 255], ties to even."""
    v = torch.clamp((y + 1.0) / 2.0 * 255.0, 0.0, 255.0)
    return torch.round(v).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
         cast: Cast = None) -> torch.Tensor:
    """'same' convolution of an NCHW tensor with an OIHW kernel, stride 1,
    zero padding; with ``cast`` both operands are rounded first."""
    if cast is not None:
        x, weight = cast(x), cast(weight)
    return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448, the format's largest value), back in float32."""
    amax = t.abs().amax().clamp_min(1e-12)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def host_apply(fn: Callable[[torch.Tensor], torch.Tensor], device
               ) -> Callable[[np.ndarray], np.ndarray]:
    """``fn`` (uint8 NHWC tensor on ``device`` -> uint8 NHWC tensor) as a
    function of host arrays, without autograd and with TF32 off."""
    def apply(x_u8: np.ndarray) -> np.ndarray:
        with torch.no_grad(), no_tf32():
            return fn(torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)).cpu().numpy()
    return apply
