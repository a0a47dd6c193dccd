"""Core convolution block on NHWC tensors (counterpart of the JAX package's
``ops/conv.py``): conv('same') [+ BatchNorm] + act, and the dense block.

The block takes and returns NHWC. ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is an NCHW view in ``channels_last`` memory, so the convolution
runs channels-last with no copy on either side.

Rounding follows flax's ``nn.Conv`` with a compute ``dtype``: the conv
output is rounded to that dtype first, then the bias, cast to the same
dtype, is added (a second rounding). Adding the bias inside the conv would
round once and differ from the JAX package in bf16.

Parameters live in ``param_dtype`` (fp32 master weights for training, as
flax keeps them) and are cast to the compute ``dtype`` inside ``forward``;
``param_dtype=None`` keeps them in ``dtype``, which is what serving builds.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.mesh import data_group, gather_rows
from ..utils.general import autopad
from .activations import ActSpec, PReLU, apply_act, is_prelu

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax: running = m * running + (1 - m) * batch


def conv_bias_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
                   padding=0, dilation=1, groups=1) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW kernel, returning NHWC: the conv
    in ``x``'s dtype, then ``+ bias.to(dtype)``, as flax computes it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding, dilation,
                 groups).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor, returning NHWC."""
    return conv_bias_nhwc(x, conv.weight, conv.bias, conv.stride, conv.padding,
                          conv.dilation, conv.groups)


def conv_relu_nchw(xn: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, padding=(1, 1),
                   groups: int = 1) -> torch.Tensor:
    """relu(conv(xn) + bias) of an NCHW tensor (a channels-last one stays
    so), stride 1, the sum rounded once to the dtype. On the card cuDNN's
    fused conv-bias-ReLU: for RCAN's 3x3 convs 0.18 ms at the frames shape
    against 0.44 for the conv, the bias add and the ReLU as three kernels
    (PERF.md, section 6)."""
    if xn.is_cuda:
        return torch.cudnn_convolution_relu(xn, weight, bias, (1, 1), padding, (1, 1), groups)
    return torch.relu(F.conv2d(xn, weight, bias, padding=padding, groups=groups))


def conv_nchw(xn: torch.Tensor, weight: torch.Tensor, padding, groups: int = 1) -> torch.Tensor:
    """Stride-1 conv of an NCHW tensor (a channels-last one stays so), no
    bias, rounded to the dtype. On the card cuDNN's conv op is called
    directly: through ``F.conv2d`` a call costs some 20-30 us more of the
    H100 host's time (PERF.md, section 6)."""
    if xn.is_cuda:
        cudnn = torch.backends.cudnn
        return torch.cudnn_convolution(xn, weight, padding, (1, 1), (1, 1), groups,
                                       cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    return F.conv2d(xn, weight, None, 1, padding, 1, groups)


def conv_bias_nchw(xn: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   padding, groups: int = 1) -> torch.Tensor:
    """``conv_nchw`` then ``+ bias`` in place: each rounded to the dtype, as
    ``conv_bias_nhwc`` rounds them."""
    return conv_nchw(xn, weight, padding, groups).add_(bias.view(1, -1, 1, 1))


def conv_relu(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv_relu_nchw`` of an NHWC tensor with an ``nn.Conv2d``'s kernel,
    bias and padding, returning NHWC."""
    return conv_relu_nchw(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                          conv.padding).permute(0, 2, 3, 1).contiguous()


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of data-parallel training
    (flax's statistics over a batch sharded across the data mesh), on NCHW
    views of CPU or CUDA tensors; returns (y, mean, invstd).

    Forward: each rank's per-channel count, mean and M2 (sum of squared
    deviations) in fp32, every rank's gathered in rank order
    (``core.mesh.gather_rows``) and combined in that order (Chan et al.),
    so each rank holds the same statistics bit for bit; the batch is
    normalized with the global mean and biased variance, as flax does.
    Backward: the two per-channel sums (dy, dy * xhat) gathered and summed
    the same way. Each rank's loss is the mean over its own rows, so its
    dx is the group size times its share of the global one, and the grad
    all-reduce of ``train.state`` divides that out. The weight and bias
    gradients stay local: that all-reduce sums them."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // xf.shape[1]
        mean = xf.mean((0, 2, 3))
        m2 = (xf - _channels(mean)).square().sum((0, 2, 3))
        table = gather_rows(torch.stack([torch.full_like(mean, n), mean, m2]))
        count, mean, m2 = table[0].unbind(0)
        for other in table[1:]:
            n_b, mean_b, m2_b = other.unbind(0)
            total = count + n_b
            delta = mean_b - mean
            mean = mean + delta * (n_b / total)
            m2 = m2 + m2_b + delta.square() * (count * n_b / total)
            count = total
        invstd = torch.rsqrt(m2 / count + BN_EPS)
        y = (xf - _channels(mean)) * _channels(invstd * weight) + _channels(bias)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.mark_non_differentiable(mean, invstd)
        return y.to(x.dtype), mean, invstd

    @staticmethod
    def backward(ctx, dy, _dmean, _dinvstd):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dy = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - _channels(mean)) * _channels(invstd)
        sum_dy, sum_dy_xhat = dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))
        g_dy, g_dy_xhat = gather_rows(torch.stack([sum_dy, sum_dy_xhat])).sum(0).unbind(0)
        dx = _channels(weight * invstd) * (dy - _channels(g_dy / count)
                                           - xhat * _channels(g_dy_xhat / count))
        return dx.to(x.dtype), sum_dy_xhat, sum_dy


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NHWC tensor. Parameters ``weight``/``bias`` (flax ``bn/scale``,
    ``bn/bias``) and buffers ``running_mean``/``running_var`` (flax
    batch_stats ``bn/mean``, ``bn/var``), all fp32.

    In train mode the batch's mean and *biased* variance are reduced in
    fp32 (flax promotes bf16 activations to fp32 for its statistics) and
    normalize the batch; the mean and the inverse std are kept in
    ``batch_stats`` and folded into the running statistics by
    ``commit_batch_stats`` once per training step, as flax returns them
    from a step. ``torch.nn.BatchNorm2d`` would fold in the unbiased
    variance instead, at every forward (and again when a checkpointed block
    recomputes its forward in backward).

    Under data-parallel training (a data group from ``core.mesh``) the
    statistics are the global batch's (``GlobalBatchNorm``); in one process
    the forward is ``torch.native_batch_norm``'s, unchanged.
    """

    def __init__(self, features: int, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.weight = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))
        self.batch_stats = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = x.permute(0, 3, 1, 2)
        if self.training:
            if data_group() is None:
                y, mean, invstd = torch.native_batch_norm(
                    xn, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
            else:
                y, mean, invstd = GlobalBatchNorm.apply(xn, self.weight, self.bias)
            self.batch_stats = (mean.detach(), invstd.detach())
        else:
            y = F.batch_norm(xn, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, BN_EPS)
        return y.permute(0, 2, 3, 1)


def batch_norms(model: nn.Module) -> List[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@torch.no_grad()
def commit_batch_stats(bns: Iterable[BatchNorm]) -> None:
    """Fold each BatchNorm's last batch statistics into its running ones,
    ``r = 0.9 r + 0.1 batch`` with the biased variance ``invstd^-2 - eps``,
    and clear them; a few foreach passes over all of them."""
    done = [m for m in bns if m.batch_stats is not None]
    if not done:
        return
    var = torch._foreach_pow([m.batch_stats[1] for m in done], -2.0)
    torch._foreach_sub_(var, BN_EPS)
    torch._foreach_clamp_min_(var, 0.0)
    running = [t for m in done for t in (m.running_mean, m.running_var)]
    batch = [t for m, v in zip(done, var) for t in (m.batch_stats[0], v)]
    torch._foreach_mul_(running, BN_MOMENTUM)
    torch._foreach_add_(running, batch, alpha=1.0 - BN_MOMENTUM)
    for m in done:
        m.batch_stats = None


class ConvBlock(nn.Module):
    """conv('same') [+ BN] + act. ``use_bn=True``: bias-free conv + BatchNorm
    (reference ``Conv``); ``use_bn=False``: biased conv (``ConvWithoutBN``).
    Parameters: ``conv.weight`` (OIHW) and ``conv.bias`` (flax
    ``conv/kernel``, ``conv/bias``), ``bn.*`` and ``prelu.alpha``.
    ``weight_scale`` scales the kernel at init only (0.2 for ``--enchant``,
    ``ops/initializers.py``)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 1,
        act: ActSpec = None,
        use_bn: bool = False,
        stride: int = 1,
        dilation: int = 1,
        weight_scale: float = 1.0,
        dtype=torch.float32,
        param_dtype=None,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        pad = autopad(kernel, None, dilation)
        self.act = act
        self.dtype = dtype
        self.weight_scale = weight_scale
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=stride, padding=pad,
            dilation=dilation, bias=not use_bn, dtype=param_dtype or dtype,
            device=dev,
        )
        self.bn = BatchNorm(features, device=dev) if use_bn else None
        if is_prelu(act):
            # "prelu": torch's one shared slope; ("prelu", n), n != 1: one
            # slope per output channel, as the JAX ConvBlock builds it
            per_channel = isinstance(act, tuple) and len(act) > 1 and act[1] not in (None, 1)
            self.prelu = PReLU(features if per_channel else 1, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = conv_bias_nhwc(x, c.weight.to(self.dtype), c.bias, c.stride, c.padding,
                           c.dilation, c.groups)
        if self.bn is not None:
            y = self.bn(y)
        if is_prelu(self.act):
            return self.prelu(y)
        return apply_act(y, self.act)


class DenseBlock(nn.Module):
    """Linear [+ act] (the discriminator's head; flax ``DenseBlock``):
    ``dense.weight`` (out, in) and ``dense.bias`` (flax ``dense/kernel``
    (in, out), ``dense/bias``). As in flax's ``nn.Dense`` with a compute
    ``dtype``: the product rounded to that dtype, then the bias in it."""

    def __init__(self, in_features: int, features: int, act: ActSpec = None,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.dense = nn.Linear(in_features, features, dtype=param_dtype or dtype,
                               device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dense
        y = F.linear(x.to(self.dtype), d.weight.to(self.dtype))
        return apply_act(y + d.bias.to(self.dtype), self.act)


def same_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' conv of an NHWC tensor with an OIHW kernel, no bias."""
    pad = weight.shape[-1] // 2
    return F.conv2d(x.permute(0, 3, 1, 2), weight, padding=pad).permute(0, 2, 3, 1)
