"""BasicVSR x4 (Chan et al., CVPR 2021, arXiv:2012.02181; BasicSR's
``basicsr/archs/basicvsr_arch.py``, ``spynet_arch.py``, ``arch_util.py``),
as the port serves it: one segment of T frames in, T frames out. The JAX
package has no counterpart.

    flows: SPyNet(ref, supp) over the T - 1 neighbour pairs, both ways
    back_i = trunk_b([x_i, warp(back_{i+1}, flow_b[i])])      i = T-1 .. 0
    fwd_i  = trunk_f([x_i, warp(fwd_{i-1}, flow_f[i-1])])     i = 0 .. T-1
    y_i = conv_last(lrelu(conv_hr(up2(up2(lrelu(fusion([back_i, fwd_i])))))))
          + bilinear_x4(x_i)
    out = round(clamp(255 y, 0, 255))                    ``to_uint8``

with ``trunk(z) = block^blocks(lrelu(conv_in(z)))``, ``block(h) = h +
conv1(relu(conv0(h)))`` (3x3 convs, ``width`` filters; conv_in 3 + width
-> width), ``up2(z) = lrelu(pixel_shuffle(conv(z)))`` (3x3, width -> 4
width, then width -> 256: the source fixes the second stage, conv_hr and
conv_last at 64 channels, ``HR_WIDTH``), lrelu's slope 0.1, and the zero
state at each branch's first step (no warp there). ``warp`` is bilinear with zero padding (K4,
``ops/kernels/flow_warp``). SPyNet resizes the frames (bilinear,
align_corners False) to multiples of 32, normalises them with ImageNet's
mean and std, builds a 6-level average-pool pyramid and, from the coarsest
level up, doubles the flow (bilinear, align_corners True, times 2;
replicate-padded by a row or column where the sizes differ), warps the
support frame by it (border padding) and adds ``level_l([ref, warped,
flow])`` (five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU between);
the flow goes back to the frame's size (bilinear, align_corners False,
scaled by w/w_up and h/h_up). Both directions run as one batch over one
pyramid of the segment's frames. There is no clamp inside the model.

NHWC; module names in the flax style of the port's other models
(``spynet/level{l}/conv{k}``, ``backward_trunk/conv_in``,
``backward_trunk/block{b}/conv{0,1}``, the same under ``forward_trunk/``
(the source's own trunk names), ``fusion``, ``up0``, ``up1``, ``conv_hr``,
``conv_last``), so an ``.isr`` tree loads by name. The input
map is ``x / 255`` (mean 0, std 1).

Precision: every conv in the compute dtype (bf16 on the card, cuDNN, fp32
sums), SPyNet's included; the flows, their level-by-level sums, every
sampling coordinate, the bilinear x4 base and ``y`` in fp32. The recurrent
state (each trunk's residual stream and the feature carried to the next
frame) in the compute dtype too: at published widths on seeded weights an
fp32 state takes a fifth to a third off the error against the float32
reference, at some 30 more cast kernels a step (readings in
``perfbench/configs/basicvsr_x4.json``).

The two branches are independent until the reconstruction, so they run
side by side (``Branches``): step s advances the backward branch on frame
T-1-s and the forward branch on frame s, their states stacked on the
channels of one tensor, each block conv of both one grouped cuDNN conv.
A step is one K4 launch that warps both states (two channel windows of
the stacked tensor) into both trunk inputs, the frame's 3 channels in an
8-channel slot (5 zeros, so the 72 channels keep 16-byte pixels) before
the 64 warped ones; each ``conv_in`` kernel is laid out on those channels
once, when the weights load. Spans: ``basicvsr/flow`` (SPyNet over the
segment), ``basicvsr/propagate`` (the steps of both branches),
``basicvsr/reconstruct`` (the frames from both states).

Rounding (as the benchmark's reference, ``perfbench/reference/basicvsr.py``,
models it for its bfloat16 check): each conv's sum
rounded to the dtype, then its sum plus the bias, but once for a fused
conv-bias-ReLU (SPyNet's first four, each block's conv0); each leaky ReLU
and residual sum rounded. Convs are cuDNN's own ops, called directly, and
the stacked stream stays an NCHW view of channels-last memory: a segment
is some 2,300 host calls, and the host's share of them is what decides
whether the card waits (PERF.md, section 5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import constant
from ..ops.conv import ConvBlock, conv_bias_nchw, conv_nchw, conv_relu_nchw
from ..ops.kernels.flow_warp import flow_warp
from ..ops.pixel_shuffle import pixel_shuffle
from ..utils.profiling import annotate

BASICVSR_MEAN = (0.0, 0.0, 0.0)  # the model takes x / 255
BASICVSR_STD = (1.0, 1.0, 1.0)
SPYNET_LEVELS = 6
SPYNET_MEAN = (0.485, 0.456, 0.406)  # SPyNet's own ImageNet normalisation
SPYNET_STD = (0.229, 0.224, 0.225)
SPYNET_WIDTHS = (8, 32, 64, 32, 16, 2)
SLOPE = 0.1  # the leaky ReLUs'
FRAME_SLOT = 8  # channels the frame takes in the trunk's input buffer
HR_WIDTH = 64  # the source's fixed width after the first upsampler


def lrelu_(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu_(x, SLOPE)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv_bias_nchw`` of an NHWC tensor, returning NHWC (a view)."""
    return conv_bias_nchw(_nchw(x), conv.weight, conv.bias, conv.padding).permute(0, 2, 3, 1)


class SpyLevel(nn.Module):
    """SPyNet's ``BasicModule``: five 7x7 convs, ReLU between each pair."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        super().__init__()
        for k, (ci, co) in enumerate(zip(SPYNET_WIDTHS, SPYNET_WIDTHS[1:])):
            self.add_module(f"conv{k}", ConvBlock(ci, co, 7, dtype=dtype, device=device))

    def forward(self, zn: torch.Tensor) -> torch.Tensor:
        """NCHW (channels-last memory) in and out."""
        last = len(SPYNET_WIDTHS) - 2
        for k in range(last):
            conv = getattr(self, f"conv{k}").conv
            zn = conv_relu_nchw(zn, conv.weight, conv.bias, conv.padding)
        conv = getattr(self, f"conv{last}").conv
        return conv_bias_nchw(zn, conv.weight, conv.bias, conv.padding)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class SpyNet(nn.Module):
    """Optical flow of each neighbour pair of a segment, both ways."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        for level in range(SPYNET_LEVELS):
            self.add_module(f"level{level}", SpyLevel(dtype, device))

    def forward(self, frames: torch.Tensor):
        """``frames`` (T, H, W, 3) fp32 in [0, 1] -> (backward, forward)
        flows, each (T - 1, H, W, 2) fp32: backward[i] is BasicSR's
        ``spynet(x[i], x[i + 1])``, forward[i] its ``spynet(x[i + 1], x[i])``."""
        t, h, w, _ = frames.shape
        hu, wu = 32 * math.ceil(h / 32), 32 * math.ceil(w / 32)
        x = F.interpolate(_nchw(frames), size=(hu, wu), mode="bilinear", align_corners=False)
        # constants made on the device once: a copy from host memory would
        # wait for the card's queued work (the previous segment's, on the video path)
        mean, std = (constant(v, x).view(1, 3, 1, 1) for v in (SPYNET_MEAN, SPYNET_STD))
        pyramid = [(x - mean) / std]
        for _ in range(SPYNET_LEVELS - 1):
            pyramid.insert(0, F.avg_pool2d(pyramid[0], 2, 2, count_include_pad=False))
        pairs = [(torch.cat([p[:-1], p[1:]]), torch.cat([p[1:], p[:-1]])) for p in pyramid]
        ref0 = pairs[0][0]
        flow = ref0.new_zeros(ref0.shape[0], 2, ref0.shape[2] // 2, ref0.shape[3] // 2)
        for level, (ref, supp) in enumerate(pairs):
            up = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
            pad = (0, ref.shape[3] - up.shape[3], 0, ref.shape[2] - up.shape[2])
            if any(pad):
                up = F.pad(up, pad, mode="replicate")
            up = _nhwc(up)
            warped = flow_warp(_nhwc(supp), up, "border")
            z = torch.cat([_nhwc(ref), warped, up], -1).to(self.dtype)
            flow = getattr(self, f"level{level}")(_nchw(z)).float() + _nchw(up)
        flow = F.interpolate(flow, size=(h, w), mode="bilinear", align_corners=False)
        flow = _nhwc(flow * constant((w / wu, h / hu), flow).view(1, 2, 1, 1))
        return flow[:t - 1], flow[t - 1:]


class Trunk(nn.Module):
    """BasicSR's ``ConvResidualBlocks`` of one branch: ``conv_in`` (3 + width
    -> width, leaky ReLU) and ``blocks`` residual blocks without BN. It holds
    the branch's parameters under their names; ``Branches`` runs both
    branches' trunks as one."""

    def __init__(self, width: int, blocks: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.blocks = blocks
        self.conv_in = ConvBlock(3 + width, width, 3, dtype=dtype, device=device)
        for b in range(blocks):
            block = nn.Module()
            block.conv0 = ConvBlock(width, width, 3, dtype=dtype, device=device)
            block.conv1 = ConvBlock(width, width, 3, dtype=dtype, device=device)
            self.add_module(f"block{b}", block)


class Branches(nn.Module):
    """The two branches' trunks side by side: step s runs the backward
    branch on frame T-1-s beside the forward branch on frame s. Their
    streams are stacked on the channels of one channels-last tensor
    (backward first, ``width`` each), and each block conv of both branches
    is one grouped conv (2 groups): half the host's calls of two trunks, on
    the same arithmetic (cuDNN's grouped conv gives each branch's output bit
    for bit its own conv's). Each branch's ``conv_in`` runs on its own
    72-channel buffer (the frame in an 8-channel slot, then the 64 warped
    channels, as K4 writes it; its kernel laid out on those channels), the
    two outputs concatenated before the stacked bias. Its tensors are
    derived from the trunks' parameters (``lay_out``), kept out of the
    state dict."""

    def __init__(self, back: Trunk, fwd: Trunk):
        super().__init__()
        self._trunks = (back, fwd)  # not submodules: their parameters keep their names
        w = back.conv_in.conv.weight
        width, kw = w.shape[0], dict(dtype=w.dtype, device=w.device)

        def buffer(name, *shape):
            t = torch.empty(*shape, **kw)
            if len(shape) == 4:  # NHWC kernels beside NHWC activations
                t = t.contiguous(memory_format=torch.channels_last)
            self.register_buffer(name, t, persistent=False)

        for k in range(2):
            buffer(f"w_in{k}", width, FRAME_SLOT + width, 3, 3)
        buffer("b_in", 2 * width)
        for b in range(back.blocks):
            for k in range(2):
                buffer(f"w{b}_{k}", 2 * width, width, 3, 3)
                buffer(f"b{b}_{k}", 2 * width)
        self.lay_out()

    @torch.no_grad()
    def lay_out(self) -> None:
        for k, trunk in enumerate(self._trunks):
            w, w_in = trunk.conv_in.conv.weight, getattr(self, f"w_in{k}")
            w_in.zero_()
            w_in[:, :3] = w[:, :3]
            w_in[:, FRAME_SLOT:] = w[:, 3:]
        self.b_in.copy_(torch.cat([t.conv_in.conv.bias for t in self._trunks]))
        for b in range(self._trunks[0].blocks):
            for k in range(2):
                convs = [getattr(getattr(t, f"block{b}"), f"conv{k}").conv for t in self._trunks]
                getattr(self, f"w{b}_{k}").copy_(torch.cat([c.weight for c in convs]))
                getattr(self, f"b{b}_{k}").copy_(torch.cat([c.bias for c in convs]))

    def operands(self) -> list:
        """Each block's (conv0 kernel, bias, conv1 kernel, bias), stacked."""
        return [tuple(getattr(self, f"{p}{b}_{k}") for k in range(2) for p in "wb")
                for b in range(self._trunks[0].blocks)]

    def forward(self, z: torch.Tensor, blocks: list) -> torch.Tensor:
        """``z`` (2, H, W, 72), the backward branch's trunk input, then the
        forward branch's -> their new states stacked, (1, H, W, 2 width);
        ``blocks`` is ``operands()``. Four host calls a block for both
        branches (the fused conv-bias-ReLU, the conv, its bias and the
        residual add in place)."""
        zn = _nchw(z)
        h = torch.cat([conv_nchw(zn[k:k + 1], getattr(self, f"w_in{k}"), (1, 1))
                       for k in range(2)], 1)
        h = lrelu_(h.add_(self.b_in.view(1, -1, 1, 1)))
        for w0, b0, w1, b1 in blocks:
            h = h.add_(conv_bias_nchw(conv_relu_nchw(h, w0, b0, (1, 1), 2), w1, b1, (1, 1), 2))
        return h.permute(0, 2, 3, 1)


class BasicVSR(nn.Module):
    """NHWC (T, H, W, 3) fp32 frames in [0, 1] (``x / 255``), one segment ->
    (T, 4H, 4W, 3) fp32 ``y`` (before ``to_uint8``).

    What the serving code reads of it (``models/deploy``, ``infer/engine``):
    ``to_uint8``, its output map; ``sequence``, its batch axis is time and
    each output depends on every frame of the segment, so the engine hands
    it whole segments (the valid frames only) and refuses to cut one into
    tiles, bands or shards."""

    sequence = True

    def __init__(self, width: int = 64, blocks: int = 30, scale: int = 4,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if scale != 4:
            raise ValueError(f"BasicVSR upscales x4, got scale {scale}")
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.spynet = SpyNet(**kw)
        self.backward_trunk = Trunk(width, blocks, **kw)
        self.forward_trunk = Trunk(width, blocks, **kw)
        self.fusion = ConvBlock(2 * width, width, 1, **kw)
        self.up0 = ConvBlock(width, 4 * width, 3, **kw)
        self.up1 = ConvBlock(width, 4 * HR_WIDTH, 3, **kw)
        self.conv_hr = ConvBlock(HR_WIDTH, HR_WIDTH, 3, **kw)
        self.conv_last = ConvBlock(HR_WIDTH, 3, 3, **kw)
        for m in self.modules():  # NHWC kernels beside NHWC activations: cuDNN
            if isinstance(m, nn.Conv2d):  # then copies no kernel before each conv
                m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
        self.branches = Branches(self.backward_trunk, self.forward_trunk)
        self.register_load_state_dict_post_hook(lambda module, _: module.branches.lay_out())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, h, w, _ = x.shape
        if min(h, w) <= 32:
            raise ValueError(f"BasicVSR's SPyNet needs frames larger than 32 x 32, got {h} x {w}")
        with annotate("basicvsr/flow"):
            flows_b, flows_f = self.spynet(x) if t > 1 else (None, None)
        width = self.fusion.conv.weight.shape[0]
        with annotate("basicvsr/propagate"):
            # step s: the backward branch on frame t-1-s, the forward one on frame s
            slots = F.pad(x, (0, FRAME_SLOT - 3)).to(self.dtype)  # [x_i, 0 x 5]
            slots = torch.stack([slots.flip(0), slots], 1)
            flows = torch.stack([flows_b.flip(0), flows_f], 1) if t > 1 else None
            blocks = self.branches.operands()
            states = []  # step s: [back_{t-1-s}, fwd_s], (1, H, W, 2 width)
            for step in range(t):
                if step == 0:  # the zero state beside each frame
                    z = torch.cat([slots[0], slots.new_zeros(2, h, w, width)], -1)
                else:  # each branch's state, a channel window, warped by its flow
                    prev = states[-1].view(h, w, 2, width).permute(2, 0, 1, 3)
                    z = flow_warp(prev, flows[step - 1], "zeros", slots[step])
                states.append(self.branches(z, blocks))
        with annotate("basicvsr/reconstruct"):
            y = x.new_empty(t, 4 * h, 4 * w, 3)
            base = _nhwc(F.interpolate(_nchw(x), scale_factor=4, mode="bilinear",
                                       align_corners=False))
            for i in range(t):
                back, fwd = states[t - 1 - i][..., :width], states[i][..., width:]
                y[i] = self._reconstruct(back, fwd)[0].float() + base[i]
                if 2 * i >= t - 1:  # both halves of steps i and t-1-i read
                    states[i] = states[t - 1 - i] = None
        return y

    def _reconstruct(self, back: torch.Tensor, fwd: torch.Tensor) -> torch.Tensor:
        z = lrelu_(_conv(torch.cat([back, fwd], -1), self.fusion.conv))
        for up in (self.up0, self.up1):
            z = pixel_shuffle(lrelu_(_conv(z, up.conv)), 2)
        return _conv(lrelu_(_conv(z, self.conv_hr.conv)), self.conv_last.conv)

    @staticmethod
    def to_uint8(y: torch.Tensor, mean) -> torch.Tensor:
        """``round(clamp(255 y, 0, 255))``, half to even; ``mean`` unused
        (the model takes ``x / 255``)."""
        return torch.round(torch.clamp(255.0 * y, 0.0, 255.0)).to(torch.uint8)
