"""Tensor parallelism: channel-sharded convolution and the fast families'
whole forward over several devices (counterpart of the JAX package's
``parallel/tensor.py``).

- ``col_conv``: the column-parallel conv every TP path runs: device i's
  input through device i's slice of a kernel's output channels;
  ``tp_conv``: one 'same' conv split so over the devices (Megatron's column
  split), the input replicated and the output gathered.
- ``TPFastUpscaler``: the fast families' uint8 -> uint8 forward with the
  trunk's channels split over the devices. Each residual block runs conv0
  column-parallel (the kernel's output channels split, leaky applied
  locally) and conv1 row-parallel (its input channels split): every device
  holds a partial sum of conv1's output, the partials are reduced, and the
  bias is added once. The trunk conv stays column-split into the split
  global residual; the tail reduces straight to its 3*r^2 channels, or,
  with a refinement tail, a row-parallel projection hands every device
  the whole refine stream, whose blocks split as the trunk's do before a
  3-channel conv on one device. depth + 1 (+ refine blocks) reductions in
  all. The head and the downshuffle front (edge pad, space-to-depth) run
  on every device on the replicated input.

JAX's ``psum`` becomes a sum of the partials in a fixed order (device 0's
first) on the first device, sent back to every device: the result is the
same on each of them and the same whatever the placement. The partials
are computed and summed in fp32 (every bf16 value is exact in fp32) and
rounded to the compute dtype once, after the sum, where the single-device
conv rounds its own fp32 sum: N partials rounded each would add N
roundings. The convs are PyTorch's (cuDNN on the card): the JAX version
runs ``lax.conv``, no Pallas kernel.

The dense-concat ``sr`` and the ``denoise`` families are not sharded this
way; they serve over the data and spatial axes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.mesh import gather, put
from ..data.transforms import normalize, tanh_to_uint8
from ..models.fast import _LEAKY, downshuffle_front
from ..ops.activations import apply_act
from ..ops.blocks import scale_residual
from ..ops.conv import conv_bias_nhwc, same_conv
from ..ops.pixel_shuffle import pixel_shuffle

COL, ROW = 0, 1  # the OIHW dim a sharded kernel is split on


def col_conv(xs: Sequence[torch.Tensor], kernels: Sequence[torch.Tensor],
             biases: Sequence[torch.Tensor], act=None) -> List[torch.Tensor]:
    """The column-parallel 'same' conv: ``act(xs[i] * kernels[i] +
    biases[i])`` for every i, each launched on its own device and left
    there (NHWC, OIHW kernels)."""
    return [apply_act(conv_bias_nhwc(x, k, b, padding=k.shape[-1] // 2), act)
            for x, k, b in zip(xs, kernels, biases)]


def tp_conv(devices: Sequence[torch.device]
            ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """fn(x NHWC, kernel OIHW, bias) -> the 'same' conv + bias, output
    channels split over ``devices`` (``col_conv``) and gathered on the
    first one. The output channels must divide by the device count."""
    n = len(devices)

    def apply(x, kernel, bias):
        if kernel.shape[0] % n:
            raise ValueError(f"{kernel.shape[0]} output channels do not divide over "
                             f"{n} devices")
        outs = col_conv([put(x, d) for d in devices],
                        [put(k, d) for d, k in zip(devices, kernel.chunk(n))],
                        [put(b, d) for d, b in zip(devices, bias.chunk(n))])
        return gather(outs, devices[0], dim=3)

    return apply


def tp_fast_param_specs(depth: int, refine_blocks: int = 0) -> Dict[str, Optional[int]]:
    """The split of every FastSRGenerator param under TP, by ``state_dict``
    key: ``COL`` (a kernel's output channels and its bias), ``ROW`` (a
    kernel's input channels; its bias replicated, added once after the
    reduction) or None (replicated)."""

    def conv(name, split):
        return {f"{name}.conv.weight": split,
                f"{name}.conv.bias": COL if split == COL else None}

    specs = {**conv("head", None), **conv("trunk_conv", COL)}
    for i in range(depth):
        specs.update({**conv(f"block{i}.conv0", COL), **conv(f"block{i}.conv1", ROW)})
    if refine_blocks:
        specs.update(conv("refine_proj", ROW))
        for i in range(refine_blocks):
            specs.update({**conv(f"refine{i}.conv0", COL), **conv(f"refine{i}.conv1", ROW)})
        specs.update(conv("tail", None))
    else:
        specs.update(conv("tail", ROW))
    return specs


class TPFastUpscaler:
    """uint8 NHWC -> uint8 NHWC fast-family forward, channel-split over
    ``devices``. A drop-in for ``DeployedModel`` in ``TiledUpscaler``
    (``spec``, ``device``, ``__call__``); the output is a uint8 tensor on
    the first device, within 1 LSB of the single-device graph in the same
    ``dtype`` (default bf16)."""

    def __init__(self, deployed, devices: Sequence[torch.device], dtype=None):
        spec = deployed.spec
        if spec.family not in ("fast", "denoise_fast"):
            raise ValueError(
                "tensor parallelism is implemented for the fast families "
                "(width-128 MXU-aligned trunk); the dense-concat reference "
                f"topology is served via data/spatial axes (got family="
                f"{spec.family!r})"
            )
        n = len(devices)
        if spec.width % n:
            raise ValueError(f"trunk width {spec.width} must divide over {n} 'tile' devices")
        self.refine_blocks = spec.refine_blocks or 0
        refine_width = spec.refine_width or 32
        if self.refine_blocks and refine_width % n:
            raise ValueError(
                f"refine width {refine_width} must divide over {n} 'tile' devices")
        self.spec = spec
        self.devices = list(devices)
        self.device = self.devices[0]
        self.dtype = dtype if dtype is not None else torch.bfloat16
        self._mean = tuple(float(v) for v in spec.mean)
        self._std = tuple(float(v) for v in spec.std)
        self._c_local = spec.width // n
        specs = tp_fast_param_specs(spec.depth, self.refine_blocks)
        state = deployed.model.state_dict()
        # shards[i][key]: device i's part, in the compute dtype; a ROW
        # kernel in fp32 for its partial sum (the dtype's values, exact)
        self.shards: List[Dict[str, torch.Tensor]] = []
        for i, d in enumerate(self.devices):
            shard = {}
            for key, split in specs.items():
                v = state[key].detach().to(self.dtype)
                if split is not None:
                    v = v.chunk(n, dim=split)[i]
                if split == ROW and key.endswith("weight"):
                    v = v.float()
                shard[key] = v.to(d).contiguous()
            self.shards.append(shard)

    def _col(self, name: str, xs: List[torch.Tensor], act=None) -> List[torch.Tensor]:
        """The conv ``name`` on the first ``len(xs)`` devices, each through
        its own shard (a slice of a COL kernel, or the whole replicated
        one)."""
        shards = self.shards[:len(xs)]
        return col_conv(xs, [p[f"{name}.conv.weight"] for p in shards],
                        [p[f"{name}.conv.bias"] for p in shards], act)

    def _reduce(self, name: str, xs: List[torch.Tensor], act=None,
                everywhere: bool = True) -> List[torch.Tensor]:
        """The row-parallel conv ``name``: fp32 partials on every device,
        summed in device order on the first device, rounded to the dtype,
        + bias once, ``act``; back on every device (``everywhere``) or on
        the first only."""
        partials = [same_conv(x.float(), self.shards[i][f"{name}.conv.weight"])
                    for i, x in enumerate(xs)]  # all launched
        total = partials[0]
        for p in partials[1:]:
            total = total + put(p, total.device)
        bias = self.shards[0][f"{name}.conv.bias"]
        y = apply_act(total.to(self.dtype) + bias, act)
        return [put(y, d) for d in self.devices] if everywhere else [y]

    def _res_block(self, name: str, hs: List[torch.Tensor]) -> List[torch.Tensor]:
        """col conv0 -> leaky -> row conv1 -> reduce: replicated in and out."""
        ts = self._col(f"{name}.conv0", hs, _LEAKY)
        ts = self._reduce(f"{name}.conv1", ts)
        return [h + scale_residual(t, self.spec.add_rate) for h, t in zip(hs, ts)]

    @torch.inference_mode()
    def __call__(self, u8_batch) -> torch.Tensor:
        """uint8 NHWC (numpy or tensor) -> uint8 NHWC tensor on the first
        device."""
        spec = self.spec
        u8 = torch.as_tensor(u8_batch)
        h_in, w_in = u8.shape[1], u8.shape[2]
        f = spec.downshuffle or 1
        scale = spec.output_scale
        r = scale * f
        xs = [downshuffle_front(normalize(put(u8, d), self._mean, self._std)
                                .to(self.dtype), f) for d in self.devices]
        xs = self._col("head", xs, _LEAKY)
        hs = xs
        for b in range(spec.depth):
            hs = self._res_block(f"block{b}", hs)
        c = self._c_local
        # the trunk conv's slice of channels + the same slice of the skip
        hs = [x[..., i * c:(i + 1) * c] + t
              for i, (x, t) in enumerate(zip(xs, self._col("trunk_conv", hs)))]
        if self.refine_blocks:
            ys = self._reduce("refine_proj", hs, _LEAKY)
            if r > 1:
                ys = [pixel_shuffle(y, r) for y in ys]
            for b in range(self.refine_blocks):
                ys = self._res_block(f"refine{b}", ys)
            y = self._col("tail", ys[:1], "tanh")[0]
        else:
            y = self._reduce("tail", hs, "tanh", everywhere=False)[0]
            if r > 1:
                y = pixel_shuffle(y, r)
        return tanh_to_uint8(y[:, :h_in * scale, :w_in * scale].float())
