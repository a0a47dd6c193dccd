#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run it from a checkout of the repository: it needs the package
``image_super_resolution_tpu_torch`` beside it and imports nothing of JAX.
Phases, each of which raises on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build of every CUDA source of the serving paths (one ``nvcc`` per
   source, all started together), timed;
3. K1, the fused RDB: its ptxas report (registers, shared memory, no
   spills), then against its plain PyTorch version on the card at the
   serving shape, video frames (8 x 270 x 480) and ragged and whole-image
   shapes, with the tolerance stated; then timed (CUDA events) beside its
   plain version and the cuDNN yardstick, and whole and per launch at
   b256 t24, the frames shape and a ragged 1 x 97 x 131, each with its
   rectangles per persistent block;
4. K2: the ptxas report of ``csrc/matmul.cu`` (fails on a spill);
   ``matmul`` at the probe's check shape and a ragged one (int8 exact);
   ``conv3x3_int8`` in every variant (fp32 or int8 in; fp32, int8 or both
   out; with and without the residual epilogue; leaky on and off) at b256
   t24 w128, 2x48x48, 1x93x93, 3x17x29 and two small odd-Cout shapes,
   exact against its plain version (the fp32 stream carries ties); then
   the five serving sites timed at b256 t24 beside their bounds, the plain
   version, a cuDNN bf16 conv and ``torch._int_mm``, and the 4096^3 GEMMs
   beside ``torch._int_mm`` and bf16 ``torch.matmul``;
5. ``sr`` x4 serving at full width: depth 16, width 64, random weights from
   a numpy seed -> ``.isr`` -> ``load_artifact`` -> ``DeployedModel`` in
   bf16 on a b256 t24 uint8 batch; K1's launches are counted over these
   requests, two tiles are held against the port's fp32 CPU path;
6. ``fast`` x4 serving at full width and depth (14, 128) on the same
   batch shape, in bf16 and then in int8 (``quantize_deployed`` calibrated
   on the batch; each conv0 site hands its conv1 an int8 tensor): K2's
   launches counted (29 per int8 forward, 0 per bf16 one) and by variant
   (1 fp32 -> int8, 14 int8 -> int8, 14 int8 -> fp32), two tiles held
   against the port's CPU paths; then the same int8 path calibrated at the 99.9th
   percentile on that batch (2^24+ values per site), held to bf16;
7. ``denoise_fast`` (14, 128, downshuffle 2) in int8 through
   ``TiledUpscaler`` on one odd-sized image: output shape and launches;
8. the ``rs`` CLI on a folder of two PNGs (512x384 and odd-sized), with the
   ``sr`` artifact and then ``--int8`` with the ``fast`` artifact, each
   timed as one run: artifact load, calibration, both images and the host
   PNG codec;
9. the user's path at full width: 64 smooth 192x192 PNGs and their
   manifest written by ``cli.create_json``, then training through
   ``cli.train.main`` at the CLI defaults (batch 16, patch 96, the loader's
   ``auto`` backend: the C++ loader where it builds), one epoch
   each: (a) ``--resnet`` sr x2 d16 w64 with BN, (b) ``--resnet --family
   fast --scale 4``, (c) ``--train_denoise``, (d) the GAN phase in (a)'s
   work dir (G warm-started from (a), every leaf matched; D 3-64-8-1024;
   VGG19 (5, 4) on random features; ``--eval_every 1``). (a) and (d) are
   stopped at their first checkpoint and resumed with ``--resume --epochs
   2``, which must continue at epoch 1 with the optimizer restored (and
   D's). Every loss finite, no substituted patch. Each run's step is then
   timed outside the CLI (CUDA events), broken down into its parts,
   profiled for the idle share and measured for peak memory. Three pixel
   steps and three GAN steps at depth 2 in fp32 are held against the
   CPU's, the optimizers and EMA on the same gradients. Then (a)-(c) are
   exported through ``build_deployed`` and served on the card: sr x2
   through K1 (48 launches per forward counted), fast int8 through K2 (29
   per forward, counted by variant), denoise in bf16; two tiles of each are
   held against the port's CPU path. (d) is exported by ``cli.export.main``
   and served from the ``.isr`` through ``load_artifact`` (48 K1 launches
   per forward, two tiles against the CPU) and ``rs``;
10. ``cli.evaluate.main`` over phase 9's 64 PNGs at 192 crops, batch 8:
    the ``sr`` x4 artifact (K1 counted, 48 per batch), the ``fast`` x4
    artifact with ``--int8`` (K2 counted by variant) and run (c)'s
    Denoiser, saved as an ``.isr``, with ``--denoise_eval --severity
    heavy``; every key finite, 64 images, each run's wall time. Then the
    ``sr`` and ``fast`` bf16 artifacts on 8 crops on the card and through
    the port's CPU path, each key within ``EVAL_CARD_ATOL``;
11. video: a 21-frame 180x320 clip of smooth frames, written by the port's
    ``FFMPEGRecorder`` (ffmpeg, else OpenCV) and decoded by ``VideoSource``
    where either exists, else held in memory, through ``rs.video_pipeline``
    at batch 8 (a padded tail) with the ``sr`` x4 artifact (720x1280 out):
    frames equal, bit for bit, to a serial loop of ``upscale_batch``, K1
    counted; frames/s of both on 240 frames held in memory, after one
    warm-up batch, twice each; the same in int8 with the ``fast`` artifact
    calibrated on the first 4 frames (K2 counted by variant); with a clip,
    ``cli.rs.main`` on it (dimensions, frames);
12. profiling: ``rs --profile_dir`` on one PNG with the ``sr`` artifact,
    whose trace must name K1's kernel (``rdb_dense_conv``), and
    ``cli.train --profile_dir`` with run (b)'s flags at batch 8, whose trace
    must hold steps 2-4;
13. interop and export formats: a seeded ``sr`` x4 d16 w64 generator in the
    reference's layout as a TorchScript artifact (the helper of
    ``tests/test_torch_reference_layout.py``) through ``cli.import_torch
    --smoke`` (card bf16 vs the CPU fp32 TorchScript forward within
    ``BF16_MAX_LSB``), its ``.isr`` through ``load_artifact`` and
    ``cli.demo``; ``cli.export --stablehlo`` (a ``torch.export`` program,
    static at b256 t24 and ``--hlo_dynamic``) from run (d) and from a seeded
    ``sr`` x4 checkpoint, each loaded and held bit-equal to the eager model
    (K1 48 launches per forward; the static x4 request timed beside eager);
    ``--torch_state_dict`` and ``--torch_discriminator`` from runs (a) and
    (d) re-imported bit for bit; a legacy-denoiser artifact (d8 w64 hidden
    32) served within ``DENOISE_BF16_MAX_LSB``;
14. the native loader on the card's host: a ``g++`` probe of the
    libjpeg-turbo (``jpeg_crop_scanline``) and libpng headers, printed;
    where it fails, one ``[loader] native unavailable`` line, ``auto``
    choosing python and ``--loader_backend native`` raising, and nothing
    more. Else a COCO-like set written by OpenCV (256 smooth-plus-noise
    JPEG photos 640x480 and 480x640 at quality 90, 4:2:0; two JPEGs under
    the patch; a grey PNG; a BMP) and its manifest (``cli.create_json``);
    ``native.decode_rgb`` against cv2 and PIL (mean difference under 1); 64
    crops of ``load_patches`` bit-equal to the native full decode at the
    offsets of a Python splitmix64, none substituted; ``PatchLoader``'s
    patches/s with each backend at workers 2, 4 and 8 (batch 16, patch 96,
    one epoch after a warm-up one, host clock, beside the CPU count); then
    ``cli.train.main`` fast x4 on the set for 3 epochs with each backend
    (patches/s of epochs 2-3, losses finite), and the native run's
    checkpoint served in int8 through K2 (29 launches per forward, counted
    by variant, two tiles against the CPU). Any failure to build or load
    the loader after the probe passed fails the run;
15. multi-device serving: the device count and the device lists used
    (the local cards in turn, so ``cuda:0`` N times on a one-card machine,
    which then says that peer copies and concurrency across cards were not
    exercised). (a) the ``sr`` x4 artifact in bf16 on a 192x256 image
    under ``spatial_devices=4`` and ``spatial_grid=(2, 2)`` (halo 16):
    equal to the same bands run one after another through one
    ``DeployedModel``, K1 48 launches per band forward, a 96x96 crop within
    ``BF16_MAX_LSB`` of the CPU's fp32 spatial run (the whole-image
    forward's reading on that crop printed beside it); (b)
    ``data_devices=2``: ``sr`` tiles (K1), ``fast`` x4 int8 b256 t24 frames
    (K2 29 per shard forward, by variant) and ``denoise_fast`` d14 w128 int8
    tiled (K2), each equal to one device or within 1 LSB with the share
    printed; for ``sr``, 8 tiles in one forward against two shards of 4,
    stage by stage (hooks), with the default cuDNN settings and with
    ``deterministic=True``: the first stage that differs and the cuDNN
    kernels only one of the two batch sizes runs. Every path of (a) and
    (b) is also run again on the card with its kernels swapped for their
    plain versions, so each kernel is held at the shapes that path gives
    it (the 96-row bands, the 160x128 blocks,
    4x96x96 tiles, b128 t24 frames, the denoiser's tile shards): within
    ``BF16_MAX_LSB`` (K1) or ``INT8_CARD_MAX_LSB`` (K2), no launch there; (c)
    ``TPFastUpscaler`` over 2 and 4 on ``fast`` x4 and a ``denoise_fast``
    with a refine tail, bf16, b1 96x96, within 1 LSB of the single-device
    graph; (d) ``rs --data_devices 0`` equal to one device, and
    ``--data_devices 2`` exiting on a one-card machine with the JAX
    message. Request times by CUDA events beside one device's;
16. data-parallel training: run (a)'s flags (``sr`` x2 d16 w64 BN,
    ``--resnet``, one epoch at batch 16 on phase 9's PNGs) in one process,
    then (a) the same at world size 1 over NCCL in this process (every
    collective runs), (b) two ranks sharing ``cuda:0`` over gloo (this
    script started twice with ``--dp-rank``): the pixel run, then the GAN
    phase in its work dir, held against one process (the GAN against a
    one-process GAN from the same pixel checkpoint) within
    ``DP_LOSS_RTOL``/``DP_GAN_LOSS_RTOL``, ``DP_STEP_ATOL`` and
    ``DP_STATS_RTOL``, the ranks bit-equal by a hash of their state and
    rank 0 the only writer; (c) (b)'s pixel checkpoint through
    ``cli.export`` -> ``.isr`` -> ``load_artifact`` as ``sr`` x2 through K1
    (48 per forward, counted), held against the kernels' plain versions;
    (d) ``python -m torch.distributed.run --nproc_per_node 2 -m
    ...cli.train`` on this machine: on one card it must exit non-zero with
    ``distributed_init``'s message, on two or more it trains on distinct
    cards. Step times by CUDA events: one process, world size 1, two ranks
    on one card;
17. the quality experiments: ``scripts/torch_flagship_quality_experiment.py``
    (arms R and F, x4) and ``scripts/torch_denoise_quality_experiment.py``
    (arms R, F and N, refine 2 x 64) through their ``run()`` at full width
    and depth for one epoch each (240 training images, 15 steps; the cuts
    are printed): every result finite, the bicubic baseline within
    ``BASELINE_DB`` of the JAX package's reading, K1 counted on the R eval
    and K2 on every ``--int8`` eval (per forward as the artifact says, and
    nothing outside the evals), then each counted eval's first batch run
    again under the plain versions within ``BF16_MAX_LSB`` /
    ``INT8_CARD_MAX_LSB``; each arm's wall and ms per step printed. Then
    ``scripts/torch_denoise_severity_sweep.py`` over the denoise work dir
    (light and heavy, N also in int8: K2 counted per eval) and
    ``scripts/torch_gan_vs_pixel_experiment.py`` for one epoch per phase
    (x2, depth 2: A, B, C through train, export and evaluate, K1 counted per
    eval and each eval's first batch held against the plain versions);
18. the Winograd trunk and the headline bench: phase 5's ``sr`` x4 d16 w64
    artifact served at b256 t24 by the K1 path (bf16), ``wino_m=2`` (bf16)
    and ``wino_m=4`` (fp32): K1 launches counted (48 per forward on the
    first, none on the others), request ms by CUDA events and peak memory
    for each, a 96x96 crop held against the port's CPU fp32 direct path
    within ``BF16_MAX_LSB`` / ``WINO_BF16_MAX_LSB`` / ``WINO_FP32_MAX_LSB``,
    both Winograd outputs against the K1 path's on the card (crop and batch)
    within ``BF16_MAX_LSB``; a depth-2 ``wino_m=2`` model through
    ``export_program`` -> ``load_program`` bit-equal to eager; then
    ``cli.bench.main`` in each configuration (the default ``fast`` line
    with the ``sr`` diagnostic, ``--int8``, ``--family sr``, ``--family
    denoise_fast``, ``--preset denoise_fullres``) with its chains cut to 1
    and 2: stdout exactly one JSON line with the JAX bench's keys, K1 and
    K2 counted over each run against the forwards it makes.
19. K3, RCAN's channel attention (``csrc/channel_attention.cu``, built in
    phase 2): its ptxas report, then ``ca_residual`` against its plain
    version at ``rcan_x4.frames``' trunk shape 8x270x480x64 (bf16 stream,
    and fp32) and at an 8x96x96 tile batch, within ``KERNEL_ATOL`` +
    ``KERNEL_RTOL`` and a bf16 output at most one ulp away, bitwise the
    same twice, timed beside its plain version and its bound by bytes; then
    RCAN x4 at its published widths (10 groups of 20 blocks, 64 filters)
    through ``.isr`` -> ``load_artifact`` -> ``DeployedModel`` in bf16: a
    48x48 crop against the port's fp32 CPU path within
    ``RCAN_MAX_RMS_LSB`` / ``RCAN_MAX_LSB``, requests at 8x270x480 timed,
    and ``TiledUpscaler`` -> ``rs.video_pipeline`` over three frame
    batches, K3 counted on both (200 ``reduce`` and 200 ``scale`` a
    forward) and the video's frames equal to the model's.
20. K4, BasicVSR's flow warp (``csrc/flow_warp.cu``, built in phase 2): its
    ptxas report, then ``flow_warp`` against its plain version at the
    propagation shape (both branches' states, two 64-channel windows of a
    1x270x480x128 bf16 tensor, into 2x270x480x72 trunk inputs) and at
    SPyNet's finest and coarsest levels (14x288x480x3 and 14x9x15x3
    fp32, border), with flows out of the frame, within ``KERNEL_ATOL_REL *
    max|x| + KERNEL_RTOL |want|``, bitwise the same twice, timed beside
    its plain version, ``F.grid_sample`` on a ready grid and its bound by
    bytes; then BasicVSR x4 at its published widths (width 64, 30 blocks a
    branch, SPyNet's 6 levels) through ``.isr`` -> ``load_artifact`` ->
    ``DeployedModel`` in bf16: a 5-frame 48x64 crop against the port's
    fp32 CPU path within ``BASICVSR_MAX_RMS_LSB`` / ``BASICVSR_MAX_LSB``,
    SPyNet's mean and largest |flow| on a 270x480 segment, a 15-frame
    segment at 270x480 timed (20 K4 launches a segment: 14 propagation,
    one a step for both branches, 6 SPyNet), and ``TiledUpscaler`` -> ``rs.video_pipeline`` over 37
    frames (segments 15, 15 and 7, the last on its valid frames), each
    segment's frames equal to the model's own, K4 counted.

It prints one JSON line of per-kernel numbers (each kernel's launches
summed over the counted runs of phases 5/6 and 9-19, and given by path),
the training timings and the loader's rates, the ``nvidia-smi`` line, and
last ``{"ok": true,
"device": {...}}``. Without CUDA, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from perfbench.roofline.k1 import work as k1_work
from perfbench.roofline.peaks import bound_s, peaks

SEED = 0
ROOT = Path(__file__).resolve().parent
PACKAGE = "image_super_resolution_tpu_torch"
SOURCES = ("fused_rdb", "matmul", "channel_attention", "flow_warp")  # csrc/<name>.cu


def _log(msg: str) -> None:
    print(msg, flush=True)


def _peaks(name: str):
    """(product, bf16 FLOP/s, int8 OP/s, bytes/s) for the card ``name``: the
    benchmark's table (``perfbench/roofline/peaks.py``)."""
    p = peaks(name)
    return p["product"], p["bfloat16"], p["int8"], p["bytes"]


def _bound(ops: float, nbytes: float, peak_ops: float, peak_bw: float):
    """(bound ms, "operations" or "bytes", ops ms, bytes ms): the benchmark's
    ``bound_s`` in ms, beside both of its terms."""
    t, by = bound_s(ops, nbytes, peak_ops, peak_bw)
    return t * 1e3, by, ops / peak_ops * 1e3, nbytes / peak_bw * 1e3


def _cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1 --

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    _log(smi)
    _log(f"[card] torch.cuda.get_device_name(0) = {kind}; devices "
         f"{torch.cuda.device_count()}; torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}")
    return smi, kind


# ------------------------------------------------------------------ phase 2 --

def phase_build():
    from image_super_resolution_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(*SOURCES)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                _log(f"[build] {name}: {line.strip()}")
    built = [n for n, log in logs.items() if log]
    _log(f"[build] nvcc sm_90a {', '.join(SOURCES)} in parallel: built {built} "
         f"in {secs:.1f} s")
    return logs


# ------------------------------------------------------------------ phase 3 --

def _cudnn_scatter_form(x, kernels, bias16, add_rate=0.2, slope=0.01):
    """The scatter-form RDB as five cuDNN bf16 convs (channels_last) with
    PyTorch's elementwise glue: the library yardstick, used nowhere in the
    port. It rounds each conv's output to bf16, as the JAX XLA graph does."""
    import torch.nn.functional as F

    g = x.shape[-1] // 2
    conv = lambda v, k, b=None: F.conv2d(v, k, b, padding=1)  # noqa: E731
    act = lambda v: F.leaky_relu(v, slope)  # noqa: E731
    xn = x.permute(0, 3, 1, 2)
    cx = conv(xn, kernels[0], bias16)
    c0 = conv(act(cx[:, :g]), kernels[1])
    c1 = conv(act(cx[:, g:2 * g] + c0[:, :g]), kernels[2])
    c2 = conv(act(cx[:, 2 * g:3 * g] + c0[:, g:2 * g] + c1[:, :g]), kernels[3])
    c3 = conv(act(cx[:, 3 * g:4 * g] + c0[:, 2 * g:3 * g] + c1[:, g:2 * g]
                  + c2[:, :g]), kernels[4])
    fuse = cx[:, 4 * g:] + c0[:, 3 * g:] + c1[:, 2 * g:] + c2[:, g:] + c3
    return (fuse * add_rate + xn).permute(0, 2, 3, 1)


def _instance(source: str, mangled: str) -> str:
    """A readable name for one kernel instantiation in ptxas's report."""
    import re

    if source == "fused_rdb":
        return "y launches (N=32)" if "ILi32E" in mangled else "last launch (N=64)"
    if source == "channel_attention":
        stream = "fp32" if "IfE" in mangled else "bf16"
        return f"{'reduce' if 'reduce' in mangled else 'scale'}, {stream} stream"
    if source == "flow_warp":
        m = re.search(r"flow_warp_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16)Li(\d+)E", mangled)
        dtype = {"f": "fp32", "13__nv_bfloat16": "bf16"}
        return (f"{dtype[m.group(1)]} -> {dtype[m.group(2)]}, {m.group(3)} channels a thread"
                if m else mangled)
    m = re.search(r"conv3x3_int8_kernelILb([01])ELi([123])ELb([01])ELi(\d+)E", mangled)
    if m:
        ks = "K steps unrolled" if m.group(4) != "0" else "K steps at run time"
        out = {"1": "fp32", "2": "int8", "3": "fp32 + int8"}[m.group(2)]
        res = ", residual" if m.group(3) == "1" else ""
        return f"conv {'fp32' if m.group(1) == '1' else 'int8'} -> {out}{res}, {ks}"
    if "transpose_kernel" in mangled:
        return f"B transpose, {'1' if 'ILi1E' in mangled else '2'}-byte elements"
    return "GEMM bf16" if "bfloat16" in mangled else "GEMM int8"


def _ptxas(source: str, log: str) -> None:
    """One source's ptxas report, one line per kernel instantiation:
    registers, shared memory, spills. Fails on any spill."""
    import re

    if not log:
        _log(f"[kernel] {source} ptxas: library was not rebuilt, no report")
        return
    name, spill_line = None, "spills not reported"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _instance(source, m.group(1))
        elif "spill" in line and name:
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
            if any(spills):
                raise AssertionError(f"{source} spills registers ({name}): {line.strip()}")
            spill_line = line.strip()
        elif "registers" in line and name:
            _log(f"[kernel] {source} ptxas, {name}: {line.split(':', 1)[-1].strip()}; "
                 f"{_dynamic_smem(source, name)}{spill_line}")
            name = None


def _dynamic_smem(source: str, name: str) -> str:
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
    from image_super_resolution_tpu_torch.ops.kernels import matmul as k2

    if source == "fused_rdb":
        n = 32 if "N=32" in name else 64
        return f"{k1._library()[0].isr_fused_rdb_smem_bytes(n)} bytes of dynamic shared memory; "
    if name.startswith("conv"):
        return (f"{k2._library().isr_conv3x3_int8_smem_bytes(k2.MAX_CHUNK)} bytes of dynamic "
                f"shared memory at Cin {k2.MAX_CHUNK}; ")
    if name.startswith("GEMM"):
        return f"{k2._library().isr_matmul_smem_bytes()} bytes of dynamic shared memory; "
    return ""


def phase_k1(kind: str, card: str, ptxas_log: str):
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import DeploySpec, init_fused_params
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
    from image_super_resolution_tpu_torch.ops.scatter import rdb_params_to_scatter

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    fused = init_fused_params(DeploySpec(family="sr", depth=1, width=64, scale=4), SEED)
    mats = [t.to(dev) for t in k1.scatter_params_to_matmul(
        rdb_params_to_scatter(fused["rrdb0"]["rdb0"]))]
    tol = f"|got - want| <= {k1.KERNEL_ATOL} + {k1.KERNEL_RTOL} * |want|"

    def check(b, h, w):
        x = torch.from_numpy(rng.standard_normal((b, h, w, k1.C), np.float32))
        x = x.to(dev, torch.bfloat16)
        got = k1.scatter_rdb(x, *mats)
        want = k1.scatter_rdb_reference(x, *mats)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bad = int((err > k1.KERNEL_ATOL + k1.KERNEL_RTOL * want.float().abs()).sum())
        max_err = float(err.max())
        _log(f"[kernel] fused_rdb B={b} H={h} W={w}: max_abs_err {max_err:.6g}, "
             f"{bad} of {err.numel()} outside {tol}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"fused_rdb disagrees with its plain version at {(b, h, w)}")
        return x, max_err

    _ptxas("fused_rdb", ptxas_log)
    x, max_err = check(256, 24, 24)
    timed = [x]  # b256 t24, video frames (many rectangles a block), ragged
    for shape in ((8, 270, 480), (1, 97, 131)):
        xs, err = check(*shape)
        timed.append(xs)
        max_err = max(max_err, err)
    for shape in ((3, 17, 29), (1, 9, 25), (2, 24, 24), (1, 7, 200), (1, 96, 128)):
        max_err = max(max_err, check(*shape)[1])
    try:
        k1.scatter_rdb(x.float(), *mats)
    except TypeError:
        pass
    else:
        raise AssertionError("fused_rdb took an fp32 CUDA tensor")

    ms = _cuda_ms(lambda: k1.scatter_rdb(x, *mats))
    plain_ms = _cuda_ms(lambda: k1.scatter_rdb_reference(x, *mats), warmup=1, iters=5)
    kernels = []
    for w in mats[:5]:
        cin = w.shape[0] // 9
        kernels.append(w.reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
                       .contiguous(memory_format=torch.channels_last))
    bias16 = mats[5].reshape(-1).to(torch.bfloat16)
    library_ms = _cuda_ms(lambda: _cudnn_scatter_form(x, kernels, bias16))
    lib_err = float((_cudnn_scatter_form(x, kernels, bias16).float()
                     - k1.scatter_rdb_reference(x, *mats).float()).abs().max())

    flops, nbytes = k1_work(*x.shape[:3])
    peak_name, peak_flops, _, peak_bw = _peaks(kind)
    bound_ms, bound_by, t_ops, t_bytes = _bound(flops, nbytes, peak_flops, peak_bw)
    _log(f"[kernel] fused_rdb b256 t24 on {card}: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, cuDNN five-conv scatter form {library_ms:.4f} ms "
         f"(its max_abs_err vs plain {lib_err:.4g}); bound {bound_ms:.4f} ms "
         f"({flops:.4g} FLOP at {peak_flops:.4g}/s = {t_ops:.4f} ms, {nbytes:.4g} B "
         f"at {peak_bw:.4g} B/s = {t_bytes:.4f} ms; {peak_name} peaks); "
         f"{flops / ms / 1e9:.1f} TFLOP/s achieved, {bound_ms / ms:.1%} of bound; "
         f"kernel / cuDNN {ms / library_ms:.3f}")
    for xs in timed:
        _k1_launch_times(xs, mats, kind, card)
    return {
        "name": "fused_rdb",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/fused_rdb.cu",
        "replaces": "image_super_resolution_tpu/ops/pallas/fused_rdb.py:84",
        "launches": None,  # filled in from the sr serving phase
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _k1_launch_times(x, mats, kind: str, card: str) -> None:
    """K1 on input ``x`` timed (CUDA events) whole and each of its five
    launches alone, with its FLOP and rate (which launch leads), beside the
    share of its bound and the persistent grid: rectangles a launch,
    blocks, and their ratio (how far each block's load ring runs on)."""
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1

    weights, bias = mats[:5], mats[5]
    out, y = k1._launch(x, weights, bias, 0.2, 0.01)
    b, h, w = x.shape[:3]
    pixels = b * h * w
    ms = _cuda_ms(lambda: k1._launch(x, weights, bias, 0.2, 0.01, y=y, out=out))
    flops, nbytes = k1_work(b, h, w)
    _, peak_flops, _, peak_bw = _peaks(kind)
    bound_ms = _bound(flops, nbytes, peak_flops, peak_bw)[0]
    tiles, grid = k1._schedule(x)
    parts = []
    for i, launch in enumerate(k1.dense_plan()):
        ms_i = _cuda_ms(lambda: k1._launch(x, weights, bias, 0.2, 0.01, only=i, y=y, out=out))
        flops_i = 2 * pixels * 9 * k1.G * len(launch["groups"]) * launch["n"]
        parts.append(f"{i}: {ms_i:.4f} ms ({flops_i / ms_i / 1e9:.1f} TFLOP/s)")
    _log(f"[kernel] fused_rdb B={b} H={h} W={w} on {card}: {ms:.4f} ms a call, "
         f"{bound_ms / ms:.1%} of its {bound_ms:.4f} ms bound; {tiles} rectangles on {grid} "
         f"blocks a launch, {tiles / grid:.3f} a block; per launch {'; '.join(parts)}")


# ------------------------------------------------------------------ phase 4 --

def _int_mm(a, b):
    """``torch._int_mm`` (cuBLASLt int8 -> int32), K2's yardstick, used
    nowhere in the port. Builds differ in the layout of B they take; the
    first one taken is timed."""
    import torch

    try:
        torch._int_mm(a, b)
    except RuntimeError:
        b = b.t().contiguous().t()
        torch._int_mm(a, b)
    return lambda: torch._int_mm(a, b)


# The conv sites of the fast int8 forward (models/quantized.int8_forward):
# (name, fp32 input, outputs, residual epilogue).
K2_SITES = (("block 0's conv0", True, "int8", False),
            ("conv0 sites 1-13", False, "int8", False),
            ("conv1 sites 0-12", False, "both", True),
            ("the last conv1", False, "int8", True),
            ("trunk_conv", False, "fp32", True))


def _k2_per_forward(depth: int) -> dict:
    """K2's launches by variant in one int8 forward at ``depth`` >= 1:
    block 0's conv0 "fp32 -> int8"; the other conv0 sites and the last
    conv1 "int8 -> int8"; the other conv1 sites (fp32 and int8 out) and
    trunk_conv "int8 -> fp32"."""
    return {"fp32 -> int8": 1, "int8 -> int8": depth, "int8 -> fp32": depth}


def phase_k2(kind: str, card: str, ptxas_log: str):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from image_super_resolution_tpu_torch.ops.kernels import matmul as k2

    _ptxas("matmul", ptxas_log)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    peak_name, peak_bf16, peak_int8, peak_bw = _peaks(kind)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, torch.bfloat16)

    for m, k, n in ((1024, 2048, 1024), (777, 1152, 130)):
        a, b = i8(m, k), i8(k, n)
        got, want = k2.matmul(a, b), k2.matmul_reference(a, b)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        _log(f"[kernel] matmul int8 {m}x{k}x{n}: {bad} of {got.numel()} values "
             f"differ from the exact product (tolerance: none)")
        if bad or got.dtype != torch.int32:
            raise AssertionError(f"matmul int8 is not exact at {(m, k, n)}")
        a, b = bf16(m, k), bf16(k, n)
        got, want = k2.matmul(a, b), k2.matmul_reference(a, b)
        tol = k2.BF16_ATOL_PER_K * k * float(a.float().abs().max() * b.float().abs().max())
        err = float((got - want).abs().max())
        _log(f"[kernel] matmul bf16 {m}x{k}x{n}: max_abs_err {err:.4g} against "
             f"float64 (tolerance 2^-22 * K * max|a| * max|b| = {tol:.4g})")
        if not err <= tol:
            raise AssertionError(f"matmul bf16 outside its tolerance at {(m, k, n)}")

    def site(b, h, w, cin=128, cout=128):
        deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.uniform(-1, 1, cout).astype(np.float32)).to(dev)
        return i8(b, h, w, cin), i8(9 * cin, cout), deq, bias

    # The fp32 stream is requantized on load (scale 1/inv_x); ties and values
    # past +-127 steps are planted in it. int8 outputs are requantized with
    # out_inv_x; the residual epilogue adds res + y * rate.
    inv_x, out_inv_x, rate = 0.25, 1.0, 0.2

    def stream(shape):
        h32 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 40)
        h32[..., :4] = torch.tensor([0.5, -2.5, 300.0, -1e6]) / inv_x
        return h32.to(dev)

    def site_kw(outs, residual, res):
        return dict(out_inv_x=None if outs == "fp32" else out_inv_x, keep_fp32=outs == "both",
                    res=res if residual else None, rate=rate)

    # Every variant (fp32 or int8 in; fp32, int8 or both out; with and
    # without the residual; leaky on and off) at the serving shape, the
    # denoise_fast and CLI tile shapes, a ragged batch, and the small and
    # odd-Cout shapes of tests/test_torch_cuda.py.
    max_err = 0.0
    for shape in ((256, 24, 24, 128, 128), (2, 48, 48, 128, 128), (1, 93, 93, 128, 128),
                  (3, 17, 29, 128, 128), (1, 1, 1, 32, 8), (1, 5, 3, 64, 130)):
        x8, w_q, deq, bias = site(*shape)
        w_k = k2.weights_k_major(w_q)
        x32 = stream(x8.shape)
        res = stream((*shape[:3], shape[4])) * 0.01
        bad = total = 0
        for x, s_in in ((x32, inv_x), (x8, None)):
            for outs in ("fp32", "int8", "both"):
                for residual in (False, True):
                    for leaky in (True, False):
                        kw = site_kw(outs, residual, res)
                        got = k2.conv3x3_int8(x, w_q, deq, bias, leaky, s_in, w_k=w_k, **kw)
                        want = k2.conv3x3_int8_reference(x, w_q, deq, bias, leaky, s_in, **kw)
                        torch.cuda.synchronize()
                        for g, wt in zip(got if outs == "both" else (got,),
                                         want if outs == "both" else (want,)):
                            if g.dtype != wt.dtype:
                                raise AssertionError(f"conv3x3_int8 returned {g.dtype}")
                            bad += int((g != wt).sum())
                            total += g.numel()
                            max_err = max(max_err, float((g.float() - wt.float()).abs().max()))
        _log(f"[kernel] conv3x3_int8 {shape[:3]} {shape[3]}->{shape[4]}, 24 variants (fp32 "
             f"or int8 in; fp32, int8 or both out; residual or not; leaky on and off): {bad} "
             f"of {total} values differ from the plain version (tolerance: none)")
        if bad:
            raise AssertionError(f"conv3x3_int8 disagrees with its plain version at {shape}")

    x8, w_q, deq, bias = site(256, 24, 24)
    w_k = k2.weights_k_major(w_q)
    h32 = stream(x8.shape)
    res = h32 * 0.01
    b, h, w, c = x8.shape
    m = b * h * w
    ops = 2 * m * 9 * c * c
    variants = {}
    for name, f32_in, outs, residual in K2_SITES:
        x, s_in = (h32, inv_x) if f32_in else (x8, None)
        kw = site_kw(outs, residual, res)
        ms = _cuda_ms(lambda: k2.conv3x3_int8(x, w_q, deq, bias, True, s_in, w_k=w_k, **kw))
        plain_ms = _cuda_ms(lambda: k2.conv3x3_int8_reference(x, w_q, deq, bias, True, s_in,
                                                              **kw), warmup=1, iters=3)
        out_bytes = {"fp32": 4, "int8": 1, "both": 5}[outs] + 4 * residual
        nbytes = m * c * (4 if f32_in else 1) + w_k.numel() + 8 * c + m * c * out_bytes
        bound_ms, bound_by, t_ops, t_bytes = _bound(ops, nbytes, peak_int8, peak_bw)
        # launches: filled in from the fast int8 serving phase
        variants[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
        _log(f"[kernel] conv3x3_int8 {name} b256 t24 w128 on {card}: {ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms by {bound_by} ({ops:.4g} int8 OP at {peak_int8:.4g}/s = "
             f"{t_ops:.4f} ms, {nbytes:.4g} B at {peak_bw:.4g} B/s = {t_bytes:.4f} ms; "
             f"{peak_name} peaks), {bound_ms / ms:.1%} of bound, {ops / ms / 1e9:.1f} TOP/s "
             f"achieved; plain version {plain_ms:.4f} ms")
    main = variants["trunk_conv"]
    xb = x8.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
    wb = w_q.to(torch.bfloat16).reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    library_ms = _cuda_ms(lambda: F.conv2d(xb, wb, padding=1))
    int_mm_site_ms = _cuda_ms(_int_mm(i8(m, 9 * c), w_q))
    _log(f"[kernel] conv3x3_int8 yardsticks b256 t24 w128 on {card}: cuDNN bf16 conv "
         f"channels_last {library_ms:.4f} ms; torch._int_mm on its GEMM form ({m}x{9 * c}x{c}, "
         f"no im2col) {int_mm_site_ms:.4f} ms; trunk_conv kernel / cuDNN "
         f"{main['ms'] / library_ms:.3f}")

    n = 4096
    a, bm = i8(n, n), i8(n, n)
    mm_ms = _cuda_ms(lambda: k2.matmul(a, bm))
    mm_plain_ms = _cuda_ms(lambda: k2.matmul_reference(a, bm), warmup=1, iters=3)
    int_mm_ms = _cuda_ms(_int_mm(a, bm))
    a16, b16 = bf16(n, n), bf16(n, n)
    mm16_ms = _cuda_ms(lambda: k2.matmul(a16, b16))
    mm16_plain_ms = _cuda_ms(lambda: k2.matmul_reference(a16, b16), warmup=1, iters=3)
    torch16_ms = _cuda_ms(lambda: torch.matmul(a16, b16))
    ops = 2 * n ** 3
    b8, _, o8, _ = _bound(ops, 2 * n * n + 4 * n * n, peak_int8, peak_bw)
    b16_bound, _, _, _ = _bound(ops, 4 * n * n + 4 * n * n, peak_bf16, peak_bw)
    _log(f"[kernel] matmul 4096^3 on {card}: int8 kernel {mm_ms:.4f} ms "
         f"({ops / mm_ms / 1e9:.1f} TOP/s), plain (float64) {mm_plain_ms:.4f} ms, "
         f"torch._int_mm {int_mm_ms:.4f} ms, bound {b8:.4f} ms by operations; "
         f"bf16 kernel {mm16_ms:.4f} ms ({ops / mm16_ms / 1e9:.1f} TFLOP/s), plain "
         f"(float64) {mm16_plain_ms:.4f} ms, torch.matmul bf16 {torch16_ms:.4f} ms, bound "
         f"{b16_bound:.4f} ms by operations; both kernel times include the transposed copy "
         f"of B")
    return {
        "name": "conv3x3_int8",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/matmul.cu",
        "replaces": "scripts/bench_int8_pallas.py:37",
        "launches": None,  # filled in from the fast int8 serving phase
        "max_abs_err": max_err,
        "ms": main["ms"],  # trunk_conv
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": library_ms,
        "variants": variants,
        "matmul_4096": {"int8_ms": mm_ms, "int8_plain_ms": mm_plain_ms, "int_mm_ms": int_mm_ms,
                        "bf16_ms": mm16_ms, "bf16_plain_ms": mm16_plain_ms,
                        "torch_matmul_bf16_ms": torch16_ms},
    }


# ------------------------------------------------------------------ phase 5 --

def _serve(model, x, n: int):
    """One request, then ``n`` timed by the host clock (synchronized):
    (ms per request, last output)."""
    import torch

    out = model(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = model(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, out


def _lsb(got, want) -> tuple:
    """(max, share of values that differ) of two uint8 arrays."""
    import numpy as np

    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return int(diff.max()), float((diff > 0).mean())


def phase_sr(work: Path, card: str):
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_MAX_LSB, DeploySpec, init_fused_params, load_artifact, save_artifact)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb

    spec = DeploySpec(family="sr", depth=16, width=64, scale=4)
    isr = work / "sr_x4_d16_w64.isr"
    save_artifact(isr, spec, init_fused_params(spec, SEED))
    t0 = time.perf_counter()
    deployed = load_artifact(isr, dtype=torch.bfloat16, device="cuda")
    load_s = time.perf_counter() - t0

    b, t, s = 256, 24, spec.scale
    x = np.random.default_rng(SEED + 1).integers(0, 256, (b, t, t, 3), dtype=np.uint8)
    xd = torch.from_numpy(x).cuda()
    torch.cuda.reset_peak_memory_stats()
    per_forward = 3 * spec.depth
    n = 5
    scatter_rdb.launches = 0
    ms, out = _serve(deployed, xd, n)
    launches = scatter_rdb.launches
    if launches != per_forward * (n + 1):
        raise AssertionError(f"fused_rdb launched {launches} times in {n + 1} "
                             f"forwards, want {per_forward} per forward")
    if out.dtype != torch.uint8 or tuple(out.shape) != (b, t * s, t * s, 3):
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    mpix = b * (t * s) ** 2 / (ms / 1e3) / 1e6
    _log(f"[serve] sr x4 d16 w64 bf16 b{b} t{t} on {card}: {ms:.3f} ms/iter "
         f"(host clock over {n} requests after one), {mpix:.2f} output MPix/s; "
         f"fused_rdb launches {launches} ({per_forward} per forward); artifact "
         f"load {load_s:.2f} s; peak memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ref = load_artifact(isr, dtype=torch.float32, device="cpu")(x[:2]).numpy()
    worst, share = _lsb(out[:2].cpu(), ref)
    _log(f"[serve] 2 tiles, card bf16 vs CPU fp32: max {worst} LSB "
         f"(bound {BF16_MAX_LSB}), {share:.4f} of values differ")
    if worst > BF16_MAX_LSB:
        raise AssertionError("card bf16 output is outside the recorded bound")
    return isr, launches


def _event():
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


# ------------------------------------------------------------------ phase 6 --

def phase_fast(work: Path, card: str):
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import (
        FAST_BF16_MAX_LSB, DeploySpec, init_fused_params, load_artifact, save_artifact)
    from image_super_resolution_tpu_torch.models.quantized import (
        INT8_CARD_MAX_LSB, Int8DeployedFast, quantize_deployed)
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    spec = DeploySpec(family="fast", depth=14, width=128, scale=4)
    isr = work / "fast_x4_d14_w128.isr"
    save_artifact(isr, spec, init_fused_params(spec, SEED))
    deployed = load_artifact(isr, dtype=torch.bfloat16, device="cuda")
    b, t, s = 256, 24, spec.scale
    x = np.random.default_rng(SEED + 4).integers(0, 256, (b, t, t, 3), dtype=np.uint8)
    xd = torch.from_numpy(x).cuda()
    sites = 2 * spec.depth + 1
    n = 5

    conv3x3_int8.launches = 0
    bf16_ms, out16 = _serve(deployed, xd, n)
    if conv3x3_int8.launches != 0:
        raise AssertionError("the bf16 fast forward launched conv3x3_int8")
    t0 = time.perf_counter()
    quant = quantize_deployed(deployed, [xd])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0

    conv3x3_int8.launches = 0
    conv3x3_int8.launches_by_variant.clear()
    int8_ms, out8 = _serve(quant, xd, n)
    launches = conv3x3_int8.launches
    by_variant = dict(conv3x3_int8.launches_by_variant)
    if launches != sites * (n + 1):
        raise AssertionError(f"conv3x3_int8 launched {launches} times in {n + 1} "
                             f"int8 forwards, want {sites} per forward")
    # every site but block 0's conv0 is handed its input in int8
    per_forward = _k2_per_forward(spec.depth)
    if by_variant != {k: v * (n + 1) for k, v in per_forward.items()}:
        raise AssertionError(f"conv3x3_int8 launches by variant in {n + 1} int8 forwards: "
                             f"{by_variant}, want {per_forward} per forward")
    for out in (out16, out8):
        if out.dtype != torch.uint8 or tuple(out.shape) != (b, t * s, t * s, 3):
            raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    for name, ms in (("bf16", bf16_ms), ("int8", int8_ms)):
        _log(f"[serve] fast x4 d14 w128 {name} b{b} t{t} on {card}: {ms:.3f} ms/request "
             f"(host clock over {n} requests after one), "
             f"{b * (t * s) ** 2 / (ms / 1e3) / 1e6:.2f} output MPix/s")
    _log(f"[serve] fast int8: conv3x3_int8 launches {launches} ({sites} per forward, "
         f"0 in the bf16 forwards; by variant {by_variant} in {n + 1} forwards); calibration + quantization {calib_s:.2f} s; int8 / bf16 "
         f"request time {int8_ms / bf16_ms:.3f} (host clock)")

    ref32 = load_artifact(isr, dtype=torch.float32, device="cpu")(x[:2])
    worst16, share16 = _lsb(out16[:2].cpu(), ref32)
    ref8 = Int8DeployedFast(spec, quant.params, device="cpu")(x[:2])
    worst8, share8 = _lsb(out8[:2].cpu(), ref8)
    diff = np.abs(out8.cpu().numpy().astype(int) - out16.cpu().numpy().astype(int))
    _log(f"[serve] fast, 2 tiles: card bf16 vs CPU fp32 max {worst16} LSB (bound "
         f"{FAST_BF16_MAX_LSB}), {share16:.4f} differ; card int8 vs CPU int8 on the "
         f"same quantized params max {worst8} LSB (bound {INT8_CARD_MAX_LSB}), "
         f"{share8:.4f} differ; whole batch card int8 vs card bf16 mean "
         f"{diff.mean():.4f} max {diff.max()} LSB (bound mean < 1, max <= 8)")
    if worst16 > FAST_BF16_MAX_LSB or worst8 > INT8_CARD_MAX_LSB:
        raise AssertionError("fast card output is outside its recorded bound")
    if not (diff.mean() < 1.0 and diff.max() <= 8):
        raise AssertionError("fast int8 drifted from bf16 beyond the JAX package's bound")
    _fast_percentile(deployed, quant, xd, out16, spec, card)
    return isr, launches, {k: {"launches": v, "launches_per_forward": v // (n + 1)}
                           for k, v in by_variant.items()}


def _fast_percentile(deployed, amax, xd, out16, spec, card):
    """int8 calibrated at the 99.9th percentile of |x| on the whole b256
    t24 batch: 147,456 x 128 values per site, above torch.quantile's 2^24.
    The card's percentile equals the CPU's on one such tensor; every site's
    scale is at most its amax scale; one request launches K2 29 times and
    stays within the JAX package's int8 bound of bf16 (mean < 1, max <= 8)."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.quantized import (
        linear_percentile, quantize_deployed, trunk_sites)
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    big = torch.from_numpy(np.abs(np.random.default_rng(SEED + 6).standard_normal(
        147456 * 128, dtype=np.float32)))
    on_card = float(linear_percentile(big.cuda(), 99.9))
    on_cpu = float(linear_percentile(big, 99.9))
    if on_card != on_cpu:
        raise AssertionError(f"percentile on the card {on_card} != CPU {on_cpu}")
    t0 = time.perf_counter()
    quant = quantize_deployed(deployed, [xd], percentile=99.9)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    sites = list(trunk_sites(spec.depth))
    ratio = [amax.params[s]["inv_x"] / quant.params[s]["inv_x"] for s in sites]
    if max(ratio) > 1.0 + 1e-6 or min(ratio) >= 1.0:
        raise AssertionError(f"p99.9 scales / amax scales {min(ratio)}..{max(ratio)}: "
                             f"want all <= 1 and some < 1")
    conv3x3_int8.launches = 0
    out = quant(xd)
    torch.cuda.synchronize()
    if conv3x3_int8.launches != len(sites):
        raise AssertionError(f"p99.9 int8 launched conv3x3_int8 {conv3x3_int8.launches} "
                             f"times, want {len(sites)}")
    if out.dtype != torch.uint8 or out.shape != out16.shape:
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    diff = np.abs(out.cpu().numpy().astype(int) - out16.cpu().numpy().astype(int))
    _log(f"[serve] fast int8 p99.9 on {card}: percentile of {big.numel()} values card "
         f"== CPU ({on_card:.7g}); calibration + quantization on b{xd.shape[0]} "
         f"t{xd.shape[1]} {calib_s:.2f} s; scales {min(ratio):.4f}..{max(ratio):.4f} "
         f"of amax; conv3x3_int8 launches {conv3x3_int8.launches}; vs card bf16 mean "
         f"{diff.mean():.4f} max {diff.max()} LSB (bound mean < 1, max <= 8)")
    if not (diff.mean() < 1.0 and diff.max() <= 8):
        raise AssertionError("p99.9 int8 drifted from bf16 beyond the JAX package's bound")


# ------------------------------------------------------------------ phase 7 --

def phase_denoise(card: str):
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli.rs import _grid_crops
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.models.deploy import (
        DeployedModel, DeploySpec, init_fused_params)
    from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    spec = DeploySpec(family="denoise_fast", depth=14, width=128, downshuffle=2)
    deployed = DeployedModel(spec, init_fused_params(spec, SEED + 5),
                             dtype=torch.bfloat16, device="cuda")
    img = np.random.default_rng(SEED + 5).integers(0, 256, (301, 203, 3), dtype=np.uint8)
    quant = quantize_deployed(deployed, [np.stack(_grid_crops(img, 96, 2, 4))])
    window, overlap, batch = 96, 8, 8
    engine = TiledUpscaler(quant, window=window, overlap=overlap, batch_size=batch)
    conv3x3_int8.launches = 0
    out = engine.upscale_image(img)
    tiles = len(plan_tiles(*img.shape[:2], window, overlap)[0])
    want = (2 * spec.depth + 1) * -(-tiles // batch)
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"denoise_fast wrote {out.shape} {out.dtype} for {img.shape}")
    if conv3x3_int8.launches != want:
        raise AssertionError(f"denoise_fast int8 launched conv3x3_int8 "
                             f"{conv3x3_int8.launches} times, want {want}")
    _log(f"[serve] denoise_fast d14 w128 ds2 int8 on {card}: one {img.shape[1]}x"
         f"{img.shape[0]} image through TiledUpscaler ({tiles} tiles of {window}, "
         f"batch {batch}): output {out.shape}, conv3x3_int8 launches {want}")


# ------------------------------------------------------------------ phase 8 --

def phase_cli(work: Path, sr_isr: Path, fast_isr: Path, card: str):
    import numpy as np

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8
    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(SEED + 2)
    src = work / "in"
    src.mkdir()
    sizes = {"photo": (384, 512), "odd": (77, 53)}
    for name, hw in sizes.items():
        write_png(src / f"{name}.png", rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    window, overlap, batch = 96, 8, 8  # the CLI's defaults
    chunks = 0
    for h, w in sizes.values():
        tiles = plan_tiles(h, w, min(window, max(h, w) + 2 * overlap), overlap)[0]
        chunks += -(-len(tiles) // batch)
    runs = (("sr bf16", sr_isr, [], scatter_rdb, 48),
            ("fast --int8", fast_isr, ["--int8"], conv3x3_int8, 29))
    for title, isr, flags, kernel, per_chunk in runs:
        dst = work / f"out_{kernel.__name__}"
        kernel.launches = 0
        t0 = time.perf_counter()
        rs.main(["--model", str(isr), "--src", str(src), "--save_dir", str(dst), *flags])
        secs = time.perf_counter() - t0
        if kernel.launches != per_chunk * chunks:
            raise AssertionError(f"rs ({title}) launched {kernel.__name__} "
                                 f"{kernel.launches} times, want {per_chunk * chunks}")
        for name, (h, w) in sizes.items():
            got = read_png(dst / f"{name}.png")
            if got.shape != (4 * h, 4 * w, 3):
                raise AssertionError(f"rs ({title}) wrote {got.shape} for {name} {(h, w)}")
        _log(f"[cli] rs {title} --device cuda on {card}, 2 PNGs "
             f"{list(sizes.values())}: x4 outputs, {kernel.__name__} launches "
             f"{kernel.launches}, {secs:.2f} s wall")


# ------------------------------------------------------------------ phase 9 --

# The training runs of the main path, each through cli.train.main at the
# CLI defaults (batch 16, patch 96) for one epoch: (key, title, flags).
# Run (d), the GAN phase, trains in run (a)'s --work_dir, so that its
# generator warm-starts from (a)'s pixel checkpoint.
TRAIN_RUNS = (
    ("a", "sr x2 d16 w64 BN (--resnet)", ["--resnet", "--family", "sr", "--scale", "2"]),
    ("b", "fast x4 d14 w128 (--resnet)", ["--resnet", "--family", "fast", "--scale", "4"]),
    ("c", "Denoiser d16 w64 BN (--train_denoise)", ["--train_denoise"]),
    ("d", "sr x2 d16 w64 BN GAN (D 3-64-8-1024, VGG19 (5, 4) random features)",
     ["--family", "sr", "--scale", "2"]),
)
TRAIN_DIRS = {"a": "a", "b": "b", "c": "c", "d": "a"}
CKPT_GLOB = {"a": "res_*.ckpt", "b": "res_*.ckpt", "c": "denoise_*.ckpt", "d": "gen_*.ckpt"}
TRAIN_IMAGES, TRAIN_SIZE = 64, 192
# Three pixel steps at depth 2 in fp32 (TF32 off), card against CPU: each
# loss within 1e-5 relative; every gradient element within 1e-3 of the
# model's largest gradient (cuDNN and the CPU sum in other orders, and a
# weight gradient sums thousands of terms that cancel: measured 2.1e-4 on an
# H100; a tensor's own largest is no scale, since BN makes some gradients,
# such as a BN bias whose shift the next BN removes, nearly zero but for
# border terms); BN running statistics and their EMA within 1e-5. The
# optimizers then take the same gradients (the CPU's), so the params and
# their EMA agree to fp32 rounding: within 1e-6 of max(1, |param|), where a
# no-op or a wrong Adam is off by about lr = 1e-3.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_STATS_ATOL = 1e-5, 1e-3, 1e-5
STEP_PARAM_RTOL = 1e-6
# The three GAN steps, card against CPU: the BCE losses sit on D's logits,
# which sum 36 * 512 features through seven BNs: measured within 1.95e-5
# relative on an H100 (bound GAN_LOSS_RTOL). Gradients are held as the
# pixel steps' (each element within STEP_GRAD_RTOL of the model's largest),
# but for at most GAN_FLIP_SHARE of a model's elements: a leaky ReLU's
# slope changes at 0, and where a pre-activation lies within the two
# devices' rounding of 0 they back-propagate through different slopes,
# both right; with four images that moves a whole output channel's weight
# gradient (measured: 225 elements of D's block1 kernel, one channel's 576,
# off by up to 4.8e-3 of D's largest gradient; 9.5e-6 of D's elements).
# Relative L2 errors are printed beside them.
GAN_LOSS_RTOL, GAN_FLIP_SHARE = 1e-4, 1e-3


class _Preempted(Exception):
    """Raised after the first checkpoint of runs (a) and (d): the run stops
    there, as a preempted job would, leaving a mid-run checkpoint with its
    optimizer(s)."""


class _Tee:
    """stdout that also keeps what was written (for lines the CLI prints)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _train_images(folder: Path, seed: int) -> Path:
    """TRAIN_IMAGES smooth RGB PNGs (sums of random low-frequency waves)
    under ``folder/png``, and their manifest written by the port's
    ``cli.create_json``."""
    import numpy as np

    from image_super_resolution_tpu_torch.cli import create_json
    from image_super_resolution_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    (folder / "png").mkdir(parents=True)
    yy, xx = np.mgrid[0:TRAIN_SIZE, 0:TRAIN_SIZE] / TRAIN_SIZE
    paths = []
    for i in range(TRAIN_IMAGES):
        img = np.zeros((TRAIN_SIZE, TRAIN_SIZE, 3))
        for _ in range(4):
            fy, fx, phase = rng.uniform(1, 12), rng.uniform(1, 12), rng.uniform(0, 6.3, 3)
            img += np.sin(2 * np.pi * (fy * yy + fx * xx)[..., None] + phase) * rng.uniform(10, 40)
        path = folder / "png" / f"{i:03d}.png"
        write_png(path, np.clip(img + 128, 0, 255).astype(np.uint8))
        paths.append(path.as_posix())
    manifest, _ = create_json.main(["--train_dirs", str(folder / "png"), "--shape", "96",
                                    "--output", str(folder)])
    if json.loads(manifest.read_text()) != paths:
        raise AssertionError(f"create_json listed {manifest.read_text()[:200]}, want the "
                             f"{TRAIN_IMAGES} PNGs written")
    return manifest


def _train_argv(flags, manifest: Path, work: Path, device: str, *more):
    return [*flags, "--train_json", str(manifest), "--work_dir", str(work),
            "--no_tensorboard", "--device", device, *more]


def _check_history(title: str, history, card: str) -> None:
    """Every epoch: finite losses and no substituted patch."""
    import math

    for h in history:
        metrics = {k: sum(v) / len(v) for k, v in h["metrics"].items()}
        _log(f"[train] {title} on {card}: epoch {h['epoch']} mean loss {h['mean_loss']:.5f}, "
             f"{h['patches_per_sec']:.1f} patches/s (CLI, host clock), "
             f"{h['substituted']} substituted patches"
             + ("; means " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items())
                if len(metrics) > 1 else "")
             + ("; eval " + ", ".join(f"{k} {v:.4f}" for k, v in h["eval"].items())
                if "eval" in h else ""))
        if not all(math.isfinite(v) for vs in h["metrics"].values() for v in vs):
            raise AssertionError(f"{title}: non-finite loss {h['metrics']}")
        if h["substituted"]:
            raise AssertionError(f"{title}: {h['substituted']} patches were substituted")


def _forward_flop(model, x) -> int:
    """Conv and dense FLOP of one forward: 2 * output elements * (Cin/groups)
    * k * k of every ConvBlock, 2 * N * in * out of every DenseBlock, read
    from hooks during one no-grad forward."""
    import torch

    from image_super_resolution_tpu_torch.ops.conv import ConvBlock, DenseBlock

    total = [0]

    def hook(mod, _inp, out):
        if isinstance(mod, DenseBlock):
            total[0] += 2 * out.numel() * mod.dense.weight.shape[1]
            return
        w = mod.conv.weight
        total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (ConvBlock, DenseBlock))]
    training = model.training
    try:
        with torch.no_grad():
            model.eval()
            model(x)
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    return total[0]


def _vgg_flop(vgg, n: int, h: int, w: int) -> int:
    """Conv FLOP of one TruncatedVGG19 forward on n x h x w: 2 * H * W *
    Cin * Cout * 9 per conv at its resolution (the max-pools halve it)."""
    total, k = 0, 0
    for item in vgg.plan:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        wt = getattr(vgg, f"conv{k}").weight
        total += 2 * n * h * w * wt.shape[0] * wt.shape[1] * 9
        k += 1
    return total


def _time_training(key: str, title: str, argv, kind: str, card: str) -> dict:
    """The run's step outside the counted CLI run, on one device batch from
    its loader: ms per step by CUDA events after warm-up, patches/s, peak
    memory, the step's parts by CUDA events (pixel and denoise: batch prep,
    forward + loss, backward, clip + Adam, BN commit + EMA; GAN: the parts
    its step marks, ``train.steps.GAN_PARTS``), the device's idle share and
    top kernels by torch.profiler, and the bound: the step's conv and dense
    FLOP at the bf16 peak -- 3x the forward's (forward, input and weight
    gradients); in the GAN phase 3 G + 8 D + 3 VGG forwards (D and VGG on
    sr in G's loss: forward + input gradient; VGG on hr: forward; D's own
    step: two forwards with their gradients, 3x each). The idle share is 1
    - the profiler's kernel time / the unprofiled step time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.train.steps import GAN_PARTS

    run = cli_train.Run(cli_train.build_parser().parse_args(argv))
    u8 = torch.from_numpy(np.ascontiguousarray(next(iter(run.loader)))).to(run.device)
    fn, st = run.step_fn, run.state
    gan = run.phase == "gan"
    for _ in range(3):
        run.step(u8)
    run.sync()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    step_ms = _cuda_ms(lambda: run.step(u8), warmup=0, iters=n)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bs = u8.shape[0]

    names = GAN_PARTS if gan else ("batch prep", "forward + loss", "backward", "clip + Adam",
                                   "BN commit + EMA")
    parts = {k: 0.0 for k in names}
    for _ in range(5):
        ev = [_event()]
        if gan:
            fn(st, run.d_state, u8, lambda part: ev.append(_event()))
        else:
            hr, lr = fn.batch_fn(u8, run.gen) if run.gen is not None else fn.batch_fn(u8)
            ev.append(_event())
            loss = fn.loss_fn(st.model(lr), hr)
            ev.append(_event())
            loss.backward()
            ev.append(_event())
            st.clip_and_adam()
            ev.append(_event())
            st.commit_and_ema()
            ev.append(_event())
        run.sync()
        if len(ev) != len(names) + 1:
            raise AssertionError(f"{title}: {len(ev) - 1} parts marked, want {len(names)}")
        for name, a, b in zip(names, ev, ev[1:]):
            parts[name] += a.elapsed_time(b) / 5

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            run.step(u8)
        run.sync()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3 / 5
    busy = sum(kernels.values())
    idle = 1 - busy / step_ms if busy else None

    hr, lr = fn.batch_fn(u8, run.gen) if run.gen is not None else fn.batch_fn(u8)
    flop = 3 * _forward_flop(st.model, lr)
    what = "3x the forward's convs"
    if gan:
        f_d = _forward_flop(run.d_state.model, hr)
        f_v = _vgg_flop(fn.perceptual.vgg, *hr.shape[:3])
        flop += 8 * f_d + 3 * f_v
        what = (f"3x G's forward + 8x D's ({f_d:.4g} FLOP) + 3x VGG's ({f_v:.4g} FLOP), "
                f"convs and dense")
    peak_name, peak_bf16, _, _ = _peaks(kind)
    bound_ms = flop / peak_bf16 * 1e3
    n_params = sum(p.numel() for p in st.params)
    if gan:
        n_params = f"{n_params:,} G + {sum(p.numel() for p in run.d_state.params):,} D"
    else:
        n_params = f"{n_params:,}"
    _log(f"[train] {title} b{bs} patch {u8.shape[1]} on {card}: step {step_ms:.4f} ms (CUDA "
         f"events, mean of {n} after 3 warm-up), {bs / step_ms * 1e3:.1f} patches/s; peak "
         f"memory {peak_gib:.3f} GiB; bound {bound_ms:.4f} ms ({flop:.4g} FLOP = {what} at "
         f"{peak_bf16:.4g} FLOP/s, {peak_name}), {bound_ms / step_ms:.1%} of bound; "
         f"{n_params} params")
    for name, ms in parts.items():
        _log(f"[breakdown] train {key} on {card}: part {name:24s} {ms:9.4f} ms  "
             f"{ms / step_ms:6.1%}")
    _log(f"[breakdown] train {key} on {card}: profiler: device kernel time {busy:.4f} ms per "
         f"step; idle share " + (f"{idle:.1%} of the {step_ms:.4f} ms step (CUDA events, "
         f"unprofiled; {1 - busy / wall:.1%} of the {wall:.4f} ms host wall under the "
         f"profiler, which adds its own time)" if busy else "not measured (no device events)"))
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        _log(f"[breakdown] train {key}: kernel {ms:9.4f} ms  {ms / max(busy, 1e-9):6.1%}  "
             f"{name[:90]}")
    return {"step_ms": step_ms, "patches_per_sec": bs / step_ms * 1e3, "idle": idle,
            "peak_gib": peak_gib, "bound_ms": bound_ms, "parts": parts, "wall_ms": wall}


def _serve_trained(work: Path, card: str, device: str) -> dict:
    """Each run's final checkpoint through build_deployed on the card (bf16,
    EMA weights, BN folded; depth and width read from the checkpoint), K1
    and K2 counted per forward, two tiles held against the port's CPU path
    on the same checkpoint."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_MAX_LSB, BF16_X2_MAX_LSB, DENOISE_BF16_MAX_LSB, DeploySpec, build_deployed,
        infer_family_dims)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb

    paths = json.loads((work / "data" / "train_images.json").read_text())
    x = np.stack([read_image_rgb(p)[8:56, 16:64] for p in paths[:16]])  # b16 48x48
    ckpts = {key: load_checkpoint(_checkpoint(work, key)) for key in "abc"}
    n, counts = 3, {}

    def spec_of(key, family, **kw):
        depth, width = infer_family_dims(ckpts[key]["params"], family)
        return DeploySpec(family=family, depth=depth, width=width, **kw)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    spec = spec_of("a", "sr", scale=2)
    sr, _ = build_deployed(ckpts["a"], spec, dtype=torch.bfloat16, device=device)
    scatter_rdb.launches = 0
    for _ in range(n):
        out = sr(x)
    sync()
    counts["fused_rdb"] = scatter_rdb.launches
    if counts["fused_rdb"] != 3 * spec.depth * n:
        raise AssertionError(f"trained sr launched fused_rdb {scatter_rdb.launches} times in "
                             f"{n} forwards, want {3 * spec.depth} per forward")
    if out.dtype != torch.uint8 or tuple(out.shape) != (len(x), 96, 96, 3):
        raise AssertionError(f"trained sr wrote {out.dtype} {tuple(out.shape)}")
    cpu16 = build_deployed(ckpts["a"], spec, dtype=torch.bfloat16, device="cpu")[0](x[:2])
    cpu32 = build_deployed(ckpts["a"], spec, dtype=torch.float32, device="cpu")[0](x[:2])
    w16, s16 = _lsb(out[:2].cpu(), cpu16)
    w32, s32 = _lsb(out[:2].cpu(), cpu32)
    _log(f"[serve] trained sr x2 d{spec.depth} (checkpoint of run a, EMA, BN folded) bf16 b{len(x)} t48 on "
         f"{card}: fused_rdb launches {counts['fused_rdb']} ({3 * spec.depth} per forward, "
         f"{n} forwards); 2 tiles: card vs CPU bf16 max {w16} LSB (bound {BF16_MAX_LSB}), "
         f"{s16:.4f} differ; card vs CPU fp32 max {w32} LSB (bound {BF16_X2_MAX_LSB}), "
         f"{s32:.4f} differ")
    if w16 > BF16_MAX_LSB or w32 > BF16_X2_MAX_LSB:
        raise AssertionError("trained sr card output is outside its bound")

    x24 = np.ascontiguousarray(x[:, :24, :24])
    counts["conv3x3_int8"], by_variant = _serve_fast_int8(
        ckpts["b"], x24, f"trained fast x4 (checkpoint of run b) b{len(x)} t24", card, device)

    spec = spec_of("c", "denoise")
    den, _ = build_deployed(ckpts["c"], spec, dtype=torch.bfloat16, device=device)
    outd = den(x)
    if outd.dtype != torch.uint8 or tuple(outd.shape) != x.shape:
        raise AssertionError(f"trained denoise wrote {outd.dtype} {tuple(outd.shape)}")
    wd, sd = _lsb(outd[:2].cpu(), build_deployed(ckpts["c"], spec, dtype=torch.float32,
                                                 device="cpu")[0](x[:2]))
    _log(f"[serve] trained denoise d{spec.depth} w{spec.width} (checkpoint of run c) bf16 b{len(x)} t48 on {card}: "
         f"2 tiles card vs CPU fp32 max {wd} LSB (bound {DENOISE_BF16_MAX_LSB}), {sd:.4f} "
         f"differ; no hand-written kernel on this path (cuDNN)")
    if wd > DENOISE_BF16_MAX_LSB:
        raise AssertionError("trained denoise card output is outside its bound")
    counts["conv3x3_int8 by variant"] = {k: {"launches": v, "launches_per_forward": v // n}
                                         for k, v in by_variant.items()}
    return counts


def _serve_fast_int8(ckpt: dict, x24, title: str, card: str, device: str, n: int = 3):
    """A fast x4 checkpoint through build_deployed (bf16, EMA weights; depth
    and width read from it), calibrated to int8 on ``x24`` and served
    through K2 ``n`` times: launches counted by variant (2 * depth + 1 per
    forward) and two tiles held against the port's CPU paths (int8 against
    int8, bf16 against fp32). Returns (launches, launches by variant)."""
    import torch

    from image_super_resolution_tpu_torch.models.deploy import (
        FAST_BF16_MAX_LSB, DeploySpec, build_deployed, infer_family_dims)
    from image_super_resolution_tpu_torch.models.quantized import (
        INT8_CARD_MAX_LSB, Int8DeployedFast, quantize_deployed)
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    depth, width = infer_family_dims(ckpt["params"], "fast")
    spec = DeploySpec(family="fast", depth=depth, width=width, scale=4)
    fast, _ = build_deployed(ckpt, spec, dtype=torch.bfloat16, device=device)
    out16 = fast(x24)
    quant = quantize_deployed(fast, [x24])
    conv3x3_int8.launches = 0
    conv3x3_int8.launches_by_variant.clear()
    for _ in range(n):
        out8 = quant(x24)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = conv3x3_int8.launches
    by_variant = dict(conv3x3_int8.launches_by_variant)
    want = {k: v * n for k, v in _k2_per_forward(depth).items()}
    if by_variant != want:
        raise AssertionError(f"{title}: int8 launched conv3x3_int8 {by_variant} in {n} "
                             f"forwards, want {want}")
    w16, s16 = _lsb(out16[:2].cpu(), build_deployed(ckpt, spec, dtype=torch.float32,
                                                    device="cpu")[0](x24[:2]))
    w8, s8 = _lsb(out8[:2].cpu(), Int8DeployedFast(spec, quant.params, device="cpu")(x24[:2]))
    _log(f"[serve] {title} d{depth} on {card}: int8 conv3x3_int8 launches {launches} by "
         f"variant {by_variant} ({n} forwards, {2 * depth + 1} per forward); 2 tiles: card "
         f"int8 vs CPU int8 max {w8} LSB (bound {INT8_CARD_MAX_LSB}), {s8:.4f} differ; card "
         f"bf16 vs CPU fp32 max {w16} LSB (bound {FAST_BF16_MAX_LSB}), {s16:.4f} differ")
    if w8 > INT8_CARD_MAX_LSB or w16 > FAST_BF16_MAX_LSB:
        raise AssertionError(f"{title}: card output is outside its bound")
    return launches, by_variant


def _checkpoint(work: Path, key: str) -> Path:
    return next((work / TRAIN_DIRS[key]).glob(CKPT_GLOB[key]))


def _serve_gan(work: Path, card: str, device: str) -> int:
    """Run (d)'s final checkpoint through ``cli.export.main`` into an
    ``.isr`` (EMA, BN folded, dims read from the checkpoint), then served
    from that file: ``load_artifact`` in bf16 on the card, K1 counted (48
    launches per forward of the x2 d16 generator), two tiles held against
    the port's fp32 CPU path within BF16_X2_MAX_LSB; then ``rs`` on a PNG,
    K1 counted per tile chunk. Returns K1's launches over the leg."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import export, rs
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_X2_MAX_LSB, infer_family_dims, load_artifact)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb
    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    paths = json.loads((work / "data" / "train_images.json").read_text())
    x = np.stack([read_image_rgb(p)[8:56, 16:64] for p in paths[:16]])  # b16 48x48
    isr = work / "gan.isr"
    ckpt = _checkpoint(work, "d")
    depth, width = infer_family_dims(load_checkpoint(ckpt)["params"], "sr")
    t0 = time.perf_counter()
    spec = export.main(["--checkpoint", str(ckpt), "--out", str(isr), "--scale", "2",
                        "--device", device])
    secs = time.perf_counter() - t0
    if (spec.family, spec.depth, spec.width, spec.scale) != ("sr", depth, width, 2):
        raise AssertionError(f"export wrote {spec}, want sr x2 d{depth} w{width}")
    n = 3
    scatter_rdb.launches = 0
    model = load_artifact(isr, device=device)
    for _ in range(n):
        out = model(x)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = scatter_rdb.launches
    if launches != 3 * spec.depth * n:
        raise AssertionError(f"the GAN-trained sr launched fused_rdb {launches} times in "
                             f"{n} forwards, want {3 * spec.depth} per forward")
    if out.dtype != torch.uint8 or tuple(out.shape) != (len(x), 96, 96, 3):
        raise AssertionError(f"the GAN-trained sr wrote {out.dtype} {tuple(out.shape)}")
    cpu32 = load_artifact(isr, dtype=torch.float32, device="cpu")(x[:2])
    w32, s32 = _lsb(out[:2].cpu(), cpu32)
    _log(f"[serve] GAN-trained sr x2 d{spec.depth} w{spec.width} (run d, cli.export.main in "
         f"{secs:.2f} s -> .isr -> load_artifact) bf16 b{len(x)} t48 on {card}: fused_rdb "
         f"launches {launches} ({3 * spec.depth} per forward, {n} forwards); 2 tiles card vs "
         f"CPU fp32 max {w32} LSB (bound {BF16_X2_MAX_LSB}), {s32:.4f} differ")
    if w32 > BF16_X2_MAX_LSB:
        raise AssertionError("the GAN-trained sr card output is outside its bound")

    src, dst = work / "gan_in.png", work / "gan_out.png"
    img = read_image_rgb(paths[0])[:150, :130]
    write_png(src, img)
    window, overlap, batch = 96, 8, 8  # the CLI's defaults
    tiles = plan_tiles(*img.shape[:2], min(window, max(img.shape[:2]) + 2 * overlap),
                       overlap)[0]
    chunks = -(-len(tiles) // batch)
    before = scatter_rdb.launches
    rs.main(["--model", str(isr), "--src", str(src), "--save_dir", str(dst),
             "--device", device])
    rs_launches = scatter_rdb.launches - before
    got = read_png(dst)
    if rs_launches != 3 * spec.depth * chunks or got.shape != (2 * img.shape[0],
                                                               2 * img.shape[1], 3):
        raise AssertionError(f"rs on the GAN artifact: {rs_launches} fused_rdb launches "
                             f"(want {3 * spec.depth * chunks}), output {got.shape}")
    _log(f"[serve] rs --model gan.isr on a {img.shape[0]}x{img.shape[1]} PNG on {card}: x2 "
         f"output {got.shape}, "
         f"fused_rdb launches {rs_launches} ({chunks} chunks of tiles)")
    return launches + rs_launches


def _step_card_vs_cpu(card: str, device: str) -> None:
    """Three pixel steps of the BN generator at depth 2, width 64, x2, in
    fp32 with TF32 off, on the card and on the CPU from the same seed. Each
    step's loss and gradients are held against the CPU's; then the card's
    gradients are replaced by the CPU's, so that its optimizer (clip, the
    fused Adam, BN commit, EMA) works on what the CPU's does, which the CPU
    tests hold against optax, and the params and EMA are held tightly."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.generator import SRGenerator
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.state import TrainState
    from image_super_resolution_tpu_torch.train.steps import make_pixel_train_step

    lr, n_steps = 1e-3, 3
    rng = np.random.default_rng(SEED + 7)
    step = make_pixel_train_step(2)
    states = [TrainState(init_weights(SRGenerator(depth=2, width=64, scale=2, fused=False,
                                                  param_dtype=torch.float32, device=dev), SEED),
                         lr=lr, total_steps=10, ema_tau=10) for dev in (device, "cpu")]
    card_st, cpu_st = states
    init = {k: t.detach().clone() for k, t in cpu_st.model.named_parameters()}
    loss_rel, grad_worst, grad_name = 0.0, 0.0, ""
    for _ in range(n_steps):
        u8 = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
        losses = []
        for st in states:
            hr, x = step.batch_fn(u8.to(st.params[0].device))
            loss = step.loss_fn(st.model(x), hr)
            loss.backward()
            losses.append(float(loss.detach()))
        loss_rel = max(loss_rel, abs(losses[0] - losses[1]) / abs(losses[1]))
        scale = max(float(p.grad.abs().max()) for p in cpu_st.params)
        for (name, p_card), p_cpu in zip(card_st.model.named_parameters(), cpu_st.params):
            d = float((p_card.grad.cpu() - p_cpu.grad).abs().max()) / scale
            if d > grad_worst:
                grad_worst, grad_name = d, name
            p_card.grad.copy_(p_cpu.grad)  # the optimizers take the same gradients
        for st in states:
            st.clip_and_adam()
            st.commit_and_ema()

    def worst(card_sd, cpu_sd, stats: bool):
        """Max abs diff (BN statistics) or max diff / max(1, |want|)."""
        return max(float(((card_sd[k].cpu() - want).abs()
                          / (1.0 if stats else want.abs().clamp_min(1.0))).max())
                   for k, want in cpu_sd.items() if ("running" in k) == stats)

    sd_card, sd_cpu = card_st.model.state_dict(), cpu_st.model.state_dict()
    ema_card, ema_cpu = card_st.ema.state_dict(), cpu_st.ema.state_dict()
    params, stats = worst(sd_card, sd_cpu, False), worst(sd_card, sd_cpu, True)
    ema_params, ema_stats = worst(ema_card, ema_cpu, False), worst(ema_card, ema_cpu, True)
    moved = max(float((sd_cpu[k] - t).abs().max()) for k, t in init.items())
    _log(f"[train] {n_steps} pixel steps, BN generator x2 d2 w64 fp32 (TF32 off) on {card} vs "
         f"CPU: loss max {loss_rel:.2e} relative (bound {STEP_LOSS_RTOL}); gradients max diff "
         f"{grad_worst:.2e} of the largest gradient ({grad_name}; bound {STEP_GRAD_RTOL}); on "
         f"the same gradients: params max diff {params:.3g} and EMA params {ema_params:.3g} of "
         f"max(1, |param|) (bound {STEP_PARAM_RTOL}; Adam moved a param by up to {moved:.3g}); "
         f"BN running stats max diff {stats:.3g}, their EMA {ema_stats:.3g} (bound "
         f"{STEP_STATS_ATOL})")
    if not (loss_rel <= STEP_LOSS_RTOL and grad_worst <= STEP_GRAD_RTOL
            and max(params, ema_params) <= STEP_PARAM_RTOL
            and max(stats, ema_stats) <= STEP_STATS_ATOL):
        raise AssertionError("the pixel steps on the card disagree with the CPU steps")


def _gan_card_vs_cpu(card: str, device: str) -> None:
    """Three GAN steps in fp32 with TF32 off, card against CPU from the same
    seeds: G as in the pixel steps (BN, x2, depth 2, width 64), the
    full-width D, VGG19 up to its first max-pool (1, 2) on random features
    with feature_norm, at the GAN phase's lr 1e-4. Each step's three losses
    within GAN_LOSS_RTOL; G's and then D's gradients within STEP_GRAD_RTOL
    of that model's largest gradient but for at most GAN_FLIP_SHARE of its
    elements (see there), checked where the step marks them and
    then replaced by the CPU's, so that both optimizers take the same
    gradients; then G's params and EMA and D's params within
    STEP_PARAM_RTOL, and the BN running statistics of both (D's folded from
    its two forwards per step) and G's EMA of them within STEP_STATS_ATOL,
    each of max(1, |value|). A max-pool routes each window's gradient to its
    argmax, and at a near-tie the card and the CPU may pick different
    pixels, both right (``scripts/torch_gan_card_probe.py``: 1.4e-2 of the
    largest input gradient of VGG (5, 4) at one such pixel, its forward
    within 2.4e-6 of float64), so the check stops before the pools; at lr
    1e-3 the full-width D saturates within two steps and its BCE and
    gradients shrink to rounding noise."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.losses.perceptual import PerceptualLoss
    from image_super_resolution_tpu_torch.models.discriminator import Discriminator
    from image_super_resolution_tpu_torch.models.generator import SRGenerator
    from image_super_resolution_tpu_torch.models.vgg import TruncatedVGG19, init_random_vgg
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.state import TrainState
    from image_super_resolution_tpu_torch.train.steps import make_gan_train_step

    def states(dev):
        g = init_weights(SRGenerator(depth=2, width=64, scale=2, fused=False,
                                     param_dtype=torch.float32, device=dev), SEED)
        d = init_weights(Discriminator(dtype=torch.float32, device=dev), SEED + 1)
        vgg = init_random_vgg(TruncatedVGG19(1, 2, dtype=torch.float32, device=dev))
        return (TrainState(g, lr=1e-4, total_steps=10, ema_tau=10),
                TrainState(d, lr=1e-4, total_steps=10, with_ema=False),
                make_gan_train_step(2, PerceptualLoss(vgg, feature_norm=True)))

    (card_g, card_d, card_step), (cpu_g, cpu_d, cpu_step) = states(device), states("cpu")
    marked = {"G backward": (card_g, cpu_g), "D backward": (card_d, cpu_d)}
    worst = {"loss": 0.0, "G backward": 0.0, "D backward": 0.0}  # loss; share off
    cpu_grads = {}

    def record(part):
        if part in marked:
            cpu_grads[part] = [p.grad.clone() for p in marked[part][1].params]

    step_log = []

    def check_and_replace(part):
        if part in marked:
            scale = max(float(g.abs().max()) for g in cpu_grads[part])
            names = [k for k, _ in marked[part][0].model.named_parameters()]
            diffs = [(p.grad.cpu() - g) for p, g in zip(marked[part][0].params, cpu_grads[part])]
            errs = [float(d.abs().max()) / scale for d in diffs]
            l2 = float(torch.sqrt(sum((d.double() ** 2).sum() for d in diffs))
                       / torch.sqrt(sum((g.double() ** 2).sum() for g in cpu_grads[part])))
            i = max(range(len(errs)), key=errs.__getitem__)
            over = sum(int((d.abs() > STEP_GRAD_RTOL * scale).sum()) for d in diffs)
            n = sum(g.numel() for g in cpu_grads[part])
            step_log.append(f"{part[0]} grads: {over} of {n} elements off by more than "
                            f"{STEP_GRAD_RTOL} of the largest, the worst {errs[i]:.2e} "
                            f"({names[i]}); relative L2 {l2:.2e}")
            worst[part] = max(worst[part], over / n)
            for p, g in zip(marked[part][0].params, cpu_grads[part]):
                p.grad.copy_(g)

    rng = np.random.default_rng(SEED + 9)
    for i in range(3):
        u8 = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
        want = cpu_step(cpu_g, cpu_d, u8, record)
        got = card_step(card_g, card_d, u8.to(device), check_and_replace)
        for k, w in want.items():
            worst["loss"] = max(worst["loss"], abs(float(got[k]) - float(w)) / abs(float(w)))
        _log(f"[train] GAN step {i} on {card} vs CPU: losses "
             + ", ".join(f"{k} {float(got[k]):.8g} / {float(w):.8g}" for k, w in want.items())
             + "; " + "; ".join(step_log))
        step_log.clear()

    def gap(card_sd, cpu_sd, stats: bool):
        return max(float(((card_sd[k].cpu() - want).abs() / want.abs().clamp_min(1.0)).max())
                   for k, want in cpu_sd.items() if ("running" in k) == stats)

    pairs = {"G": (card_g.model.state_dict(), cpu_g.model.state_dict()),
             "G EMA": (card_g.ema.state_dict(), cpu_g.ema.state_dict()),
             "D": (card_d.model.state_dict(), cpu_d.model.state_dict())}
    params = {k: gap(*v, False) for k, v in pairs.items()}
    stats = {k: gap(*v, True) for k, v in pairs.items()}
    _log(f"[train] 3 GAN steps, G BN x2 d2 w64 + D 3-64-8-1024 + VGG19 (1, 2), lr 1e-4, fp32 "
         f"(TF32 off) on {card} vs CPU: losses max {worst['loss']:.2e} relative (bound "
         f"{GAN_LOSS_RTOL}); share of gradient elements off by more than {STEP_GRAD_RTOL} of "
         f"the largest: G {worst['G backward']:.2e}, D {worst['D backward']:.2e} (bound "
         f"{GAN_FLIP_SHARE}); "
         f"on the same gradients: params max diff "
         + ", ".join(f"{k} {v:.3g}" for k, v in params.items())
         + f" of max(1, |param|) (bound {STEP_PARAM_RTOL}); BN running stats max diff "
         + ", ".join(f"{k} {v:.3g}" for k, v in stats.items())
         + f" of max(1, |stat|) (bound {STEP_STATS_ATOL})")
    if not (worst["loss"] <= GAN_LOSS_RTOL
            and max(worst["G backward"], worst["D backward"]) <= GAN_FLIP_SHARE
            and max(params.values()) <= STEP_PARAM_RTOL
            and max(stats.values()) <= STEP_STATS_ATOL):
        raise AssertionError("the GAN steps on the card disagree with the CPU steps")


def _stop_then_resume(key: str, title: str, argv, card: str):
    """Run ``argv --epochs 2`` through cli.train.main, stopped after its
    first checkpoint (epoch 0, with the optimizer(s)), then ``--resume``:
    it must continue at epoch 1 with the optimizer restored (run (d): D's
    too, and its warm start must have matched every leaf of run (a)).
    Returns the resumed run's history."""
    import contextlib
    import re

    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint

    orig_save, orig_resume_d = cli_train.save_checkpoint, cli_train.resume_discriminator

    def save_then_stop(*args, **kw):
        orig_save(*args, **kw)
        raise _Preempted

    tee = _Tee(sys.stdout)
    cli_train.save_checkpoint = save_then_stop
    try:
        with contextlib.redirect_stdout(tee):
            cli_train.main(argv + ["--epochs", "2"])
    except _Preempted:
        pass
    finally:
        cli_train.save_checkpoint = orig_save
    if key == "d":
        m = re.search(r"loaded pre-trained generator \((\d+)/(\d+) leaves\)", "".join(tee.text))
        if not m or m.group(1) != m.group(2):
            raise AssertionError(f"run (d) did not warm-start every leaf from run (a): "
                                 f"{m.group(0) if m else 'no matched-leaves line'}")
    ckpt = _checkpoint(Path(argv[argv.index("--work_dir") + 1]).parent, key)
    first = load_checkpoint(ckpt)
    want = {"opt_state"} | ({"d_opt_state", "d_params"} if key == "d" else set())
    if not want <= set(first) or first["meta"]["epoch"] != 0:
        raise AssertionError(f"run ({key}) left no mid-run checkpoint with its optimizer(s)")
    steps = first["meta"]["step"]
    restored = {}

    def resume_d(d_state, ckpt):
        out = orig_resume_d(d_state, ckpt)
        restored["d"] = (d_state.step, len(d_state.optimizer.state), len(d_state.params))
        return out

    cli_train.resume_discriminator = resume_d
    t1 = time.perf_counter()
    try:
        history = cli_train.main(argv + ["--epochs", "2", "--resume"])
    finally:
        cli_train.resume_discriminator = orig_resume_d
    secs = time.perf_counter() - t1
    final = load_checkpoint(ckpt)
    if [h["epoch"] for h in history] != [1] or final["meta"]["step"] != 2 * steps:
        raise AssertionError(f"--resume ran epochs {[h['epoch'] for h in history]} "
                             f"to step {final['meta']['step']}: want epoch 1 with "
                             f"the optimizer restored (step {steps} -> {2 * steps})")
    extra = ""
    if key == "d":
        d_step, n_moments, n_params = restored.get("d", (0, 0, 1))
        if d_step != steps or n_moments != n_params:
            raise AssertionError(f"run (d) resumed D at step {d_step} with {n_moments} of "
                                 f"{n_params} Adam moments, want step {steps} and all")
        extra = f", D's Adam restored ({n_moments} tensors, step {d_step})"
    _log(f"[train] {title}: stopped after epoch 0 (step {steps}, optimizer saved), "
         f"--resume --epochs 2 continued at epoch 1 with the optimizer restored to "
         f"step {final['meta']['step']}{extra} in {secs:.2f} s")
    return history


def phase_train(work: Path, kind: str, card: str, device: str = "cuda") -> dict:
    """Write the PNGs and their manifest (cli.create_json), train (a), (b),
    (c) and (d) through cli.train.main on the card -- (a) and (d) stopped at
    their first checkpoint and resumed with --resume --epochs 2 -- time each
    run's step, hold three pixel and three GAN steps against the CPU's,
    then serve (a)-(c) through build_deployed and (d) through cli.export
    and the .isr, with the kernels counted. Returns the kernels' launch
    counts on the serve legs. (``device`` is "cuda"; "cpu" only rehearses
    the phase's control flow at a reduced size.)"""
    import math

    import torch

    from image_super_resolution_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    manifest = _train_images(work / "data", SEED + 8)
    _log(f"[train] {TRAIN_IMAGES} smooth PNGs {TRAIN_SIZE}x{TRAIN_SIZE} written in "
         f"{time.perf_counter() - t0:.2f} s")
    timings = {}
    for key, title, flags in TRAIN_RUNS:
        argv = _train_argv(flags, manifest, work / TRAIN_DIRS[key], device)
        if key == "d":
            argv += ["--eval_every", "1", "--eval_json", str(manifest)]
        if key in ("a", "d"):
            history = _stop_then_resume(key, title, argv, card)
            if key == "d" and not all(math.isfinite(v) for v in history[-1]["eval"].values()):
                raise AssertionError(f"run (d) eval gave {history[-1]['eval']}")
        else:
            t1 = time.perf_counter()
            history = cli_train.main(argv + ["--epochs", "1"])
            _log(f"[train] {title}: cli.train.main --epochs 1 in "
                 f"{time.perf_counter() - t1:.2f} s")
        _check_history(title, history, card)
        timings[key] = _time_training(key, title, _train_argv(
            flags, manifest, work / "time", device, "--epochs", "1"), kind, card)
    if device == "cuda":
        torch.cuda.empty_cache()
    _step_card_vs_cpu(card, device)
    _gan_card_vs_cpu(card, device)
    counts = _serve_trained(work, card, device)
    counts["fused_rdb gan"] = _serve_gan(work, card, device)
    counts["timings"] = timings
    return counts


# ----------------------------------------------------------------- phase 10 --

# Card (bf16) against the port's CPU path (bf16) on the same 8 crops: each
# metric of cli.evaluate within EVAL_CARD_ATOL. The two devices sum the
# convs in other orders and round bf16 in other places, so outputs differ by
# a few LSB (BF16_MAX_LSB) and the metrics by much less: measured on an H100
# (700 W) at most 0.0006 dB (PSNR-Y median), 1e-4 SSIM and 2e-4 in the
# texture metrics, for sr x4 d16 w64 and fast x4 d14 w128 at random
# weights. The bounds are the order the eval protocol resolves (0.05 dB,
# 1e-3 SSIM).
EVAL_CARD_ATOL = {"psnr": 0.05, "psnr_y": 0.05, "ssim": 1e-3, "hf_ratio": 5e-3,
                  "grad_dist": 5e-3, "sharpness": 1e-3, "sharpness_hr": 1e-4,
                  "bicubic_psnr": 1e-3, "bicubic_psnr_y": 1e-3, "bicubic_hf_ratio": 1e-3,
                  "psnr_y_min": 0.05, "psnr_y_max": 0.05, "psnr_y_std": 0.05,
                  "psnr_y_median": 0.05}


def _per_forward(isr: Path, int8: bool = True) -> dict:
    """The kernel launches one forward of the artifact makes: K1 three per
    RRDB of an sr artifact; K2 by variant in a fast family's int8 trunk
    (none in bf16); none in any other family."""
    from image_super_resolution_tpu_torch.models.deploy import read_artifact

    spec, _ = read_artifact(isr)
    if spec.family == "sr":
        return {"fused_rdb": 3 * spec.depth}
    if spec.family in ("fast", "denoise_fast") and int8:
        return _k2_per_forward(spec.depth)
    return {"fused_rdb": 0}


def _counted(kernel, fn):
    """(fn(), seconds by the host clock, launches of ``kernel`` in it, by
    variant where the kernel counts them); the counts are set to 0 just
    before and read just after."""
    import torch

    kernel.launches = 0
    by_variant = getattr(kernel, "launches_by_variant", None)
    if by_variant is not None:
        by_variant.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, kernel.launches, dict(by_variant or {})


def _denoiser_isr(work: Path) -> Path:
    """Run (c)'s final checkpoint as an .isr (EMA, BN folded, the dataset
    mean/std baked in), written by save_artifact."""
    from image_super_resolution_tpu_torch.models.deploy import (
        DeploySpec, build_deployed, infer_family_dims, save_artifact)
    from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint

    ckpt = load_checkpoint(_checkpoint(work, "c"))
    depth, width = infer_family_dims(ckpt["params"], "denoise")
    deployed, fused = build_deployed(ckpt, DeploySpec(family="denoise", depth=depth,
                                                      width=width), device="cpu")
    isr = work / "denoise.isr"
    save_artifact(isr, deployed.spec, fused)
    return isr


def _eval_forward_ms(isr: Path, manifest: Path, int8: bool) -> float:
    """Device time of one eval batch's model forward (CUDA events): the
    first 8 images of the manifest at the eval's 192 crop, downscaled by
    the artifact's factor (as the CLI does) to uint8 on the card; int8
    calibrated on that batch."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.data import degrade
    from image_super_resolution_tpu_torch.models.deploy import load_artifact
    from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb

    model = load_artifact(isr, device="cuda")
    paths = json.loads(manifest.read_text())[:8]
    hr = torch.from_numpy(np.stack([read_image_rgb(p)[:192, :192] for p in paths])).cuda()
    lr01 = degrade.downscale(hr.float() / 255.0, model.spec.output_scale)
    lr = torch.clamp(torch.round(lr01 * 255.0), 0, 255).to(torch.uint8)
    if int8:
        model = quantize_deployed(model, [lr])
    return _cuda_ms(lambda: model(lr), warmup=2, iters=10)


def phase_eval(work: Path, sr_isr: Path, fast_isr: Path, card: str) -> dict:
    """cli.evaluate.main on the card over phase 9's 64 PNGs: the sr x4 and
    fast x4 --int8 artifacts (192 crops, batch 8; K1 and K2 counted per
    batch) and run (c)'s Denoiser (--denoise_eval --severity heavy); every
    key finite, 64 images. Then sr and fast bf16 on 8 crops on the card and
    through the port's CPU path, each key within EVAL_CARD_ATOL. Returns
    the counted launches."""
    import math

    from image_super_resolution_tpu_torch.cli import evaluate
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    import contextlib
    import io

    def evaluate_quietly(argv):  # the CLI prints its JSON; the [eval] lines carry it
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate.main(argv)

    manifest = work / "data" / "train_images.json"
    base = ["--val_json", str(manifest), "--shape", "192", "--batch_size", "8"]
    batches = TRAIN_IMAGES // 8
    den_isr = _denoiser_isr(work)
    runs = (("sr x4", sr_isr, [], scatter_rdb),
            ("fast x4 --int8", fast_isr, ["--int8"], conv3x3_int8),
            ("Denoiser (run c) --denoise_eval --severity heavy", den_isr,
             ["--denoise_eval", "--severity", "heavy"], scatter_rdb))
    counts = {}
    for title, isr, flags, kernel in runs:
        want = {k: v * batches for k, v in _per_forward(isr).items()}
        res, secs, launches, by_variant = _counted(
            kernel, lambda: evaluate_quietly(["--model", str(isr), *base, *flags]))
        got = by_variant or {"fused_rdb": launches}
        if got != want:
            raise AssertionError(f"evaluate {title} launched {got}, want {want}")
        bad = [k for k, v in res.items() if not math.isfinite(v)]
        if bad or res["n_images"] != TRAIN_IMAGES:
            raise AssertionError(f"evaluate {title}: non-finite {bad}, {res['n_images']} images")
        counts[f"evaluate {title} (phase 10)"] = launches
        _log(f"[eval] cli.evaluate {title} on {card}: {TRAIN_IMAGES} images in {batches} "
             f"batches, {secs:.3f} s wall (artifact load, decode, degrade, serve, metrics); "
             f"launches {got}; model forward {_eval_forward_ms(isr, manifest, "--int8" in flags):.4f} "
             f"ms per batch (CUDA events); " + ", ".join(f"{k} {v}" for k, v in res.items()))
    for title, isr in (("sr x4 d16 w64", sr_isr), ("fast x4 d14 w128", fast_isr)):
        argv = ["--model", str(isr), *base, "--max_images", "8"]
        t0 = time.perf_counter()
        on_card = evaluate_quietly(argv)
        t1 = time.perf_counter()
        on_cpu = evaluate_quietly(argv + ["--device", "cpu"])
        t2 = time.perf_counter()
        diffs = {k: abs(on_card[k] - on_cpu[k]) for k in EVAL_CARD_ATOL}
        _log(f"[eval] {title} bf16 on 8 crops, card ({t1 - t0:.3f} s) vs the port's CPU path "
             f"({t2 - t1:.3f} s): |diff| " + ", ".join(f"{k} {v:.4f}" for k, v in diffs.items()))
        over = {k: v for k, v in diffs.items() if v > EVAL_CARD_ATOL[k]}
        if over or not on_card["n_images"] == on_cpu["n_images"] == 8:
            raise AssertionError(f"evaluate {title}: card vs CPU beyond EVAL_CARD_ATOL: {over}")
    return counts


# ----------------------------------------------------------------- phase 11 --

VIDEO_FRAMES, VIDEO_HW, VIDEO_BATCH = 21, (180, 320), 8
VIDEO_TIMED_FRAMES, VIDEO_TIMED_REPEATS = 240, 2  # the frames/s leg: 30 batches


def _video_frames(n: int = VIDEO_FRAMES):
    """n smooth RGB frames (drifting low-frequency waves)."""
    import numpy as np

    h, w = VIDEO_HW
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    rng = np.random.default_rng(SEED + 11)
    waves = [(rng.uniform(1, 6), rng.uniform(1, 6), rng.uniform(0, 6.3, 3), rng.uniform(20, 50))
             for _ in range(3)]
    frames = []
    for t in range(n):
        img = np.full((h, w, 3), 128.0)
        for fy, fx, ph, amp in waves:
            img += np.sin(2 * np.pi * (fy * yy + fx * xx + 0.05 * t)[..., None] + ph) * amp
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def _video_rates(engine, frames) -> tuple:
    """Frames/s of rs.video_pipeline and of a serial upscale_batch loop over
    frames held in memory, by the host clock, in the order pipelined,
    serial, serial, pipelined (VIDEO_TIMED_REPEATS of each). Output frames
    are dropped: no decode, no encode."""
    import torch

    from image_super_resolution_tpu_torch.cli import rs

    def pipelined():
        return rs.video_pipeline(engine, _in_memory_batches(frames, VIDEO_BATCH),
                                 lambda frame: None)

    def serial():
        for batch, _ in _in_memory_batches(frames, VIDEO_BATCH):
            engine.upscale_batch(batch)

    rates = {"pipelined": [], "serial": []}
    order = ["pipelined", "serial", "serial", "pipelined"] * (VIDEO_TIMED_REPEATS // 2)
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (pipelined if name == "pipelined" else serial)()
        torch.cuda.synchronize()
        rates[name].append(len(frames) / (time.perf_counter() - t0))
    return rates["pipelined"], rates["serial"]


def _in_memory_batches(frames, batch: int):
    """VideoSource.batches over frames held in memory: fixed shape, the tail
    padded with its last frame."""
    import numpy as np

    for i in range(0, len(frames), batch):
        chunk = list(frames[i:i + batch])
        n = len(chunk)
        yield np.stack(chunk + [chunk[-1]] * (batch - n)), n


def phase_video(work: Path, sr_isr: Path, fast_isr: Path, card: str) -> dict:
    """rs.video_pipeline on a 21-frame 180x320 clip with the sr x4
    artifact: the clip is written by the port's FFMPEGRecorder (ffmpeg, else
    OpenCV's VideoWriter) and decoded by VideoSource where either exists,
    else held in memory. Its frames must equal, bit for bit, a serial loop
    of upscale_batch; K1 counted. Frames/s of both come from a separate
    240-frame leg held in memory (_video_rates), after one warm-up batch.
    Then the int8 fast x4 pipeline, calibrated on the first 4 frames as rs
    does (K2 counted by variant), and, with a clip, cli.rs.main on it end
    to end."""
    import shutil

    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.models.deploy import load_artifact
    from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    ffmpeg, ffprobe = shutil.which("ffmpeg"), shutil.which("ffprobe")
    codec = None
    if ffmpeg:  # libx264 where the build has it, else ffmpeg's own mpeg4
        listed = subprocess.run([ffmpeg, "-hide_banner", "-encoders"], capture_output=True,
                                text=True, timeout=60).stdout
        codec = "libx264" if "libx264" in listed else "mpeg4"
    _log(f"[video] tools on this machine: ffmpeg {ffmpeg or 'absent'}, ffprobe "
         f"{ffprobe or 'absent'}, cv2 {'present' if has_cv2 else 'absent'}")
    frames = _video_frames()
    timed_frames = _video_frames(VIDEO_TIMED_FRAMES)
    clip = None
    if ffmpeg or has_cv2:  # the recorder encodes through ffmpeg, else OpenCV
        from image_super_resolution_tpu_torch.video.recorder import FFMPEGRecorder

        clip = work / "clip.mp4"
        rec = FFMPEGRecorder(str(clip), video_dimensions=VIDEO_HW[::-1], fps=24.0,
                             codec=codec)
        for f in frames:
            rec.write_frame(f[..., ::-1])
        rec.stop_recorder()
    else:
        _log("[video] no video decoder on this machine (neither cv2 nor ffmpeg): the "
             "pipeline runs on frames held in memory; the file legs are skipped")

    def batches():
        if clip is None:
            return _in_memory_batches(frames, VIDEO_BATCH)
        from image_super_resolution_tpu_torch.video.reader import VideoSource

        src = VideoSource(clip)

        def gen():
            try:
                yield from src.batches(VIDEO_BATCH)
            finally:
                src.close()
        return gen()

    counts = {}
    for title, isr, kernel in (("sr x4 bf16", sr_isr, scatter_rdb),
                               ("fast x4 int8", fast_isr, conv3x3_int8)):
        int8 = kernel is conv3x3_int8
        want = _per_forward(isr, int8)
        deployed = load_artifact(isr, device="cuda")
        if int8:
            calib = (rs._int8_calib_batches(clip, 96) if clip is not None
                     else [np.stack(frames[:4])])
            deployed = quantize_deployed(deployed, calib)
        engine = TiledUpscaler(deployed, batch_size=VIDEO_BATCH)
        warm = batches()
        first = next(warm)[0]
        warm.close()
        engine.upscale_batch(first)  # warm-up batch
        got = []
        n, secs, launches, by_variant = _counted(
            kernel, lambda: rs.video_pipeline(engine, batches(), got.append))
        n_batches = -(-VIDEO_FRAMES // VIDEO_BATCH)
        launched = by_variant or {"fused_rdb": launches}
        if launched != {k: v * n_batches for k, v in want.items()}:
            raise AssertionError(f"video {title} launched {launched}, want {want} per batch")
        serial = []
        for batch, k in batches():
            serial.extend(engine.upscale_batch(batch)[:k])
        if n != VIDEO_FRAMES or len(serial) != VIDEO_FRAMES:
            raise AssertionError(f"video {title}: {n} frames pipelined, {len(serial)} serial")
        for i, (a, b) in enumerate(zip(got, serial)):
            if a.shape != (4 * VIDEO_HW[0], 4 * VIDEO_HW[1], 3) or not np.array_equal(a, b):
                raise AssertionError(f"video {title}: frame {i} {a.shape} differs from the "
                                     f"serial loop's")
        counts[f"video pipeline {title} (phase 11)"] = launches
        on_card = torch.from_numpy(first).cuda()
        device_ms = _cuda_ms(lambda: engine.deployed(on_card), warmup=1, iters=5)
        _log(f"[video] {title} on {card}: {VIDEO_FRAMES} frames {VIDEO_HW[1]}x{VIDEO_HW[0]} -> "
             f"{4 * VIDEO_HW[1]}x{4 * VIDEO_HW[0]} in batches of {VIDEO_BATCH} "
             f"({'decoded from ' + clip.name if clip else 'in memory'}) in {secs:.3f} s: "
             f"frames equal the serial loop's bit for bit; launches {launched}")
        piped, ser = _video_rates(engine, timed_frames)
        _log(f"[video] {title} on {card}: {VIDEO_TIMED_FRAMES} frames held in memory "
             f"({VIDEO_TIMED_FRAMES // VIDEO_BATCH} batches of {VIDEO_BATCH}, frames dropped: no "
             f"decode, no encode), host clock, in the order pipelined, serial, serial, "
             f"pipelined: pipelined {', '.join(f'{r:.2f}' for r in piped)} frames/s, serial "
             f"{', '.join(f'{r:.2f}' for r in ser)} frames/s; model forward {device_ms:.3f} ms "
             f"per batch (CUDA events), {VIDEO_BATCH / device_ms * 1e3:.2f} frames/s of device "
             f"time")
    if clip is not None:
        dst = work / "clip_x4.mp4"
        (out, secs, launches, _) = _counted(scatter_rdb, lambda: rs.main(
            ["--model", str(sr_isr), "--src", str(clip), "--save_dir", str(dst)]
            + (["--codec", codec] if codec else [])))
        from image_super_resolution_tpu_torch.video.reader import VideoSource

        back = VideoSource(out)
        n = sum(1 for _ in back.frames())
        dims = (back.width, back.height)
        back.close()
        if dims != (4 * VIDEO_HW[1], 4 * VIDEO_HW[0]) or n != VIDEO_FRAMES:
            raise AssertionError(f"rs on the clip wrote {dims} x {n} frames")
        if launches != _per_forward(sr_isr)["fused_rdb"] * -(-VIDEO_FRAMES // VIDEO_BATCH):
            raise AssertionError(f"rs on the clip launched fused_rdb {launches} times")
        counts["rs on the video file, sr x4 (phase 11)"] = launches
        _log(f"[video] cli.rs.main on {clip.name} -> {out.name} on {card}: {n} frames "
             f"{dims[0]}x{dims[1]}, {secs:.3f} s wall (decode, serve, encode, remux), "
             f"fused_rdb launches {launches}")
    return counts


# ----------------------------------------------------------------- phase 12 --

def phase_profile(work: Path, sr_isr: Path, card: str) -> int:
    """rs --profile_dir on one PNG with the sr artifact (the trace must name
    K1's kernel, rdb_dense_conv), then cli.train --profile_dir on run (b)'s
    flags at batch 8 (8 steps): the trace must open at step 2 and close
    after step 4. Returns K1's launches in the rs run."""
    launches = _profile_rs(work, sr_isr, card)
    _profile_train(work, card)
    return launches


def _profile_rs(work: Path, sr_isr: Path, card: str) -> int:
    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb
    from image_super_resolution_tpu_torch.utils.png import write_png

    paths = json.loads((work / "data" / "train_images.json").read_text())
    src = work / "prof_in.png"
    img = read_image_rgb(paths[1])[:150, :130]
    write_png(src, img)
    prof = work / "prof_rs"
    _, secs, launches, _ = _counted(scatter_rdb, lambda: rs.main(
        ["--model", str(sr_isr), "--src", str(src), "--save_dir", str(work / "prof_out.png"),
         "--profile_dir", str(prof)]))
    tiles = plan_tiles(*img.shape[:2], 96, 8)[0]
    if launches != _per_forward(sr_isr)["fused_rdb"] * -(-len(tiles) // 8):
        raise AssertionError(f"rs --profile_dir launched fused_rdb {launches} times")
    traces = sorted(prof.glob("*.pt.trace.json"))
    if len(traces) != 1 or "rdb_dense_conv" not in traces[0].read_text():
        raise AssertionError(f"rs --profile_dir wrote {traces}, without K1's rdb_dense_conv")
    _log(f"[profile] rs --profile_dir on a {img.shape[1]}x{img.shape[0]} PNG on {card}: "
         f"{secs:.3f} s wall, trace {traces[0].name} ({traces[0].stat().st_size} B) names "
         f"rdb_dense_conv; fused_rdb launches {launches}")
    return launches


def _profile_train(work: Path, card: str) -> None:
    from image_super_resolution_tpu_torch.cli import train as cli_train

    seen = []
    step = cli_train.Run.step

    def recording(self, batch):
        seen.append(self.profiler is not None)
        return step(self, batch)

    flags = dict((k, f) for k, _, f in TRAIN_RUNS)["b"]
    prof = work / "prof_train"
    cli_train.Run.step = recording
    t0 = time.perf_counter()
    try:
        cli_train.main(_train_argv(flags, work / "data" / "train_images.json",
                                   work / "prof_b", "cuda", "--epochs", "1",
                                   "--batch_size", "8", "--profile_dir", str(prof)))
    finally:
        cli_train.Run.step = step
    secs = time.perf_counter() - t0
    traces = sorted(prof.glob("*.pt.trace.json"))
    if seen != [False, False, True, True, True] + [False] * 3 or len(traces) != 1:
        raise AssertionError(f"train --profile_dir: profiled steps {seen}, traces {traces}")
    n_kernels = traces[0].read_text().count('"cat": "kernel"')
    _log(f"[profile] cli.train --profile_dir, run (b)'s flags at batch 8 on {card}: steps "
         f"2-4 of 8 traced into {traces[0].name} ({traces[0].stat().st_size} B, "
         f"{n_kernels} kernel events), {secs:.2f} s wall")


# ----------------------------------------------------------------- phase 13 --

# The reference-layout artifacts come from the test helper, loaded by path.
REFERENCE_LAYOUT = ROOT / "tests" / "test_torch_reference_layout.py"
# Phase 13's sr generator and the .pt2 request (a rehearsal on the CPU
# lowers them).
INTEROP_DEPTH, PROGRAM_SHAPE = 16, (256, 24, 24)


def _reference_layout():
    import importlib.util

    spec = importlib.util.spec_from_file_location("reference_layout", REFERENCE_LAYOUT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _k1_counted(fn, want: int, what: str, device: str):
    """fn() with K1 counted (``_counted``); fails unless it launched ``want``
    times (none on a CPU rehearsal: the plain versions count none).
    Returns (fn(), seconds)."""
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb

    out, secs, launches, _ = _counted(scatter_rdb, fn)
    if launches != (want if device == "cuda" else 0):
        raise AssertionError(f"{what}: fused_rdb launched {launches} times, want {want}")
    return out, secs


def _same_trees(what: str, got, want) -> None:
    """Bit for bit, fp32, the same keys."""
    import numpy as np

    from image_super_resolution_tpu_torch.utils.general import flatten_tree

    a, b = flatten_tree(got), flatten_tree(want)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: keys differ: {sorted(set(a) ^ set(b))[:5]}")
    bad = [k for k in a if np.asarray(a[k]).dtype != np.float32
           or not np.array_equal(np.asarray(a[k]), np.asarray(b[k], np.float32))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")


def _eager_op_or_launcher(isr: Path, card: str) -> None:
    """Phase 5's request (sr x4 d16 w64 bf16, b256 t24, host clock over 5
    requests after one) with ``ScatterRDB`` calling K1 through the
    registered op ``isr::scatter_rdb``, as serving does, and through its
    launcher directly (swapped in this process for the measurement only),
    in the order op, launcher, launcher, op: what the op's dispatch costs.
    Not a counted path."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import load_artifact
    from image_super_resolution_tpu_torch.ops import scatter as scatter_mod
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb

    model = load_artifact(isr, device="cuda")
    x = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, 256, (256, 24, 24, 3), dtype=np.uint8)).cuda()
    times = {"op": [], "launcher": []}
    for which in ("op", "launcher", "launcher", "op"):
        if which == "launcher":
            scatter_mod.scatter_rdb = fused_rdb._cuda_forward
        try:
            times[which].append(_serve(model, x, 5)[0])
        finally:
            scatter_mod.scatter_rdb = fused_rdb.scatter_rdb
    _log(f"[interop] eager sr x4 d16 b256 t24 request on {card}, host clock over 5 requests "
         f"after one (order O, L, L, O): K1 through the op isr::scatter_rdb "
         f"{' / '.join(f'{t:.3f}' for t in times['op'])} ms, through its launcher "
         f"{' / '.join(f'{t:.3f}' for t in times['launcher'])} ms")


def phase_interop(work: Path, train_work: Path, card: str, device: str = "cuda") -> dict:
    """Reference interop and the export formats at full width: a seeded sr x4
    d16 w64 generator, exported to the reference's layout and saved as a
    TorchScript artifact, through ``cli.import_torch --smoke`` (card bf16
    vs the CPU fp32 TorchScript forward within BF16_MAX_LSB), the ``.isr``
    it wrote through ``load_artifact`` and ``cli.demo``; ``cli.export
    --stablehlo`` static at b256 t24 and ``--hlo_dynamic`` from phase 9's
    GAN checkpoint (x2) and from a seeded sr x4 checkpoint, each program
    loaded and run (bit-equal to the eager model, the dynamic one at two
    shapes), the static x4 one timed beside eager; ``--torch_state_dict``
    and ``--torch_discriminator`` from runs (a) and (d), re-imported bit for
    bit; a legacy-denoiser artifact (the shape of the reference's model.pt)
    served within DENOISE_BF16_MAX_LSB. K1 is counted on every path (48
    launches per x4 d16 forward). Returns K1's launches by path."""
    import contextlib
    import math
    import re

    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import demo, export, import_torch
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.interop import (
        export_generator_state, import_discriminator_state, import_generator_state,
        import_torchscript_artifact)
    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_MAX_LSB, DENOISE_BF16_MAX_LSB, DeploySpec, build_deployed,
        init_fused_params, load_artifact, load_program)
    from image_super_resolution_tpu_torch.models.generator import SRGenerator
    from image_super_resolution_tpu_torch.ops.initializers import init_weights
    from image_super_resolution_tpu_torch.train.checkpoint import (load_checkpoint,
                                                                   save_checkpoint)
    from image_super_resolution_tpu_torch.train.state import TrainState
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb

    layout = _reference_layout()
    work.mkdir(parents=True, exist_ok=True)
    counts = {}
    per_forward = 3 * INTEROP_DEPTH
    spec = DeploySpec(family="sr", depth=INTEROP_DEPTH, width=64, scale=4)
    pt = layout.save_sr_artifact(work / "reference_sr_x4.pt",
                                 export_generator_state(init_fused_params(spec, SEED + 13)),
                                 spec.mean, spec.std)
    isr = work / "imported_sr_x4.isr"
    (got, (worst, share)), secs = _k1_counted(lambda: import_torch.main(
        ["--src", str(pt), "--out", str(isr), "--smoke", "--device", device]),
        per_forward, "import_torch --smoke", device)
    if (got.family, got.depth, got.width, got.scale) != ("sr", INTEROP_DEPTH, 64, 4):
        raise AssertionError(f"import_torch read {got}")
    if worst > BF16_MAX_LSB:
        raise AssertionError(f"import_torch --smoke: {worst} LSB from the TorchScript "
                             f"forward, bound {BF16_MAX_LSB}")
    counts["import_torch --smoke, sr x4 (phase 13)"] = per_forward
    _log(f"[interop] reference-layout TorchScript sr x4 d{INTEROP_DEPTH} w64 -> "
         f"cli.import_torch --smoke on {card}: {secs:.2f} s (import, .isr, CPU fp32 "
         f"TorchScript forward, one card forward); card bf16 vs TorchScript fp32 max "
         f"{worst} LSB (bound {BF16_MAX_LSB}), {share:.4f} of values differ; fused_rdb "
         f"launches {per_forward}")

    x = np.random.default_rng(SEED + 13).integers(0, 256, (16, 48, 48, 3), dtype=np.uint8)
    model = load_artifact(isr, device=device)
    out, _ = _k1_counted(lambda: model(x), per_forward, "the imported .isr", device)
    w32, s32 = _lsb(out[:2].cpu(), load_artifact(isr, dtype=torch.float32,
                                                   device="cpu")(x[:2]))
    if tuple(out.shape) != (16, 192, 192, 3) or w32 > BF16_MAX_LSB:
        raise AssertionError(f"the imported .isr: {tuple(out.shape)}, {w32} LSB")
    counts["import -> .isr -> load_artifact, sr x4 (phase 13)"] = per_forward
    _log(f"[interop] imported .isr through load_artifact, b16 t48 on {card}: 2 tiles vs "
         f"CPU fp32 max {w32} LSB (bound {BF16_MAX_LSB}), {s32:.4f} differ; fused_rdb "
         f"launches {per_forward}")

    tiles = plan_tiles(48, 48, min(96, 48 + 2 * 8), 8)[0]  # the demo's 48x48 LR card
    want = per_forward * -(-len(tiles) // 8)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        restored, secs = _k1_counted(lambda: demo.main(
            ["--model_pt", str(pt), "--out_dir", str(work / "demo"), "--device", device]),
            want, "cli.demo", device)
    psnrs = [float(v) for v in re.findall(r"([-\d.]+) dB", "".join(tee.text))]
    image = read_image_rgb(restored)
    if image.shape != (192, 192, 3) or len(psnrs) < 2 or not all(map(math.isfinite, psnrs)):
        raise AssertionError(f"cli.demo wrote {image.shape}, PSNRs {psnrs}")
    counts["demo, sr x4 (phase 13)"] = want
    _log(f"[interop] cli.demo on {card}: {secs:.2f} s, restored {image.shape}, PSNR bicubic "
         f"{psnrs[0]:.2f} dB, restored {psnrs[1]:.2f} dB (random weights); fused_rdb "
         f"launches {want}")

    sr4_ckpt = work / "sr_x4.ckpt"
    state = TrainState(init_weights(SRGenerator(depth=INTEROP_DEPTH, width=64, scale=4,
                                                fused=False, device=device), SEED + 13),
                       total_steps=1)
    save_checkpoint(sr4_ckpt, state, 0, spec.mean, spec.std, [0.0])
    del state
    n, h, w = PROGRAM_SHAPE
    for title, ckpt, scale in (("GAN-trained sr x2 (run d)", _checkpoint(train_work, "d"), 2),
                               ("seeded sr x4", sr4_ckpt, 4)):
        for dynamic in (False, True):
            pt2 = work / f"sr_x{scale}{'_dynamic' if dynamic else ''}.pt2"
            t0 = time.perf_counter()
            exp_spec = export.main(["--checkpoint", str(ckpt), "--scale", str(scale),
                                    "--out", str(work / "program.isr"), "--device", device,
                                    "--stablehlo", str(pt2), "--hlo_shape", str(n), str(h),
                                    str(w)] + (["--hlo_dynamic"] if dynamic else []))
            secs = time.perf_counter() - t0
            program = load_program(pt2)
            eager = build_deployed(load_checkpoint(ckpt), exp_spec, device=device)[0]
            k1_per = 3 * exp_spec.depth
            shapes = [(n, h, w)] + ([(3, 40, 56)] if dynamic else [])
            for i, shape in enumerate(shapes):
                xd = torch.from_numpy(np.random.default_rng(SEED + i).integers(
                    0, 256, (*shape, 3), dtype=np.uint8)).to(device)
                got, _ = _k1_counted(lambda: program(xd), k1_per, f".pt2 {title}", device)
                want = eager(xd)
                if got.dtype != torch.uint8 or not torch.equal(got, want):
                    raise AssertionError(f".pt2 {title} {shape}: not equal to eager "
                                         f"({_lsb(got.cpu(), want.cpu())})")
                key = (f".pt2 {'dynamic' if dynamic else 'static'} {title} "
                       f"{shape[0]}x{shape[1]}x{shape[2]} (phase 13)")
                counts[key] = k1_per
            timing = ""
            if device == "cuda" and not dynamic and scale == 4:
                t_prog = _cuda_ms(lambda: program(xd), warmup=2, iters=10)
                t_eager = _cuda_ms(lambda: eager(xd), warmup=2, iters=10)
                timing = (f"; b{n} t{h} request by CUDA events: program {t_prog:.3f} ms, "
                          f"eager {t_eager:.3f} ms")
            _log(f"[interop] cli.export --stablehlo{' --hlo_dynamic' if dynamic else ''} "
                 f"{title} d{exp_spec.depth} on {card}: export {secs:.2f} s, "
                 f"{pt2.stat().st_size / 2**20:.1f} MiB; {len(shapes)} shape(s) equal to eager "
                 f"bit for bit; fused_rdb launches {k1_per} per forward{timing}")
            del program, eager
    if device == "cuda":
        torch.cuda.empty_cache()
        _eager_op_or_launcher(isr, card)

    for key, flags in (("a", ["--torch_state_dict"]),
                       ("d", ["--torch_state_dict", "--torch_discriminator"])):
        ckpt_path = _checkpoint(train_work, key)
        argv = ["--checkpoint", str(ckpt_path), "--scale", "2", "--device", device,
                "--out", str(work / "sd.isr")]
        for flag in flags:
            argv += [flag, str(work / f"{key}{flag}.pt")]
        export.main(argv)
        ckpt = load_checkpoint(ckpt_path)
        sd = {k: v.numpy() for k, v in torch.load(work / f"{key}--torch_state_dict.pt",
                                                   weights_only=True)["state_dict"].items()}
        params, stats, _ = import_generator_state(sd)
        _same_trees(f"run ({key}) --torch_state_dict params", params, ckpt["ema_params"])
        _same_trees(f"run ({key}) --torch_state_dict batch_stats", stats,
                    ckpt["ema_batch_stats"])
        done = "G (EMA params and statistics)"
        if "--torch_discriminator" in flags:
            sd = {k: v.numpy() for k, v in torch.load(
                work / f"{key}--torch_discriminator.pt", weights_only=True)[
                "state_dict"].items()}
            d_params, d_stats = import_discriminator_state(sd)
            _same_trees("run (d) --torch_discriminator params", d_params, ckpt["d_params"])
            _same_trees("run (d) --torch_discriminator batch_stats", d_stats,
                        ckpt["d_batch_stats"])
            done += " and D (params and statistics)"
        _log(f"[interop] cli.export {' '.join(flags)} from run ({key}): re-imported {done} "
             f"equal to the checkpoint's bit for bit in fp32")

    legacy = DeploySpec(family="denoise_legacy", depth=8, width=64, hidden=32)
    pt = layout.save_state_artifact(work / "legacy_denoiser.pt", layout.legacy_denoiser_state(
        init_fused_params(legacy, SEED + 13)), spec.mean, spec.std)
    deployed, got, _ = import_torchscript_artifact(pt, device=device)
    if (got.family, got.depth, got.width, got.hidden) != ("denoise_legacy", 8, 64, 32):
        raise AssertionError(f"the legacy denoiser imported as {got}")
    x = np.random.default_rng(SEED + 14).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    worst, share = _lsb(deployed(x).cpu(), import_torchscript_artifact(
        pt, torch.float32, "cpu")[0](x))
    if worst > DENOISE_BF16_MAX_LSB:
        raise AssertionError(f"the legacy denoiser: {worst} LSB from the CPU, bound "
                             f"{DENOISE_BF16_MAX_LSB}")
    _log(f"[interop] legacy-denoiser artifact (d8 w64 hidden 32) -> denoise_legacy on {card}: "
         f"2 tiles 96x96 card bf16 vs CPU fp32 max {worst} LSB (bound "
         f"{DENOISE_BF16_MAX_LSB}), {share:.4f} differ")
    return counts


# ----------------------------------------------------------------- phase 14 --

# A COCO-like training set: photo-sized JPEGs (quality 90, 4:2:0), half
# landscape and half portrait, plus two JPEGs smaller than the patch, a grey
# PNG and a BMP (which the C++ loader hands back to the Python decoders).
LOADER_PHOTOS, LOADER_SIZE = 256, (480, 640)
LOADER_WORKERS, LOADER_BATCH, LOADER_PATCH = (2, 4, 8), 16, 96
LOADER_CROPS = 64  # (path, seed) pairs held against the full decode
LOADER_EPOCHS = 3
# Compiled and run before the loader is built: the headers of libjpeg-turbo
# >= 1.5 (jpeg_crop_scanline, which the ROI decode needs) and libpng, and
# both libraries' link names.
PROBE_SOURCE = r"""
#include <cstdio>
#include <jpeglib.h>
#include <png.h>
#define ISR_STR2(x) #x
#define ISR_STR(x) ISR_STR2(x)
int main() {
  void (*crop)(j_decompress_ptr, JDIMENSION*, JDIMENSION*) = jpeg_crop_scanline;
#ifdef LIBJPEG_TURBO_VERSION
  const char* turbo = ISR_STR(LIBJPEG_TURBO_VERSION);
#else
  const char* turbo = "none";
#endif
  void* volatile png = (void*)&png_create_read_struct;  // links -lpng
  std::printf("libjpeg API %d, libjpeg-turbo %s, libpng %s\n", JPEG_LIB_VERSION, turbo,
              PNG_LIBPNG_VER_STRING);
  return crop == nullptr || png == nullptr;
}
"""


def _probe_toolchain(work: Path) -> tuple:
    """(True, what was found) when g++ builds and runs PROBE_SOURCE against
    -ljpeg -lpng, else (False, the compiler's first error line)."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "probe.cpp").write_text(PROBE_SOURCE)
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                 timeout=30).stdout.splitlines()[0]
        built = subprocess.run(["g++", "-std=c++17", str(work / "probe.cpp"), "-o",
                                str(work / "probe"), "-ljpeg", "-lpng"],
                               capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return False, f"g++: {e}"
    if built.returncode != 0:
        lines = built.stderr.strip().splitlines() or ["no message"]
        return False, f"{version}: {next((l for l in lines if 'error' in l), lines[0])}"
    ran = subprocess.run([str(work / "probe")], capture_output=True, text=True, timeout=30)
    return ran.returncode == 0, f"{version}; {ran.stdout.strip()}{ran.stderr.strip()}"


def _jpeg_sampling(path: Path) -> str:
    """The chroma subsampling a baseline JPEG's frame header declares."""
    data = path.read_bytes()
    at = data.index(b"\xff\xc0")
    n = data[at + 9]
    factors = [(data[at + 11 + 3 * i] >> 4, data[at + 11 + 3 * i] & 15) for i in range(n)]
    return {((2, 2), (1, 1), (1, 1)): "4:2:0", ((2, 1), (1, 1), (1, 1)): "4:2:2",
            ((1, 1), (1, 1), (1, 1)): "4:4:4"}.get(tuple(factors), str(factors))


def _coco_like_set(folder: Path) -> tuple:
    """LOADER_PHOTOS smooth-plus-noise photos as JPEGs (quality 90, 4:2:0),
    two JPEGs under the patch, a grey PNG and a BMP, written by OpenCV on
    all cores, and their manifest written by ``cli.create_json``. Returns
    (manifest, the photos' paths)."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    from image_super_resolution_tpu_torch.cli import create_json

    (folder / "img").mkdir(parents=True)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    if hasattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR"):
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    h, w = LOADER_SIZE
    shapes = ([(h, w)] * (LOADER_PHOTOS // 2) + [(w, h)] * (LOADER_PHOTOS // 2)
              + [(72, 56), (80, 64)])

    def write(i):
        hh, ww = shapes[i]
        rng = np.random.default_rng([SEED, 14, i])
        coarse = rng.uniform(0, 255, (hh // 40 + 2, ww // 40 + 2, 3)).astype(np.float32)
        img = cv2.resize(coarse, (ww, hh), interpolation=cv2.INTER_CUBIC)
        img += 8 * rng.standard_normal((hh, ww, 3), dtype=np.float32)
        path = folder / "img" / f"{i:04d}.jpg"
        if not cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8), params):
            raise AssertionError(f"cv2 could not write {path}")
        return path

    with ThreadPoolExecutor(max_workers=8) as pool:
        paths = list(pool.map(write, range(len(shapes))))
    rng = np.random.default_rng(SEED + 14)
    cv2.imwrite(str(folder / "img" / "grey.png"),
                rng.integers(0, 256, (240, 320), dtype=np.uint8))
    cv2.imwrite(str(folder / "img" / "bmp.bmp"),
                rng.integers(0, 256, (200, 300, 3), dtype=np.uint8))
    sampling = _jpeg_sampling(paths[0])
    if sampling != "4:2:0":
        raise AssertionError(f"cv2 wrote {sampling} JPEGs, want 4:2:0")
    manifest, _ = create_json.main(["--train_dirs", str(folder / "img"), "--shape", "48",
                                    "--output", str(folder)])
    listed = json.loads(manifest.read_text())
    if len(listed) != len(shapes) + 2:
        raise AssertionError(f"create_json listed {len(listed)} images, want {len(shapes) + 2}")
    return manifest, paths[:LOADER_PHOTOS]


def _loader_checks(photos, grey: Path, card: str) -> None:
    """decode_rgb against cv2 and PIL; LOADER_CROPS crops from load_patches
    against the native full decode at crop_offsets; nothing substituted."""
    import cv2
    import numpy as np
    from PIL import Image

    from image_super_resolution_tpu_torch import native

    diffs = {"cv2": [], "PIL": []}
    for path in photos[::LOADER_PHOTOS // 8]:
        got = native.decode_rgb(str(path)).astype(np.int16)
        for name, ref in (("cv2", cv2.imread(str(path))[..., ::-1]),
                          ("PIL", np.asarray(Image.open(path).convert("RGB")))):
            diffs[name].append(np.abs(got - ref.astype(np.int16)))
    for name, d in diffs.items():
        mean, worst = float(np.mean([x.mean() for x in d])), int(max(x.max() for x in d))
        _log(f"[loader] native.decode_rgb vs {name} on 8 photos {LOADER_SIZE[1]}x"
             f"{LOADER_SIZE[0]}: mean {mean:.4f}, max {worst} (bound: mean < 1)")
        if mean >= 1.0:
            raise AssertionError(f"native.decode_rgb is {mean} from {name} on average")

    rng = np.random.default_rng(SEED + 140)
    paths = [str(photos[i]) for i in rng.choice(LOADER_PHOTOS, LOADER_CROPS - 1,
                                                replace=False)] + [str(grey)]
    seeds = [int(s) for s in rng.integers(0, 2 ** 63, LOADER_CROPS, dtype=np.int64)]
    crops, substituted = native.load_patches(paths, LOADER_PATCH, seeds, threads=8)
    if substituted:
        raise AssertionError(f"load_patches substituted {substituted} patches")
    bad = 0
    for path, seed, crop in zip(paths, seeds, crops):
        full = native.decode_rgb(path)
        top, left = native.crop_offsets(*full.shape[:2], LOADER_PATCH, seed)
        bad += not np.array_equal(crop, full[top:top + LOADER_PATCH, left:left + LOADER_PATCH])
    _log(f"[loader] load_patches: {LOADER_CROPS - bad} of {LOADER_CROPS} crops {LOADER_PATCH}"
         f"x{LOADER_PATCH} ({LOADER_CROPS - 1} JPEG photos by the ROI decode, 1 grey PNG) "
         f"bit-equal to the "
         f"native full decode at the Python splitmix64+Lemire offsets; 0 substituted")
    if bad:
        raise AssertionError(f"{bad} of {LOADER_CROPS} ROI crops differ from the full decode")


def _loader_rates(manifest: Path, card: str) -> dict:
    """Patches/s of PatchLoader by backend and workers: one epoch after a
    warm-up epoch, by the host clock, nothing substituted."""
    import os

    from image_super_resolution_tpu_torch.data.pipeline import LoaderConfig, PatchLoader

    cpus, affinity = os.cpu_count(), len(os.sched_getaffinity(0))
    rates = {}
    for workers in LOADER_WORKERS:
        for backend in ("python", "native"):
            loader = PatchLoader(manifest, LoaderConfig(
                batch_size=LOADER_BATCH, patch_size=LOADER_PATCH, workers=workers,
                seed=SEED, backend=backend))
            for epoch in (0, 1):
                loader.set_epoch(epoch)
                t0 = time.perf_counter()
                n = sum(len(batch) for batch in loader)
                secs = time.perf_counter() - t0
            if loader.uses_native != (backend == "native") or loader.substituted:
                raise AssertionError(f"{backend} loader: native {loader.uses_native}, "
                                     f"{loader.substituted} substituted")
            rates[f"{backend} workers {workers}"] = n / secs
            _log(f"[loader] {backend} workers {workers}: {n / secs:.1f} patches/s ({n} "
                 f"patches of {LOADER_PATCH}x{LOADER_PATCH}, batch {LOADER_BATCH}, epoch 1 "
                 f"after a warm-up epoch, host clock; os.cpu_count() {cpus}, affinity "
                 f"{affinity}) on {card}")
    return rates


def phase_loader(work: Path, train_manifest: Path, card: str, device: str = "cuda") -> dict:
    """The native loader on the card's host: probe g++ and the headers;
    where they are missing, check that ``auto`` chose python and that
    ``--loader_backend native`` raises, and stop. Else write the COCO-like
    set, check decodes and crops, time the loader by backend and workers,
    train fast x4 on it through ``cli.train.main`` with each backend and
    serve the native run's checkpoint in int8 through K2. Returns the K2
    launches of that serve leg and the loader's rates."""
    import numpy as np

    from image_super_resolution_tpu_torch import native
    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.data.pipeline import LoaderConfig, PatchLoader
    from image_super_resolution_tpu_torch.train.checkpoint import load_checkpoint

    ok, found = _probe_toolchain(work / "probe")
    _log(f"[loader] toolchain probe (g++, jpeglib.h with jpeg_crop_scanline, png.h): "
         f"{'found' if ok else 'failed'}: {found}")
    flags = ["--resnet", "--family", "fast", "--scale", "4"]
    if not ok:
        _log(f"[loader] native unavailable on this host: {found}")
        if PatchLoader(train_manifest, LoaderConfig()).uses_native:
            raise AssertionError("the probe failed, yet auto chose the native loader")
        try:
            cli_train.main(_train_argv(flags, train_manifest, work / "refused", device,
                                       "--epochs", "1", "--loader_backend", "native"))
        except RuntimeError as e:
            if "did not build on this host" not in str(e):
                raise
            _log(f"[loader] auto chose python; --loader_backend native raised: "
                 f"{str(e).splitlines()[0]}")
        else:
            raise AssertionError("--loader_backend native trained without the library")
        return {"launches": 0, "rates": {}}
    if not native.available():
        raise AssertionError(f"the probe passed but the loader did not build: "
                             f"{native.build_error()}")

    t0 = time.perf_counter()
    manifest, photos = _coco_like_set(work / "data")
    _log(f"[loader] {LOADER_PHOTOS} JPEG photos {LOADER_SIZE[1]}x{LOADER_SIZE[0]} and "
         f"{LOADER_SIZE[0]}x{LOADER_SIZE[1]} (quality 90, 4:2:0), 2 JPEGs under the patch, "
         f"a grey PNG and a BMP, with their manifest, in {time.perf_counter() - t0:.2f} s")
    _loader_checks(photos, work / "data" / "img" / "grey.png", card)
    rates = _loader_rates(manifest, card)

    runs = {}
    for backend in ("native", "python"):
        title = f"fast x4 d14 w128 on JPEGs (--loader_backend {backend})"
        t1 = time.perf_counter()
        history = cli_train.main(_train_argv(
            flags, manifest, work / backend, device, "--epochs", str(LOADER_EPOCHS),
            "--loader_backend", backend))
        _log(f"[train] {title}: cli.train.main --epochs {LOADER_EPOCHS} in "
             f"{time.perf_counter() - t1:.2f} s")
        _check_history(title, history, card)
        runs[backend] = [h["patches_per_sec"] for h in history[1:]]
    _log(f"[loader] training patches/s, epochs 2-{LOADER_EPOCHS} (CLI, host clock), fast x4 "
         f"batch {LOADER_BATCH} patch {LOADER_PATCH}, workers 2: "
         + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)}" for k, vs in runs.items())
         + f" on {card}")

    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb

    x24 = np.stack([read_image_rgb(p)[200:224, 100:124] for p in photos[:16]])
    ckpt = load_checkpoint(next((work / "native").glob("res_*.ckpt")))
    launches, _ = _serve_fast_int8(ckpt, x24, "fast x4 trained on JPEGs by the native "
                                   "loader, b16 t24", card, device)
    rates["train epochs 2-3"] = runs
    return {"launches": launches, "rates": rates}


# ----------------------------------------------------------------- phase 15 --

SPATIAL_IMAGE = (256, 192)  # H, W of the sr image served over 4 devices
SPATIAL_CROP = 96  # side of the crop held against the CPU's fp32 spatial run
SPATIAL_OVERLAP = 16  # the halo of the spatial runs
TP_TILE = 96  # side of the batch-1 tile of the TP runs
MULTI_DEPTH, MULTI_WIDTH = 14, 128  # of the seeded denoise_fast models


def _phase_devices(n: int, device: str):
    """``n`` devices for a sharded run: the local cards in turn (all
    ``cuda:0`` on a one-card machine), or the CPU ``n`` times."""
    import torch

    if device != "cuda":
        return [torch.device(device)] * n
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def _same_bands(deployed, image, halo: int, grid):
    """The spatial engine's result recomputed without it: the image padded
    as the engine pads it, cut into its (ny, nx) blocks, each extended by
    numpy's reflect-padded neighbourhood (rows only for 1-D bands), run one
    after another through ``deployed`` on one device, cropped, stitched."""
    import numpy as np

    ny, nx = grid
    h, w = image.shape[:2]
    bh = max(-(-h // ny), halo + 1)
    bw = max(-(-w // nx), halo + 1) if nx > 1 else w
    padded = np.pad(image, ((0, bh * ny - h), (0, bw * nx - w), (0, 0)), mode="reflect")
    cols = (halo, halo) if nx > 1 else (0, 0)
    full = np.pad(padded, ((halo, halo), cols, (0, 0)), mode="reflect")
    s = deployed.spec.output_scale
    rows = []
    for i in range(ny):
        row = []
        for j in range(nx):
            x0 = j * bw
            block = full[i * bh:(i + 1) * bh + 2 * halo,
                         x0:x0 + bw + (2 * halo if nx > 1 else 0)]
            out = deployed(np.ascontiguousarray(block)[None]).cpu().numpy()[0]
            cw = slice(halo * s, (halo + bw) * s) if nx > 1 else slice(None)
            row.append(out[halo * s:(halo + bh) * s, cw])
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)[:h * s, :w * s]


def _equal_or_1lsb(what: str, got, want, exact: bool = False) -> str:
    """'equal', or the share of values 1 LSB apart; fails beyond 1 LSB (or
    on any difference where ``exact``)."""
    worst, share = _lsb(got, want)
    if worst > (0 if exact else 1):
        raise AssertionError(f"{what}: max {worst} LSB from the single-device run "
                             f"({share:.6f} of values differ)")
    return "equal" if worst == 0 else f"within 1 LSB ({share:.6f} of values differ)"


@contextlib.contextmanager
def _plain_kernels():
    """Within: the main path's kernels swapped for their plain PyTorch
    versions where the models call them, on the card too (K1's
    ``scatter_rdb_reference``: fp32 sums, bf16 at the kernel's places; K2's
    ``conv3x3_int8_reference``: exact sums, the kernel's fp32 epilogue)."""
    from unittest import mock

    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb_reference
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8_reference

    def plain_k2(x, w_q, deq, bias, leaky, inv_x=None, out_inv_x=None, w_k=None, res=None,
                 rate=1.0, keep_fp32=False):
        return conv3x3_int8_reference(x, w_q, deq, bias, leaky, inv_x, out_inv_x, res, rate,
                                      keep_fp32)

    with mock.patch(f"{PACKAGE}.ops.scatter.scatter_rdb", scatter_rdb_reference), \
            mock.patch(f"{PACKAGE}.models.quantized.conv3x3_int8", plain_k2):
        yield


def _against_plain(what: str, got, plain_run, bound: int) -> str:
    """``got`` held against ``plain_run()`` under ``_plain_kernels``: the
    same path on the same inputs, so each kernel sees the shapes the path
    gives it. Fails beyond ``bound`` LSB, or if a kernel launched there."""
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    before = scatter_rdb.launches, conv3x3_int8.launches
    with _plain_kernels():
        want = plain_run()
    if (scatter_rdb.launches, conv3x3_int8.launches) != before:
        raise AssertionError(f"{what}: a kernel launched in the plain run")
    worst, share = _lsb(got, want)
    if worst > bound:
        raise AssertionError(f"{what}: max {worst} LSB from the plain versions on the "
                             f"same shapes (bound {bound})")
    return (f"vs the plain kernel versions on the card at the path's own shapes max "
            f"{worst} LSB (bound {bound}), {share:.4f} differ")


def _stage_outputs(deployed, x):
    """One forward of ``deployed`` on ``x``: each top-level stage's output
    (host fp32 copies, in the order the stages ran) and the uint8 result."""
    outs = {}
    handles = [child.register_forward_hook(
        lambda _m, _i, o, name=name: outs.__setitem__(name, o.detach().float().cpu()))
        for name, child in deployed.model.named_children()]
    try:
        y = deployed(x).cpu()
    finally:
        for h in handles:
            h.remove()
    return outs, y


def _kernel_names(fn) -> set:
    """The CUDA kernels one call of ``fn`` runs (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")}


def _data_axis_stages(deployed, x, device: str) -> str:
    """Where the data axis parts from one device: ``x`` (8 tiles) in one
    forward against its two halves in two (the shards of data_devices=2),
    stage by stage (hooks on the model's top-level children), under the
    default cuDNN settings and under deterministic=True, benchmark=False;
    and the kernels that only one of the two batch sizes runs."""
    import numpy as np
    import torch

    def compare():
        whole, y = _stage_outputs(deployed, x)
        parts = [_stage_outputs(deployed, np.ascontiguousarray(h)) for h in np.split(x, 2)]
        first = None
        for name, want in whole.items():
            got = torch.cat([pt[0][name] for pt in parts])
            if first is None and not torch.equal(got, want):
                first = f"{name} ({float((got != want).float().mean()):.4%} of its values)"
        got_y = torch.cat([pt[1] for pt in parts])
        worst, share = _lsb(got_y, y)
        return (f"first stage that differs: {first or 'none'}; output max {worst} LSB on "
                f"{share:.4%}"), y

    default, y_default = compare()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        det, y_det = compare()
    same = _lsb(y_det, y_default)
    line = (f"batch {len(x)} vs two shards of {len(x) // 2}: default cuDNN: {default}; "
            f"deterministic=True, benchmark=False: {det} (its batch-{len(x)} output vs the "
            f"default's: max {same[0]} LSB on {same[1]:.4%})")
    if device == "cuda":
        k8 = _kernel_names(lambda: deployed(x))
        k4 = _kernel_names(lambda: deployed(np.ascontiguousarray(x[: len(x) // 2])))
        line += (f"; kernels only at batch {len(x)}: {sorted(k8 - k4)[:4]}; only at "
                 f"batch {len(x) // 2}: {sorted(k4 - k8)[:4]}")
    return line


def phase_multi(work: Path, sr_isr: Path, fast_isr: Path, card: str,
                device: str = "cuda") -> dict:
    """Multi-device serving at full width: (a) sr x4 spatial 1-D and 2-D
    (K1 per band), (b) data_devices=2 (sr tiles, fast int8 frames, the
    denoise_fast int8 tiled path), (c) TP at 2 and 4 on fast x4 and on a
    denoise_fast with a refine tail, (d) ``rs --data_devices``. Each is
    held to the single-device run, and each path that runs a kernel also to
    the same path with the kernels' plain versions (``_against_plain``);
    request times by CUDA events beside the single device's. Returns
    {path: (kernel name, launches)}."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_MAX_LSB, DeployedModel, DeploySpec, init_fused_params, load_artifact)
    from image_super_resolution_tpu_torch.models.quantized import (
        INT8_CARD_MAX_LSB, quantize_deployed)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8
    from image_super_resolution_tpu_torch.parallel.tensor import TPFastUpscaler
    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    cards = torch.cuda.device_count() if device == "cuda" else 0
    d4, d2 = _phase_devices(4, device), _phase_devices(2, device)
    _log(f"[multi] torch.cuda.device_count() = {cards}; 4-way device list "
         f"{[str(d) for d in d4]}, 2-way {[str(d) for d in d2]}")
    if cards < 2:
        _log("[multi] one card: every shard runs on cuda:0 in turn, so the band "
             "cuts, halos, crops, split batches and partial-sum reductions run at "
             "full width, but peer copies between cards and concurrency across "
             "cards are NOT exercised, and no scaling figure is measured")
    counts = {}
    rng = np.random.default_rng(SEED + 15)
    times = []

    def timed(title, fn, single):
        ms, ms1 = _cuda_ms(fn, warmup=1, iters=3), _cuda_ms(single, warmup=1, iters=3)
        times.append(f"{title} {ms:.3f} ms vs one device {ms1:.3f} ms")

    # (a) sr x4 d16 w64 bf16, spatial 1-D over 4 and 2-D over (2, 2)
    sr = load_artifact(sr_isr, dtype=torch.bfloat16, device=device)
    image = rng.integers(0, 256, (*SPATIAL_IMAGE, 3), dtype=np.uint8)
    crop = np.ascontiguousarray(image[:SPATIAL_CROP, :SPATIAL_CROP])
    sr_cpu = load_artifact(sr_isr, dtype=torch.float32, device="cpu")
    per_forward = 3 * sr.spec.depth
    # the whole-image forward on the same crop against the CPU's: the
    # model's own bf16 drift there, beside the spatial runs' below
    whole_lsb = _lsb(sr(crop[None]).cpu().numpy()[0], sr_cpu(crop[None]).numpy()[0])
    for title, kw, grid in (("spatial_devices=4", dict(spatial_devices=4), (4, 1)),
                            ("spatial_grid=(2, 2)", dict(spatial_grid=(2, 2)), (2, 2))):
        engine = TiledUpscaler(sr, overlap=SPATIAL_OVERLAP, devices=d4, **kw)
        out, _, launches, _ = _counted(scatter_rdb, lambda: engine.upscale_image(image))
        want = 4 * per_forward if device == "cuda" else 0
        if launches != want:
            raise AssertionError(f"sr {title}: fused_rdb launched {launches} times, "
                                 f"want {per_forward} per band forward")
        if out.shape != (4 * SPATIAL_IMAGE[0], 4 * SPATIAL_IMAGE[1], 3):
            raise AssertionError(f"sr {title} wrote {out.shape}")
        same = _equal_or_1lsb(f"sr {title}", out,
                              _same_bands(sr, image, SPATIAL_OVERLAP, grid), exact=True)
        plain = _against_plain(f"sr {title}", out, lambda: engine.upscale_image(image),
                               BF16_MAX_LSB)
        got = TiledUpscaler(sr, overlap=SPATIAL_OVERLAP, devices=d4, **kw).upscale_image(crop)
        ref = TiledUpscaler(sr_cpu, overlap=SPATIAL_OVERLAP, **kw).upscale_image(crop)
        worst, share = _lsb(got, ref)
        if worst > BF16_MAX_LSB:
            raise AssertionError(f"sr {title} on a {SPATIAL_CROP}^2 crop: {worst} LSB "
                                 f"from the CPU's fp32 spatial run")
        counts[f"sr x4 {title}, one {SPATIAL_IMAGE[1]}x{SPATIAL_IMAGE[0]} image "
               f"(phase 15)"] = ("fused_rdb", launches)
        _log(f"[multi] sr x4 d{sr.spec.depth} w{sr.spec.width} bf16 {title} halo "
             f"{SPATIAL_OVERLAP} on "
             f"{SPATIAL_IMAGE[1]}x{SPATIAL_IMAGE[0]}: {same} to the same bands run one "
             f"after another through one DeployedModel; {plain}; fused_rdb launches "
             f"{launches} ({per_forward} per band forward); {SPATIAL_CROP}x{SPATIAL_CROP} "
             f"crop vs the CPU's fp32 spatial run max {worst} LSB (bound {BF16_MAX_LSB}), "
             f"{share:.4f} differ (the whole-image forward on that crop vs the CPU's: max "
             f"{whole_lsb[0]} LSB, {whole_lsb[1]:.4f} differ)")
        whole = TiledUpscaler(sr, window=0)
        timed(f"sr x4 {title}", lambda: engine.upscale_image(image),
              lambda: whole.upscale_image(image))

    # (b) data_devices=2: sr tiles, fast int8 frames, denoise_fast int8 tiled
    single = TiledUpscaler(sr)
    multi = TiledUpscaler(sr, data_devices=2, devices=d2)
    out, _, launches, _ = _counted(scatter_rdb, lambda: multi.upscale_image(image))
    chunks = -(-len(plan_tiles(*SPATIAL_IMAGE, 96, 8)[0]) // multi.batch_size)
    want = chunks * 2 * per_forward if device == "cuda" else 0
    if launches != want:
        raise AssertionError(f"sr data_devices=2: fused_rdb launched {launches} times, "
                             f"want {want}")
    same = _equal_or_1lsb("sr data_devices=2", out, single.upscale_image(image))
    plain = _against_plain("sr data_devices=2", out, lambda: multi.upscale_image(image),
                           BF16_MAX_LSB)
    counts["sr x4 data_devices=2, tiles of one image (phase 15)"] = ("fused_rdb", launches)
    _log(f"[multi] sr x4 data_devices=2, {chunks} tile batches of {multi.batch_size} "
         f"(window 96, {multi.batch_size // 2} tiles per shard): {same} to one device; "
         f"{plain}; fused_rdb launches {launches}")
    tiles = np.stack([image[y:y + 96, x0:x0 + 96] for y in (0, 53, 106, 160)
                      for x0 in (0, 96)])
    _log(f"[multi] sr x4 data axis, 8 tiles 96x96: {_data_axis_stages(sr, tiles, device)}")
    timed("sr x4 data_devices=2 tiles", lambda: multi.upscale_image(image),
          lambda: single.upscale_image(image))

    fast = load_artifact(fast_isr, dtype=torch.bfloat16, device=device)
    x = rng.integers(0, 256, (256, 24, 24, 3), dtype=np.uint8)
    xd = torch.from_numpy(x).to(device)
    quant = quantize_deployed(fast, [xd])
    multi = TiledUpscaler(quant, data_devices=2, devices=d2)
    frames, _, launches, by_variant = _counted(conv3x3_int8, lambda: multi.upscale_batch(xd))
    depth = fast.spec.depth
    per_shard = _k2_per_forward(depth)
    if device == "cuda" and by_variant != {k: 2 * v for k, v in per_shard.items()}:
        raise AssertionError(f"fast int8 data_devices=2: conv3x3_int8 by variant "
                             f"{by_variant}, want {per_shard} per shard forward")
    same = _equal_or_1lsb("fast int8 data_devices=2", frames, quant(xd).cpu().numpy())
    plain = _against_plain("fast int8 data_devices=2", frames,
                           lambda: multi.upscale_batch(xd), INT8_CARD_MAX_LSB)
    counts["fast x4 int8 data_devices=2, b256 t24 frames (phase 15)"] = \
        ("conv3x3_int8", launches)
    _log(f"[multi] fast x4 d{depth} w{fast.spec.width} int8 data_devices=2, b256 t24 "
         f"frames (calibrated "
         f"once, replicated; b128 per shard): {same} to one device; {plain}; "
         f"conv3x3_int8 launches {launches}, by "
         f"variant {by_variant} ({2 * depth + 1} per shard forward)")
    timed("fast x4 int8 data_devices=2 frames", lambda: multi.upscale_batch(xd),
          lambda: quant(xd).cpu())

    spec = DeploySpec(family="denoise_fast", depth=MULTI_DEPTH, width=MULTI_WIDTH,
                      downshuffle=2)
    dn = DeployedModel(spec, init_fused_params(spec, SEED + 5), dtype=torch.bfloat16,
                       device=device)
    img = rng.integers(0, 256, (301, 203, 3), dtype=np.uint8)
    dq = quantize_deployed(dn, [np.stack(rs._grid_crops(img, 96, 2, 4))])
    multi = TiledUpscaler(dq, data_devices=2, devices=d2)
    out, _, launches, _ = _counted(conv3x3_int8, lambda: multi.upscale_image(img))
    chunks = -(-len(plan_tiles(*img.shape[:2], 96, 8)[0]) // multi.batch_size)
    want = chunks * 2 * (2 * MULTI_DEPTH + 1)
    if launches != (want if device == "cuda" else 0):
        raise AssertionError(f"denoise_fast int8 data_devices=2: conv3x3_int8 launched "
                             f"{launches} times, want {want}")
    same = _equal_or_1lsb("denoise_fast int8 data_devices=2", out,
                          TiledUpscaler(dq).upscale_image(img))
    plain = _against_plain("denoise_fast int8 data_devices=2", out,
                           lambda: multi.upscale_image(img), INT8_CARD_MAX_LSB)
    counts["denoise_fast int8 data_devices=2, tiled (phase 15)"] = ("conv3x3_int8", launches)
    _log(f"[multi] denoise_fast d{MULTI_DEPTH} w{MULTI_WIDTH} ds2 int8 data_devices=2, "
         f"one 203x301 image, "
         f"{chunks} tile batches: {same} to one device; {plain}; conv3x3_int8 launches "
         f"{launches}")

    # (c) TP at 2 and 4: fast x4 bf16 and denoise_fast with a refine tail
    tile = rng.integers(0, 256, (1, TP_TILE, TP_TILE, 3), dtype=np.uint8)
    spec_r = DeploySpec(family="denoise_fast", depth=MULTI_DEPTH, width=MULTI_WIDTH,
                        downshuffle=2, refine_blocks=2, refine_width=32)
    refine = DeployedModel(spec_r, init_fused_params(spec_r, SEED + 7),
                           dtype=torch.bfloat16, device=device)
    for name, dep in ((f"fast x4 d{fast.spec.depth} w{fast.spec.width}", fast),
                      (f"denoise_fast d{MULTI_DEPTH} w{MULTI_WIDTH} ds2 refine 2x32", refine)):
        want = dep(tile)
        for n in (2, 4):
            tp = TPFastUpscaler(dep, _phase_devices(n, device))
            same = _equal_or_1lsb(f"TP {n} {name}", tp(tile).cpu(), want.cpu())
            _log(f"[multi] TP over {n} ({name}, bf16, b1 {TP_TILE}x{TP_TILE}): {same} to "
                 f"the single-device bf16 graph (bound 1 LSB)")
            timed(f"TP {n} {name}", lambda: tp(tile).cpu(), lambda: dep(tile).cpu())

    # (d) the CLI: --data_devices 0 (all local cards), and more than there are
    src = work / "multi.png"
    write_png(src, image[:128, :96])
    plain = read_png(rs.main(["--model", str(sr_isr), "--src", str(src), "--device", device,
                              "--save_dir", str(work / "multi_one.png")]))
    out_png, _, launches, _ = _counted(scatter_rdb, lambda: rs.main(
        ["--model", str(sr_isr), "--src", str(src), "--device", device, "--data_devices",
         "0", "--save_dir", str(work / "multi_all.png")]))
    n_all = max(cards, 1)  # --data_devices 0: every card, the batch rounded up to them
    batch = -(-8 // n_all) * n_all
    want = -(-len(plan_tiles(128, 96, 96, 8)[0]) // batch) * n_all * per_forward
    if launches != (want if device == "cuda" else 0):
        raise AssertionError(f"rs --data_devices 0: fused_rdb launched {launches} times, "
                             f"want {want}")
    _equal_or_1lsb("rs --data_devices 0", read_png(out_png), plain)
    counts["rs --data_devices 0, sr x4 (phase 15)"] = ("fused_rdb", launches)
    argv = ["--model", str(sr_isr), "--src", str(src), "--device", device,
            "--data_devices", "2", "--save_dir", str(work / "multi_two.png")]
    if device == "cuda" and cards < 2:
        try:
            rs.main(argv)
        except SystemExit as e:
            if str(e) != f"data_devices=2 but only {cards} local devices available":
                raise
            _log(f"[multi] rs --data_devices 0: fused_rdb launches {launches}, equal to "
                 f"one device; --data_devices 2 on {cards} card exits: {e}")
        else:
            raise AssertionError("rs --data_devices 2 served on one card")
    else:
        _equal_or_1lsb("rs --data_devices 2", read_png(rs.main(argv)), plain)
        _log(f"[multi] rs --data_devices 0 over {cards} cards and --data_devices 2: "
             f"equal to one device")
    _log(f"[multi] request times by CUDA events (mean of 3 after 1; on one card the "
         f"cost of splitting, not scaling), on {card}: " + "; ".join(times))
    return counts


# ----------------------------------------------------------------- phase 16 --

# Data-parallel training of run (a) (sr x2 d16 w64 BN, --resnet; then the
# GAN phase in the same work dir) at the CLI defaults on phase 9's 64 PNGs,
# held against the one-process run of the same flags (--epochs 1, so the
# same schedule). bf16 compute: the global BatchNorm sums in another order
# than torch.native_batch_norm, and two ranks run each conv at half the
# batch, where cuDNN may pick another algorithm, so bf16 roundings flip.
# Bounds: each pixel step's loss, and the first GAN step's loss/content
# (both GAN runs start from one state and batch), within DP_LOSS_RTOL
# relative; the later GAN steps within DP_GAN_LOSS_RTOL, since GAN
# trajectories part step by step (measured on an H100: 3.6e-4, 1.2e-3,
# 7.9e-3, 1.1e-2 over four steps; the CPU tests hold the GAN one step at a
# time for that reason); every param within DP_STEP_ATOL per step (the
# most two Adam runs part: lr per step on each side, at --lr 1e-4); every
# BN running statistic within DP_STATS_RTOL of max(1, |stat|); the
# relative L2 of the params' difference to the one-process run's own
# update is printed beside them. Ranks equal bit for bit (a hash of their
# state). Measured values: PERF.md §2.
DP_LOSS_RTOL = 2e-3
DP_GAN_LOSS_RTOL = 3e-2
DP_STEP_ATOL = 2e-4
DP_STATS_RTOL = 5e-2
DP_EXTRA: tuple = ()  # flags appended to every phase-16 run (a CPU rehearsal's sizes)
DP_FLAGS = TRAIN_RUNS[0][2]
DP_GAN_FLAGS = TRAIN_RUNS[3][2]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _params_hash(states) -> str:
    import hashlib

    h = hashlib.sha256()
    for st in states:
        for t in st.model.state_dict().values():
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _dp_train(argv) -> dict:
    """cli.train on ``argv`` as a user's process runs it (``Run(opt).train()``,
    in whatever process group this process joined), with the checkpoints it
    writes counted: its per-step losses (the data group's means), a hash of
    its state, and the final state dicts on the host."""
    from image_super_resolution_tpu_torch.cli import train as cli_train

    saves = []
    orig = cli_train.save_checkpoint
    cli_train.save_checkpoint = lambda *a, **kw: (saves.append(1), orig(*a, **kw))
    try:
        opt = cli_train.build_parser().parse_args(argv)
        opt.argv = list(argv)
        run = cli_train.Run(opt)
        history = run.train()
    finally:
        cli_train.save_checkpoint = orig
    states = [run.state] + ([run.d_state] if run.d_state is not None else [])
    return {"losses": history[-1]["losses"], "saves": len(saves),
            "hash": _params_hash(states), "device": str(run.device),
            "state": [{k: t.detach().cpu() for k, t in st.model.state_dict().items()}
                      for st in states], "steps": run.state.step}


def _dp_step_ms(argv, what: str = "", card: str = "", n: int = 5) -> float:
    """One rank's step of ``argv``'s run on one batch of its rows, by CUDA
    events (mean of ``n`` after 2 warm-up; every rank runs the same steps,
    so they meet at each collective). With ``what``, then where a step goes
    (torch.profiler over 3 more, which adds its own cost to the host side):
    device kernel time per step and the host ops with the most self time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_super_resolution_tpu_torch.cli import train as cli_train

    run = cli_train.Run(cli_train.build_parser().parse_args(argv))
    u8 = torch.from_numpy(np.ascontiguousarray(next(iter(run.loader)))).to(run.device)
    if run.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            run.step(u8)
        ms = (time.perf_counter() - t0) * 1e3 / n
    else:
        ms = _cuda_ms(lambda: run.step(u8), warmup=2, iters=n)
    if not what:
        return ms
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda"
                                     else [])
    with profile(activities=acts) as prof:
        for _ in range(3):
            run.step(u8)
        run.sync()
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0) for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / 3
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
    _log(f"[breakdown] dp {what} on {card}: device kernel time {busy:.3f} ms per step; "
         f"host ops by self time per step: "
         + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3 / 3:.2f} ms "
                     f"({e.count // 3} calls)" for e in host))
    return ms


def _content_split_gap(argv) -> float:
    """One process, the GAN run's first batch and starting G: loss/content
    with VGG on the whole batch against VGG on its two halves (features
    concatenated, then the same RMS and MSE), relative. In bf16 the halves'
    convs may run other cuDNN kernels; this is what that alone moves."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.data.transforms import tanh_to_norm

    run = cli_train.Run(cli_train.build_parser().parse_args(argv))
    run.resume()
    u8 = torch.from_numpy(np.ascontiguousarray(next(iter(run.loader)))).to(run.device)
    hr, lr = run.step_fn.batch_fn(u8)
    vgg = run.step_fn.perceptual.vgg

    def content(fs, fh):
        scale = torch.sqrt(torch.mean(torch.square(fh))) + 1e-6
        return float(torch.mean(torch.square(fs / scale - fh / scale)))

    with torch.no_grad():
        sr = tanh_to_norm(run.state.model(lr), run.mean, run.std)
        whole = content(vgg(sr), vgg(hr))
        halves = content(torch.cat([vgg(t) for t in sr.chunk(2)]),
                         torch.cat([vgg(t) for t in hr.chunk(2)]))
    return abs(halves - whole) / whole


def _dp_rank_main(rank: int, port: int, spec_path: str) -> int:
    """One of phase 16 (b)'s two ranks (``chip_smoke.py --dp-rank``): joins
    a gloo group of two with the other rank, both on ``cuda:0`` (or the
    CPU), and runs the spec's phases through ``_dp_train``, printing one
    ``DP {json}`` line per phase; rank 0 also saves its final state."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    from image_super_resolution_tpu_torch.core.mesh import distributed_init

    spec = json.loads(Path(spec_path).read_text())
    device = spec["device"]
    shared = [torch.device("cuda", 0)] * 2 if device == "cuda" else None
    distributed_init(device, "gloo", rank=rank, world_size=2, local_rank=rank,
                     local_world_size=2, init_method=f"tcp://127.0.0.1:{port}",
                     devices=shared)
    for phase in spec["phases"]:
        got = _dp_train(phase["argv"])
        if rank == 0:
            torch.save(got["state"], phase["dump"])
        got.pop("state")
        if phase.get("time"):
            got["step_ms"] = _dp_step_ms(phase["argv"])
        print("DP " + json.dumps({"rank": rank, "phase": phase["name"], **got}), flush=True)
    return 0


def _dp_gap(what: str, got: dict, want: dict, steps: int, init=None,
            later_rtol: float = DP_LOSS_RTOL) -> str:
    """``got`` against the one-process ``want``: the first step's loss
    within DP_LOSS_RTOL, the later ones within ``later_rtol``; every param
    within DP_STEP_ATOL x ``steps``; every BN running statistic within
    DP_STATS_RTOL of max(1, |statistic|) (they follow the activations, not
    Adam's bounded step); with ``init`` (the params both started from), the
    relative L2 of the params' difference to the one-process update."""
    import numpy as np

    rels = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    bounds = [DP_LOSS_RTOL] + [later_rtol] * (len(rels) - 1)
    worst = {"param": (0.0, ""), "stat": (0.0, "")}
    for g_sd, w_sd in zip(got["state"], want["state"]):
        for k, w in w_sd.items():
            kind = "stat" if "running" in k else "param"
            d = (g_sd[k].float() - w.float()).abs()
            if kind == "stat":
                d = d / w.float().abs().clamp_min(1.0)
            d = float(d.max())
            if d > worst[kind][0]:
                worst[kind] = (d, k)
    extra = ""
    if init is not None:
        num = sum(float(((got["state"][0][k] - w).double() ** 2).sum())
                  for k, w in want["state"][0].items() if k in init and "running" not in k)
        den = sum(float(((w - init[k]).double() ** 2).sum())
                  for k, w in want["state"][0].items() if k in init and "running" not in k)
        extra = (f"; params' difference {np.sqrt(num / max(den, 1e-30)):.3g} of the "
                 f"one-process run's own update (relative L2)")
    bound = DP_STEP_ATOL * steps
    (p_gap, p_name), (s_gap, s_name) = worst["param"], worst["stat"]
    line = (f"{what}: per-step losses {', '.join(f'{r:.3g}' for r in rels)} relative "
            f"from one process (bound {DP_LOSS_RTOL}, then {later_rtol}); params max diff "
            f"{p_gap:.3g} ({p_name}; bound {bound:.3g} = {DP_STEP_ATOL} x {steps} steps); "
            f"BN running statistics max diff {s_gap:.3g} of max(1, |stat|) ({s_name}; "
            f"bound {DP_STATS_RTOL}){extra}")
    if (len(got["losses"]) != len(want["losses"]) or any(map(float.__gt__, rels, bounds))
            or p_gap > bound or s_gap > DP_STATS_RTOL):
        raise AssertionError(line)
    return line


def phase_dp(work: Path, manifest: Path, card: str, device: str = "cuda") -> dict:
    """Data-parallel training: (a) run (a)'s flags at world size 1 over
    NCCL in this process, (b) two ranks on cuda:0 over gloo (this script
    started twice with ``--dp-rank``): the pixel run, then the GAN phase in
    its work dir, (c) (b)'s pixel checkpoint exported and served as sr x2
    through K1, (d) torchrun with two processes on this machine. Each run
    held to the one-process run of its flags. Returns K1's launches on the
    serve leg."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import export
    from image_super_resolution_tpu_torch.cli import train as cli_train
    from image_super_resolution_tpu_torch.core.mesh import (distributed_init,
                                                            distributed_teardown)
    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB, load_artifact
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.utils.image_io import read_image_rgb

    def argv(flags, sub, *more):
        return _train_argv(flags, manifest, work / sub, device, "--epochs", "1", *DP_EXTRA,
                           *more)

    cards = torch.cuda.device_count() if device == "cuda" else 0
    px = argv(DP_FLAGS, "one")
    opt = cli_train.build_parser().parse_args(px)
    cli_train.check_options(opt)
    init = {k: t.detach().cpu() for k, t in
            cli_train.build_model(opt, torch.device(device)).state_dict().items()}
    one = _dp_train(px)
    steps = one["steps"]
    times = {"one process": _dp_step_ms(px, "one process", card)}

    # (a) world size 1 over NCCL (gloo on a CPU rehearsal), in this process
    distributed_init(device, "nccl" if device == "cuda" else "gloo", rank=0, world_size=1,
                     local_rank=0, local_world_size=1,
                     init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        nccl = _dp_train(argv(DP_FLAGS, "nccl1"))
        times["world 1 over NCCL"] = _dp_step_ms(argv(DP_FLAGS, "nccl1"),
                                                 "world 1 over NCCL", card)
    finally:
        distributed_teardown()
    line = _dp_gap("(a)", nccl, one, steps, init)
    _log(f"[dp] (a) sr x2 d16 w64 BN --resnet, world size 1 over "
         f"{'NCCL' if device == 'cuda' else 'gloo'} on {nccl['device']} (GlobalBatchNorm, "
         f"the gradient all-reduce, the epoch's loss all-reduce and the state broadcast "
         f"all run), {steps} steps vs one process: {line.split(': ', 1)[1]}; "
         f"{nccl['saves']} checkpoint written")
    if nccl["saves"] != 1:
        raise AssertionError("(a) wrote no checkpoint")

    # (b) two ranks sharing cuda:0 over gloo: pixel, then GAN in its work dir
    spec = work / "dp_spec.json"
    spec.write_text(json.dumps({"device": device, "phases": [
        {"name": "pixel", "argv": argv(DP_FLAGS, "gloo2"), "dump": str(work / "dp_px.pt"),
         "time": True},
        {"name": "gan", "argv": argv(DP_GAN_FLAGS, "gloo2"), "dump": str(work / "dp_gan.pt")}]}))
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), str(port), str(spec)], cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"(b) rank {r} exited {proc.returncode}:\n{out[-3000:]}")
    res = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("DP "):
                d = json.loads(ln[3:])
                res[(d["rank"], d["phase"])] = d
    # the one-process GAN run from (b)'s pixel checkpoint: both GAN runs
    # start from the same G (and the same seeded D)
    ckpt = next((work / "gloo2").glob("res_*.ckpt"))
    (work / "one_gan").mkdir()
    shutil.copy(ckpt, work / "one_gan" / ckpt.name)
    one_gan = _dp_train(argv(DP_GAN_FLAGS, "one_gan"))
    for name, dump, ref, from_ in (("pixel", "dp_px.pt", one, init),
                                   ("gan", "dp_gan.pt", one_gan, None)):
        r0, r1 = res[(0, name)], res[(1, name)]
        if r0["hash"] != r1["hash"]:
            raise AssertionError(f"(b) {name}: ranks' params differ ({r0['hash']} vs "
                                 f"{r1['hash']})")
        if (r0["saves"], r1["saves"]) != (1, 0):
            raise AssertionError(f"(b) {name}: checkpoints written by rank 0 / 1: "
                                 f"{r0['saves']} / {r1['saves']}, want 1 / 0")
        got = dict(r0, state=torch.load(work / dump))
        line = _dp_gap(f"(b) {name}", got, ref, steps, from_,
                       DP_LOSS_RTOL if name == "pixel" else DP_GAN_LOSS_RTOL)
        if name == "gan":
            line += (f"; one process, VGG on the batch's two halves instead of the whole: "
                     f"loss/content {_content_split_gap(argv(DP_GAN_FLAGS, 'one_gan')):.3g} "
                     f"relative")
        title = ("(sr x2 d16 w64 BN --resnet)" if name == "pixel" else
                 "(G warm-started from the two-rank pixel checkpoint, as is the "
                 "one-process run held against it; D 3-64-8-1024, VGG19 (5, 4) random "
                 "features)")
        _log(f"[dp] (b) {name} {title}, "
             f"two ranks on {r0['device']} / {r1['device']} over gloo, 8 rows each of "
             f"every batch of 16: {line.split(': ', 1)[1]}; ranks bit-equal (params hash "
             f"{r0['hash']}); checkpoints written by rank 0 / 1: {r0['saves']} / "
             f"{r1['saves']}")
    times["two ranks on one card over gloo"] = res[(0, "pixel")]["step_ms"]
    _log(f"[dp] (b) two processes, start to exit: {secs:.1f} s")

    # (c) (b)'s pixel checkpoint -> .isr -> served as sr x2 through K1
    isr = work / "dp.isr"
    spec_out = export.main(["--checkpoint", str(ckpt), "--out", str(isr), "--scale", "2",
                            "--device", device])
    paths = json.loads(manifest.read_text())
    x = np.stack([read_image_rgb(p)[8:56, 16:64] for p in paths[:16]])  # b16 48x48
    model = load_artifact(isr, device=device)
    n = 3
    scatter_rdb.launches = 0
    for _ in range(n):
        out = model(x)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = scatter_rdb.launches
    want = 3 * spec_out.depth * n if device == "cuda" else 0
    if launches != want or tuple(out.shape) != (len(x), 96, 96, 3):
        raise AssertionError(f"(c) served {tuple(out.shape)} with {launches} fused_rdb "
                             f"launches, want {want}")
    plain = _against_plain("(c) sr x2 from the two-rank checkpoint", out.cpu(),
                           lambda: model(x).cpu(), BF16_MAX_LSB)
    _log(f"[dp] (c) the two-rank pixel checkpoint -> cli.export -> .isr -> load_artifact, "
         f"sr x2 d{spec_out.depth} w{spec_out.width} bf16 b{len(x)} t48 on {card}: fused_rdb "
         f"launches {launches} ({3 * spec_out.depth} per forward, {n} forwards); {plain}")

    # (d) torchrun, two processes on this machine
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(_free_port()), "-m", f"{PACKAGE}.cli.train",
           *argv(DP_FLAGS, "torchrun")]
    t0 = time.perf_counter()
    res_d = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    text = res_d.stdout + res_d.stderr
    if device == "cuda" and cards < 2:
        if res_d.returncode == 0 or "one process per card" not in text:
            raise AssertionError(f"(d) torchrun with 2 processes on {cards} card exited "
                                 f"{res_d.returncode}:\n{text[-3000:]}")
        msg = next(ln for ln in text.splitlines() if "one process per card" in ln)
        _log(f"[dp] (d) torchrun --nproc_per_node 2 on {cards} card: exit code "
             f"{res_d.returncode} in {time.perf_counter() - t0:.1f} s with "
             f"{msg.strip()[msg.strip().find('distributed_init'):][:200]!r}")
    else:
        used = sorted(set(re.findall(r"device=(\S+),", text)))
        if res_d.returncode != 0 or (device == "cuda" and len(used) < 2):
            raise AssertionError(f"(d) torchrun exited {res_d.returncode}, devices {used}:"
                                 f"\n{text[-3000:]}")
        _log(f"[dp] (d) torchrun --nproc_per_node 2 trained on {used}"
             + (" (distinct cards)" if device == "cuda" else ""))
    _log(f"[dp] step times, sr x2 d16 w64 BN batch 16 (per rank: its rows), CUDA events, "
         f"mean of 5 after 2, on {card}: "
         + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items())
         + " (one card: the cost of the collectives, not scaling)")
    return {"launches": launches, "step_ms": times}


# ----------------------------------------------------------------- phase 17 --

# Both quality experiments' run() at full width and depth with a cut budget:
# one epoch per arm. The flagship keeps its 240 training images: make_dataset
# draws the val split after the train split from one generator, so another
# --n_train would score other val images than the JAX package's readings.
QUALITY_FLAGSHIP = ("--arms", "R,F", "--epochs", "1")
QUALITY_DENOISE = ("--epochs", "1", "--refine_blocks", "2", "--refine_width", "64")
# The JAX package's bicubic PSNR-Y on that val split at x4
# (docs/results/flagship_gan_results.json); the baseline sees no model, so
# the port must read it to the eval protocol's resolution.
JAX_BICUBIC_X4, BASELINE_DB = 24.7477, 0.01


def _experiment(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _first_eval_batches():
    """Within: each call of the port's eval CLI keeps its first served batch
    under the tag the experiments give that eval (the artifact's stem, and
    ``_int8`` under ``--int8``): the model object the CLI served, its uint8
    LR on the device and the output it produced, on the host."""
    from unittest import mock

    import torch

    from image_super_resolution_tpu_torch.cli import evaluate
    from image_super_resolution_tpu_torch.models.deploy import DeployedModel
    from image_super_resolution_tpu_torch.models.quantized import Int8DeployedFast

    firsts, current, eval_main = {}, [], evaluate.main

    def counted_main(argv=None):
        opt = evaluate.build_parser().parse_args(argv)
        current[:] = [Path(opt.model).stem + ("_int8" if opt.int8 else "")]
        try:
            return eval_main(argv)
        finally:
            current.clear()

    def keep_first(cls):
        serve = cls.__call__

        def call(self, u8_batch):
            out = serve(self, u8_batch)
            if current and current[0] not in firsts:
                firsts[current[0]] = (self, torch.as_tensor(u8_batch).to(self.device),
                                      out.cpu().numpy())
            return out
        return mock.patch.object(cls, "__call__", call)

    with mock.patch.object(evaluate, "main", counted_main), keep_first(DeployedModel), \
            keep_first(Int8DeployedFast):
        yield firsts


def phase_quality(work: Path, card: str, device: str = "cuda") -> dict:
    """Phase 17: the flagship (arms R, F) and denoise (R, F, N) experiments
    through their run() on the card, every result finite, the bicubic
    baseline at JAX's reading; K1 counted on the R eval and K2 on every
    --int8 eval (from each script's timings.json, and the run's totals set
    to 0 before and read after), each per forward as the artifact says; the
    first batch each counted eval served, and the output it gave there, held
    against the same model under the plain versions. Returns the launches
    by path."""
    import math

    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB
    from image_super_resolution_tpu_torch.models.quantized import INT8_CARD_MAX_LSB
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    runs = (("flagship", "torch_flagship_quality_experiment", QUALITY_FLAGSHIP,
             "x4, 240 training images (15 steps), depth and width of the JAX protocol, "
             "epochs 120 -> 1"),
            ("denoise", "torch_denoise_quality_experiment", QUALITY_DENOISE,
             "x1 --denoise_eval, 240 training images (15 steps), full depth and width, "
             "epochs 120 -> 1, no W arm"))
    counts = {}
    for title, script, argv, cuts in runs:
        ws = work / title
        scatter_rdb.launches = conv3x3_int8.launches = 0
        t0 = time.perf_counter()
        with _first_eval_batches() as firsts:
            results = _experiment(script).run([*argv, "--workdir", str(ws), "--device", device])
        secs = time.perf_counter() - t0
        totals = {"scatter_rdb": scatter_rdb.launches, "conv3x3_int8": conv3x3_int8.launches}
        timings = json.loads((ws / "timings.json").read_text())
        bad = [f"{tag}.{k}" for tag, res in results.items()
               for k, v in (res.items() if isinstance(res, dict) else [("", res)])
               if not isinstance(v, bool) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"quality {title}: non-finite results {bad}")
        counted = {}
        for arm, t in timings.items():
            for tag, ev in t.items():
                if tag not in results:
                    continue
                res = results[tag]
                if title == "flagship" and abs(res["bicubic_psnr_y"] - JAX_BICUBIC_X4) > \
                        BASELINE_DB:
                    raise AssertionError(f"quality {tag}: bicubic_psnr_y {res['bicubic_psnr_y']}"
                                         f", JAX's {JAX_BICUBIC_X4} (bound {BASELINE_DB} dB)")
                int8 = tag.endswith("_int8")
                isr = ws / f"{tag.removesuffix('_int8')}.isr"
                kernel = "conv3x3_int8" if int8 else "scatter_rdb"
                per_forward = sum(_per_forward(isr, int8).values())
                want = per_forward * res["n_batches"] if device == "cuda" else 0
                other = "scatter_rdb" if int8 else "conv3x3_int8"
                if ev[kernel] != want or ev[other]:
                    raise AssertionError(f"quality eval {tag}: launches {ev}, want {kernel} "
                                         f"{want}")
                _log(f"[quality] eval {tag} on {card}: {res['n_images']} images, "
                     f"{ev['wall_s']:.3f} s wall, {kernel} {ev[kernel]} launches "
                     f"({per_forward} per forward); psnr_y {res['psnr_y']}, "
                     + ", ".join(f"{k} {v}" for k, v in res.items()
                                 if k.startswith(("bicubic_psnr", "noisy_psnr"))))
                if not per_forward:
                    continue
                counted[kernel] = counted.get(kernel, 0) + ev[kernel]
                path = f"quality {title} train -> export -> evaluate {tag} (phase 17)"
                counts[path] = (kernel.replace("scatter_rdb", "fused_rdb"), ev[kernel])
                # the counted eval's first batch again, under the plain versions
                model, lr, got = firsts[tag]
                _log(f"[quality] {tag}, first eval batch {tuple(lr.shape)}: "
                     + _against_plain(f"quality {tag}", got, lambda: model(lr).cpu().numpy(),
                                      INT8_CARD_MAX_LSB if int8 else BF16_MAX_LSB))
            _log(f"[quality] {title} arm {arm}: {t['wall_s']:.1f} s wall (train "
                 f"{t['train']['wall_s']:.1f} s, {t['train']['ms_per_step']} ms per step)")
        if totals != {k: counted.get(k, 0) for k in totals}:
            raise AssertionError(f"quality {title}: {totals} launched in run(), "
                                 f"{counted} in its evals")
        _log(f"[quality] {title} run() on {card} in {secs:.1f} s; cuts: {cuts}; "
             f"flags {' '.join(argv)}; gate {json.dumps(results.get('gate'))}")
    return counts


def _sweep_and_gan_vs_pixel(work: Path, card: str, device: str) -> dict:
    """Phase 17's last two scripts: the severity sweep over the denoise
    experiment's work dir (N also in int8) and the GAN-vs-pixel protocol
    for one epoch per phase; every result finite; each eval's launches
    against its artifact's per-forward count; the GAN-vs-pixel evals' first
    batches again under the plain versions. Returns the launches by path."""
    import math

    from image_super_resolution_tpu_torch.models.deploy import BF16_MAX_LSB
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    def finite(title, results):
        bad = [f"{tag}.{k}" for tag, res in results.items() for k, v in res.items()
               if not isinstance(v, bool) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{title}: non-finite results {bad}")

    def check(tag, isr, int8, ev, n_batches):
        kernel, other = (("conv3x3_int8", "scatter_rdb") if int8 else
                         ("scatter_rdb", "conv3x3_int8"))
        want = sum(_per_forward(isr, int8).values()) * n_batches if device == "cuda" else 0
        if ev[kernel] != want or ev[other]:
            raise AssertionError(f"{tag}: launches {ev}, want {kernel} {want}")
        return kernel, ev[kernel]

    counts = {}
    ws = work / "denoise"
    scatter_rdb.launches = conv3x3_int8.launches = 0
    t0 = time.perf_counter()
    results = _experiment("torch_denoise_severity_sweep").run(
        ["--workdir", str(ws), "--severities", "light,heavy", "--int8_arms", "N",
         "--device", device])
    secs = time.perf_counter() - t0
    finite("severity sweep", results)
    timings = json.loads((ws / "severity_sweep_timings.json").read_text())
    k2 = 0
    for key, res in results.items():
        int8 = key.endswith("_int8")
        kernel, n = check(key, ws / f"{key.split('@')[0]}.isr", int8, timings[key],
                          res["n_batches"])
        k2 += n if int8 else 0
        _log(f"[quality] sweep {key} on {card}: psnr_y {res['psnr_y']}, noisy_psnr_y "
             f"{res['noisy_psnr_y']}, {timings[key]['wall_s']:.3f} s, {kernel} {n}")
    if (scatter_rdb.launches, conv3x3_int8.launches) != (0, k2):
        raise AssertionError(f"severity sweep: {scatter_rdb.launches} K1 and "
                             f"{conv3x3_int8.launches} K2 launches, {k2} K2 in its evals")
    _log(f"[quality] severity sweep light,heavy (N int8) on {card} in {secs:.1f} s")
    counts["denoise severity sweep light,heavy, N --int8 evals (phase 17)"] = (
        "conv3x3_int8", k2)

    ws = work / "gan_vs_pixel"
    scatter_rdb.launches = conv3x3_int8.launches = 0
    t0 = time.perf_counter()
    with _first_eval_batches() as firsts:
        results = _experiment("torch_gan_vs_pixel_experiment").run(
            ["--workdir", str(ws), "--e1", "1", "--e2", "1", "--device", device])
    secs = time.perf_counter() - t0
    finite("GAN vs pixel", {k: v for k, v in results.items() if k != "content_loss"})
    timings = json.loads((ws / "timings.json").read_text())
    k1 = 0
    for arm, t in timings.items():
        tag = next(k for k in t if k != "train")
        res = results[arm]
        kernel, n = check(arm, ws / f"{tag}.isr", False, t[tag], res["n_batches"])
        k1 += n
        model, lr, got = firsts[tag]
        _log(f"[quality] gan-vs-pixel {arm} on {card}: psnr_y {res['psnr_y']}, train "
             f"{t['train']['wall_s']:.1f} s ({t['train']['epochs']} epochs), eval "
             f"{t[tag]['wall_s']:.3f} s, {kernel} {n}; first eval batch "
             f"{tuple(lr.shape)} "
             + _against_plain(f"gan-vs-pixel {arm}", got, lambda: model(lr).cpu().numpy(),
                              BF16_MAX_LSB))
    if (scatter_rdb.launches, conv3x3_int8.launches) != (k1, 0):
        raise AssertionError(f"GAN vs pixel: {scatter_rdb.launches} K1 launches, {k1} in "
                             f"its evals")
    _log(f"[quality] GAN vs pixel --e1 1 --e2 1 on {card} in {secs:.1f} s; content loss "
         f"{json.dumps(results.get('content_loss'))}")
    counts["GAN vs pixel x2 d2 A/B/C train -> export -> evaluate (phase 17)"] = (
        "fused_rdb", k1)
    return counts


# ----------------------------------------------------------------- phase 18 --

WINO_BATCH = (256, 24)  # the bench's batch and tile
WINO_CROP = 96  # side of the crop held against the CPU's fp32 direct path
WINO_PROGRAM = (2, (2, 24, 24))  # depth and (batch, H, W) of the exported program
# (label, argv, sr x4 benches, fast int8 benches) of each CLI run
BENCH_RUNS = (("default (fast, then the sr diagnostic)", (), 1, 0),
              ("--int8", ("--int8",), 1, 1),
              ("--family sr", ("--family", "sr"), 1, 0),
              ("--family denoise_fast", ("--family", "denoise_fast"), 0, 0),
              ("--preset denoise_fullres", ("--preset", "denoise_fullres"), 0, 0))
BENCH_CHAINS = (1, 2)  # k_short, k_long: the CLI's are 1 and 6
JAX_BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def _winograd_serving(sr_isr: Path, card: str, device: str) -> dict:
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.models.deploy import (
        BF16_MAX_LSB, WINO_BF16_MAX_LSB, WINO_FP32_MAX_LSB, DeployedModel, export_program,
        load_program, read_artifact)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.utils.serialization import map_tree, to_fp32

    spec, params = read_artifact(sr_isr)
    params = map_tree(to_fp32, params)
    b, t = WINO_BATCH
    rng = np.random.default_rng(SEED + 18)
    x = torch.from_numpy(rng.integers(0, 256, (b, t, t, 3), dtype=np.uint8)).to(device)
    crop = rng.integers(0, 256, (1, WINO_CROP, WINO_CROP, 3), dtype=np.uint8)
    cpu_ref = DeployedModel(spec, params, dtype=torch.float32, device="cpu")(crop).numpy()
    paths = (("K1 direct bf16", 0, torch.bfloat16, BF16_MAX_LSB),
             ("Winograd F(2,3) bf16", 2, torch.bfloat16, WINO_BF16_MAX_LSB),
             ("Winograd F(4,3) fp32", 4, torch.float32, WINO_FP32_MAX_LSB))
    outs, counts = {}, {}
    for name, m, dtype, bound in paths:
        deployed = DeployedModel(spec, params, dtype=dtype, device=device, wino_m=m)
        torch.cuda.reset_peak_memory_stats()
        out, _, launches, _ = _counted(scatter_rdb, lambda: deployed(x))
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = 3 * spec.depth if m == 0 and device == "cuda" else 0
        if launches != want:
            raise AssertionError(f"{name}: fused_rdb launched {launches} times in one "
                                 f"forward, want {want}")
        if m == 0:
            counts["serve sr x4 K1 beside the Winograd paths (phase 18)"] = ("fused_rdb",
                                                                            launches)
        if out.dtype != torch.uint8 or tuple(out.shape) != (b, 4 * t, 4 * t, 3):
            raise AssertionError(f"{name}: bad output {out.dtype} {tuple(out.shape)}")
        ms = _cuda_ms(lambda: deployed(x), warmup=1, iters=5)
        got = deployed(torch.from_numpy(crop).to(device)).cpu().numpy()
        worst, share = _lsb(got, cpu_ref)
        if worst > bound:
            raise AssertionError(f"{name}: {WINO_CROP}x{WINO_CROP} crop max {worst} LSB "
                                 f"from the CPU fp32 direct path (bound {bound})")
        outs[name] = (out.cpu().numpy(), got)
        _log(f"[wino] {name} sr x{spec.scale} d{spec.depth} w{spec.width} b{b} t{t} on "
             f"{card}: {ms:.3f} ms per request "
             f"(CUDA events, 5 after 1), {b * (4 * t) ** 2 / ms / 1e3:.2f} output MPix/s, "
             f"peak memory {peak:.2f} GiB, fused_rdb {launches} launches per forward; "
             f"{WINO_CROP}x{WINO_CROP} crop vs CPU fp32 direct: max {worst} LSB "
             f"(bound {bound}), {share:.4f} differ")
        del deployed, out
    k1_batch, k1_crop = outs["K1 direct bf16"]
    for name, (batch_out, crop_out) in outs.items():
        if name == "K1 direct bf16":
            continue
        (wb, sb), (wc, sc) = _lsb(batch_out, k1_batch), _lsb(crop_out, k1_crop)
        if max(wb, wc) > BF16_MAX_LSB:
            raise AssertionError(f"{name}: max {max(wb, wc)} LSB from the K1 path on the "
                                 f"card (bound {BF16_MAX_LSB})")
        _log(f"[wino] {name} vs the K1 path on the card: batch max {wb} LSB ({sb:.4f} "
             f"differ), crop max {wc} ({sc:.4f}); bound {BF16_MAX_LSB}")

    depth, shape = WINO_PROGRAM
    small = dataclasses.replace(spec, depth=depth)
    small_params = {k: v for k, v in params.items()
                    if not k.startswith("rrdb") or int(k[4:]) < depth}
    deployed = DeployedModel(small, small_params, dtype=torch.bfloat16, device=device,
                             wino_m=2)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_program(deployed, *shape, Path(tmp) / "wino.pt2")
        program = load_program(Path(tmp) / "wino.pt2")
        secs = time.perf_counter() - t0
    xs = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(device)
    before = scatter_rdb.launches
    same = torch.equal(program(xs), deployed(xs))
    if not same or scatter_rdb.launches != before:
        raise AssertionError("Winograd program: not bit-equal to eager, or K1 launched")
    _log(f"[wino] export_program sr x4 d{depth} wino_m=2 bf16 {shape} -> load_program on "
         f"{card} in {secs:.1f} s: bit-equal to eager, no K1 launch")
    return counts


def _bench_runs(card: str, device: str) -> dict:
    import functools
    import io
    import math
    from unittest import mock

    from image_super_resolution_tpu_torch.cli import bench as bench_cli
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    k_short, k_long = BENCH_CHAINS
    # per bench() call: a warm call and 3 timed ones of each chain, the
    # CUDA-event pass over the long chain, one forward counting launches
    forwards = 4 * k_short + 4 * k_long + k_long + 1
    counts, cut = {}, functools.partial(bench_cli.bench, k_short=k_short, k_long=k_long)
    for label, argv, sr_benches, int8_benches in BENCH_RUNS:
        out, err = io.StringIO(), io.StringIO()
        scatter_rdb.launches = conv3x3_int8.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(bench_cli, "bench", cut), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            result = bench_cli.main([*argv, "--device", device])
        secs = time.perf_counter() - t0
        k1, k2 = scatter_rdb.launches, conv3x3_int8.launches
        for line in err.getvalue().splitlines():
            _log(f"[bench] {line}")
        lines = out.getvalue().splitlines()
        if len(lines) != 1 or json.loads(lines[0]) != result or \
                list(result) != JAX_BENCH_KEYS or result["vs_baseline"] is not None or \
                not math.isfinite(result["value"]):
            raise AssertionError(f"bench {label}: stdout {out.getvalue()!r}")
        want = (48 * forwards * sr_benches, 29 * forwards * int8_benches) \
            if device == "cuda" else (0, 0)
        if (k1, k2) != want:
            raise AssertionError(f"bench {label}: K1 {k1}, K2 {k2} launches, want {want}")
        _log(f"[bench] {label} on {card}, chains {k_short} and {k_long}, {secs:.1f} s: "
             f"{lines[0]}; K1 {k1}, K2 {k2} launches ({forwards} forwards per bench)")
        if k1:
            counts[f"bench {label}: sr x4 (phase 18)"] = ("fused_rdb", k1)
        if k2:
            counts[f"bench {label}: fast x4 int8 (phase 18)"] = ("conv3x3_int8", k2)
    return counts


def phase_winograd_bench(sr_isr: Path, card: str, device: str = "cuda") -> dict:
    """Phase 18: the Winograd serving paths beside K1's, then the bench CLI.
    Returns the launches by path."""
    return {**_winograd_serving(sr_isr, card, device), **_bench_runs(card, device)}

# ----------------------------------------------------------------- phase 19 --

K3_SHAPES = ((8, 270, 480, 64), (8, 96, 96, 64))  # rcan_x4.frames' trunk, a tile batch
RCAN_DIMS = (10, 20, 64, 16)  # groups, blocks, width, reduction: the published x4
RCAN_FRAMES = (8, 270, 480)  # the rcan_x4.frames cell's batch
RCAN_VIDEO_BATCHES = 3  # batches served through rs.video_pipeline, counted
RCAN_CROP = 48  # side of the crop held against the CPU's fp32 path
# Card bf16 against the CPU's fp32 path on the crop: RMS within 1 LSB (the
# threshold that chose the bf16 stream, whose CPU readings at these widths
# are 0.69-0.76), no value further than rcan_x4.frames' limit.
RCAN_MAX_RMS_LSB, RCAN_MAX_LSB = 1.0, 15


def _k3_operands(shape, dtype, seed: int):
    """(x, r, bias, w1, b1, w2, b2) on the card: the stream ~60, conv1's
    output ~8 around 1, the CA MLP's weights at their init's scale."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    c, hidden = shape[-1], shape[-1] // 16

    def u(*s, scale=1.0):
        return (torch.rand(*s, generator=g, device="cuda") * 2 - 1) * scale

    return (u(*shape, scale=60.0).to(dtype), (u(*shape, scale=8.0) + 1).to(dtype),
            u(c, scale=0.1), u(hidden, c, scale=c ** -0.5), u(hidden, scale=0.1),
            u(c, hidden, scale=hidden ** -0.5), u(c, scale=0.1))


def _ulps(got, want) -> int:
    """The largest distance of two tensors of one float dtype in units in
    the last place (their bit patterns mapped to a monotonic integer)."""
    import torch

    bits = {torch.bfloat16: (torch.int16, 0x7FFF), torch.float32: (torch.int32, 0x7FFFFFFF)}
    view, mag = bits[got.dtype]

    def key(t):
        i = t.contiguous().view(view).long()
        return torch.where(i < 0, -(i & mag), i)

    return int((key(got) - key(want)).abs().max())


def phase_k3(kind: str, card: str, ptxas_log: str) -> dict:
    """K3 (``csrc/channel_attention.cu``): its ptxas report, then against its
    plain version at rcan_x4.frames' trunk shape (bf16 stream, and fp32) and
    at a tile batch, within ``KERNEL_ATOL + KERNEL_RTOL |want|``, bitwise
    the same on a second call, two launches a call. Where the relative
    limit rules (``|want| >= KERNEL_ATOL / KERNEL_RTOL``) a bf16 output is
    at most one ulp away, a single rounding flipped by the few fp32 ulps
    between the two means; below it the sum cancels (``x`` ~60 against a
    result ~1e-4), the fp32 values differ by ulps of the terms, and the
    absolute limit holds them. Then timed beside its plain version and its
    bound by bytes."""
    import torch

    from image_super_resolution_tpu_torch.ops.kernels import channel_attention as k3

    _ptxas("channel_attention", ptxas_log)
    k3.ca_residual.launches_by_pass.clear()
    checks, max_err = [(K3_SHAPES[0], torch.bfloat16), (K3_SHAPES[0], torch.float32),
                       (K3_SHAPES[1], torch.bfloat16)], 0.0
    for shape, dtype in checks:
        args = _k3_operands(shape, dtype, sum(shape))
        before = dict(k3.ca_residual.launches_by_pass)
        got, again = k3.ca_residual(*args), k3.ca_residual(*args)
        want = k3.ca_residual_reference(*args)
        torch.cuda.synchronize()
        launches = {p: k3.ca_residual.launches_by_pass.get(p, 0) - before.get(p, 0)
                    for p in ("reduce", "scale")}
        err = (got.float() - want.float()).abs()
        tol = k3.KERNEL_ATOL + k3.KERNEL_RTOL[dtype] * want.float().abs()
        rel = want.float().abs() >= k3.KERNEL_ATOL / k3.KERNEL_RTOL[dtype]
        bad, ulps = int((err > tol).sum()), _ulps(got[rel], want[rel])
        max_err = max(max_err, float(err.max()))
        _log(f"[kernel] channel_attention {tuple(shape)} {str(dtype)[6:]}: max_abs_err "
             f"{float(err.max()):.6g}, worst err / tol {float((err / tol).max()):.4f}, {bad} of "
             f"{err.numel()} outside |got - want| <= {k3.KERNEL_ATOL} + "
             f"{k3.KERNEL_RTOL[dtype]} * |want|; {int((got != want).sum())} values differ, "
             f"at most {ulps} ulp apart where |want| >= ATOL / RTOL ({int(rel.sum())} values), "
             f"{_ulps(got, want)} over all; launches {launches}")
        if bad or not torch.equal(got, again) or launches != {"reduce": 2, "scale": 2} or (
                dtype == torch.bfloat16 and ulps > 1):
            raise AssertionError(f"channel_attention disagrees with its plain version at "
                                 f"{shape} {dtype} (or with itself, or in its launches)")
    _, _, _, peak_bw = _peaks(kind)
    times = {}
    for shape, dtype in checks:
        args = _k3_operands(shape, dtype, 1)
        ms = _cuda_ms(lambda: k3.ca_residual(*args))
        plain_ms = _cuda_ms(lambda: k3.ca_residual_reference(*args), warmup=1, iters=5)
        nbytes = 4 * args[0].numel() * args[0].element_size()  # r twice, x, x'
        bound_ms = nbytes / peak_bw * 1e3
        times[f"{tuple(shape)} {str(dtype)[6:]}"] = {"ms": ms, "plain_ms": plain_ms,
                                                     "bound_ms": bound_ms}
        _log(f"[kernel] channel_attention {tuple(shape)} {str(dtype)[6:]} on {card}: kernel "
             f"{ms:.4f} ms (both passes), plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by "
             f"bytes ({nbytes:.4g} B at {peak_bw:.4g} B/s), {bound_ms / ms:.1%} of bound")
    main = times[f"{K3_SHAPES[0]} bfloat16"]
    return {
        "name": "channel_attention",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/channel_attention.cu",
        "replaces": None,  # a port kernel: the JAX package has no RCAN
        "launches": None,  # filled in from the rcan serving phase
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no one PyTorch call; its eager composition is the plain version
        "shapes": times,
    }


def _k3_counted(fn, per_forward: int, forwards: int, what: str, device: str):
    """fn() with ``ca_residual.launches_by_pass`` set to 0 just before and
    read just after: ``per_forward`` of each pass a forward on the card,
    none on the CPU. Returns (fn(), launches of both passes)."""
    import torch

    from image_super_resolution_tpu_torch.ops.kernels.channel_attention import ca_residual

    ca_residual.launches_by_pass.clear()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    got = dict(ca_residual.launches_by_pass)
    want = ({"reduce": per_forward * forwards, "scale": per_forward * forwards}
            if device == "cuda" else {})
    if got != want:
        raise AssertionError(f"{what}: channel_attention launched {got}, want {want}")
    return out, sum(got.values())


def phase_rcan(work: Path, card: str, device: str = "cuda") -> dict:
    """RCAN x4 at its published widths served as users serve it: seeded
    weights -> ``.isr`` -> ``load_artifact`` -> ``DeployedModel`` (bf16); a
    crop against the port's fp32 CPU path; requests at the frames shape
    timed, K3 counted (one reduce and one scale a block); then
    ``TiledUpscaler`` and ``rs.video_pipeline`` over RCAN_VIDEO_BATCHES
    frame batches, K3 counted, the frames equal to the model's own.
    Returns the launches by path."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.models.deploy import (DeploySpec, init_fused_params,
                                                                load_artifact, save_artifact)
    from image_super_resolution_tpu_torch.models.rcan import RCAN_MEAN, RCAN_STD

    groups, blocks, width, reduction = RCAN_DIMS
    spec = DeploySpec(family="rcan", depth=groups, blocks=blocks, width=width,
                      reduction=reduction, scale=4, mean=RCAN_MEAN, std=RCAN_STD)
    isr = work / "rcan_x4.isr"
    save_artifact(isr, spec, init_fused_params(spec, SEED))
    deployed = load_artifact(isr, dtype=torch.bfloat16, device=device)
    per_forward = groups * blocks
    rng = np.random.default_rng(SEED + 19)

    crop = rng.integers(0, 256, (1, RCAN_CROP, RCAN_CROP, 3), dtype=np.uint8)
    got, _ = _k3_counted(lambda: deployed(crop).cpu(), per_forward, 1, "rcan crop", device)
    want = load_artifact(isr, dtype=torch.float32, device="cpu")(crop)
    diff = (got.double() - want.double()).abs()
    rms, worst = float(diff.pow(2).mean().sqrt()), int(diff.max())
    _log(f"[rcan] x4 {groups}x{blocks} w{width} {RCAN_CROP}x{RCAN_CROP} crop, card bf16 vs "
         f"CPU fp32: RMS {rms:.4f} LSB (bound {RCAN_MAX_RMS_LSB}), max {worst} "
         f"(bound {RCAN_MAX_LSB})")
    if rms > RCAN_MAX_RMS_LSB or worst > RCAN_MAX_LSB:
        raise AssertionError("rcan's card output is outside the recorded bounds")

    b, h, w = RCAN_FRAMES
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)
    n = 5
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (ms, out), served = _k3_counted(lambda: _serve(deployed, x, n), per_forward, n + 1,
                                    "rcan requests", device)
    if out.dtype != torch.uint8 or tuple(out.shape) != (b, 4 * h, 4 * w, 3):
        raise AssertionError(f"bad rcan output {out.dtype} {tuple(out.shape)}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    _log(f"[rcan] x4 bf16 b{b} {h}x{w} on {card}: {ms:.3f} ms a request (host clock over {n} "
         f"after one), {b * h * w * 16 / ms / 1e3:.2f} output MPix/s; channel_attention "
         f"launches {served} ({per_forward} reduce and {per_forward} scale a forward); peak "
         f"memory {peak} B")

    frames = rng.integers(0, 256, (RCAN_VIDEO_BATCHES, b, h, w, 3), dtype=np.uint8)
    engine = TiledUpscaler(deployed)
    engine.upscale_batch(frames[0])  # warm-up batch
    written = []
    t0 = time.perf_counter()
    n_out, video = _k3_counted(
        lambda: rs.video_pipeline(engine, ((f, b) for f in frames), written.append),
        per_forward, RCAN_VIDEO_BATCHES, "rcan video", device)
    secs = time.perf_counter() - t0
    first = deployed(frames[0]).cpu().numpy()
    if n_out != RCAN_VIDEO_BATCHES * b or len(written) != n_out or not all(
            np.array_equal(written[i], first[i]) for i in range(b)):
        raise AssertionError("rcan video: frames missing or not the model's own")
    _log(f"[rcan] rs.video_pipeline, {n_out} frames {h}x{w} -> x4 on {card}: "
         f"{n_out / secs:.2f} frames/s (host clock); channel_attention launches {video}")
    return {"serve rcan x4 (phase 19)": served,
            "rs.video_pipeline rcan x4 (phase 19)": video}


# ----------------------------------------------------------------- phase 20 --

# (shape, dtype, padding, frame slot, flow scale in pixels): the propagation
# step, SPyNet's finest and coarsest levels, flows far out of the frame.
# (shape, dtype, padding, frame slot, flow scale, x as channel windows): the
# propagation's launch warps both branches' states, two 64-channel windows of
# the 128-channel tensor that stacks them; SPyNet's, its finest and coarsest
# levels.
K4_CASES = (((2, 270, 480, 64), "bfloat16", "zeros", True, 2.0, True),
            ((2, 270, 480, 64), "bfloat16", "zeros", True, 700.0, True),
            ((14, 288, 480, 3), "float32", "border", False, 4.0, False),
            ((14, 9, 15, 3), "float32", "border", False, 40.0, False))
BASICVSR_DIMS = (64, 30)  # width, residual blocks a branch: the published x4
BASICVSR_SEGMENT = (15, 270, 480)  # basicvsr_x4.clips' segment
BASICVSR_VIDEO = 37  # frames through rs.video_pipeline: segments of 15, 15 and 7
BASICVSR_CROP = (5, 48, 64)  # frames, height, width held against the CPU's fp32 path
# Card bf16 against the CPU's fp32 path on the crop: RMS within 0.5 LSB
# (bf16 against float32 reads 0.14-0.27 on the CPU at published widths,
# 15 frames of 64x96, growing along the forward branch), no value more
# than 3 LSB away (measured 1 on the CPU).
BASICVSR_MAX_RMS_LSB, BASICVSR_MAX_LSB = 0.5, 3


def _k4_operands(case, seed: int):
    import torch

    shape, dtype, padding, frame, scale, windows = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, c = shape
    if windows:
        x = torch.randn(1, h, w, n * c, generator=g, device="cuda").to(getattr(torch, dtype))
        x = x.view(h, w, n, c).permute(2, 0, 1, 3)
    else:
        x = torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dtype))
    flow = (torch.rand(n, h, w, 2, generator=g, device="cuda") * 2 - 1) * scale
    slot = torch.randn(n, h, w, 8, generator=g, device="cuda").to(x.dtype) if frame else None
    return x, flow, padding, slot


def phase_k4(kind: str, card: str, ptxas_log: str) -> dict:
    """K4 (``csrc/flow_warp.cu``): its ptxas report, then against its plain
    version at each of ``K4_CASES`` within ``KERNEL_ATOL_REL * max|x| +
    KERNEL_RTOL |want|``, the frame slot bit for bit, bitwise the same on a
    second call, one launch a call; then timed beside its plain version,
    ``F.grid_sample`` on a ready grid in the features' dtype (the one
    PyTorch call that computes the warp, the yardstick; a bf16 grid cannot
    address a 480-wide row to the pixel, so it times the call, not the
    port's precision) and its bound by bytes."""
    import torch
    import torch.nn.functional as F

    from image_super_resolution_tpu_torch.ops.kernels import flow_warp as k4
    from perfbench.roofline.k4 import work_bytes

    _ptxas("flow_warp", ptxas_log)
    _, _, _, peak_bw = _peaks(kind)
    times, max_err = {}, 0.0
    for case in K4_CASES:
        x, flow, padding, slot = _k4_operands(case, sum(case[0]))
        before = sum(k4.flow_warp.launches_by_mode.values())
        got, again = k4.flow_warp(x, flow, padding, slot), k4.flow_warp(x, flow, padding, slot)
        want = k4.flow_warp_reference(x, flow, padding, slot)
        torch.cuda.synchronize()
        launches = sum(k4.flow_warp.launches_by_mode.values()) - before
        err = (got.float() - want.float()).abs()
        tol = (k4.KERNEL_ATOL_REL * float(x.float().abs().max())
               + k4.KERNEL_RTOL[x.dtype] * want.float().abs())
        bad = int((err > tol).sum())
        max_err = max(max_err, float(err.max()))
        what = (f"{tuple(case[0])} {case[1]}{' windows' if case[5] else ''} {padding} flows "
                f"+-{case[4]}")
        _log(f"[kernel] flow_warp {what}: max_abs_err {float(err.max()):.6g}, worst err / tol "
             f"{float((err / tol).max()):.4f}, {bad} of {err.numel()} outside; "
             f"{int((got != want).sum())} values differ; launches {launches}")
        if bad or not torch.equal(got, again) or launches != 2 or (
                slot is not None and not torch.equal(got[..., :8], slot)):
            raise AssertionError(f"flow_warp disagrees with its plain version at {what} (or "
                                 f"with itself, or in its launches)")
        ms = _cuda_ms(lambda: k4.flow_warp(x, flow, padding, slot))
        plain_ms = _cuda_ms(lambda: k4.flow_warp_reference(x, flow, padding, slot), warmup=1,
                            iters=5)
        xn, grid = x.permute(0, 3, 1, 2), k4.sampling_grid(flow).to(x.dtype)
        library_ms = _cuda_ms(lambda: F.grid_sample(xn, grid, mode="bilinear",
                                                     padding_mode=padding, align_corners=True))
        n, h, w, c = case[0]
        nbytes = work_bytes(n, h, w, c, 8 if slot is not None else 0, x.element_size(),
                            x.element_size())
        bound_ms = nbytes / peak_bw * 1e3
        times[what] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms}
        _log(f"[kernel] flow_warp {what} on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"grid_sample {library_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes ({nbytes} B), "
             f"{bound_ms / ms:.1%} of bound")
    main = times[next(iter(times))]
    return {"name": "flow_warp", "route": "cuda", "source": f"{PACKAGE}/csrc/flow_warp.cu",
            "replaces": None,  # a port kernel: the JAX package has no video model
            "launches": None,  # filled in from the basicvsr serving phase
            "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "shapes": times}


def _k4_counted(fn, want: dict, what: str, device: str):
    """fn() with ``flow_warp.launches_by_mode`` cleared just before and read
    just after: ``want`` on the card, nothing on the CPU."""
    import torch

    from image_super_resolution_tpu_torch.ops.kernels.flow_warp import flow_warp

    flow_warp.launches_by_mode.clear()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    got = dict(flow_warp.launches_by_mode)
    if got != (want if device == "cuda" else {}):
        raise AssertionError(f"{what}: flow_warp launched {got}, want {want}")
    return out, sum(got.values())


def phase_basicvsr(work: Path, card: str, device: str = "cuda") -> dict:
    """BasicVSR x4 at its published widths served as users serve it: seeded
    weights -> ``.isr`` -> ``load_artifact`` -> ``DeployedModel`` (bf16); a
    crop segment against the port's fp32 CPU path; SPyNet's |flow| on the
    cell's segment; a segment timed, K4 counted; then ``TiledUpscaler`` and
    ``rs.video_pipeline`` over ``BASICVSR_VIDEO`` frames in segments of 15,
    the last on its valid frames, each equal to the model on that segment
    alone. Returns the launches by path."""
    import numpy as np
    import torch

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
    from image_super_resolution_tpu_torch.models.basicvsr import BASICVSR_MEAN, BASICVSR_STD
    from image_super_resolution_tpu_torch.models.deploy import (DeploySpec, init_fused_params,
                                                                load_artifact, save_artifact)

    width, blocks = BASICVSR_DIMS
    spec = DeploySpec(family="basicvsr", width=width, blocks=blocks, scale=4,
                      mean=BASICVSR_MEAN, std=BASICVSR_STD)
    isr = work / "basicvsr_x4.isr"
    save_artifact(isr, spec, init_fused_params(spec, SEED))
    deployed = load_artifact(isr, dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(SEED + 20)

    def per_segment(t):  # a propagation warp a step for both branches
        return {"zeros": t - 1, "border": 6} if t > 1 else {}

    crop = rng.integers(0, 256, BASICVSR_CROP + (3,), dtype=np.uint8)
    got, _ = _k4_counted(lambda: deployed(crop).cpu(), per_segment(len(crop)), "basicvsr crop",
                         device)
    want = load_artifact(isr, dtype=torch.float32, device="cpu")(crop)
    diff = (got.double() - want.double())
    rms = max(float(d.pow(2).mean().sqrt()) for d in diff)
    worst = int(diff.abs().max())
    _log(f"[basicvsr] x4 w{width} b{blocks} {BASICVSR_CROP} crop, card bf16 vs CPU fp32: "
         f"largest frame RMS {rms:.4f} LSB (bound {BASICVSR_MAX_RMS_LSB}), max {worst} "
         f"(bound {BASICVSR_MAX_LSB})")
    if rms > BASICVSR_MAX_RMS_LSB or worst > BASICVSR_MAX_LSB:
        raise AssertionError("basicvsr's card output is outside the recorded bounds")

    t, h, w = BASICVSR_SEGMENT
    x = torch.from_numpy(rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)).to(device)
    with torch.inference_mode():
        flows = torch.cat(deployed.model.spynet(x.float() / 255))
    mag = flows.norm(dim=-1)
    _log(f"[basicvsr] SPyNet on a seeded {t}x{h}x{w} segment: |flow| mean "
         f"{float(mag.mean()):.4f} px, largest {float(mag.max()):.4f} px, largest component "
         f"{float(flows.abs().max()):.4f} px")
    n = 3
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    want_k4 = {m: v * (n + 1) for m, v in per_segment(t).items()}
    (ms, out), served = _k4_counted(lambda: _serve(deployed, x, n), want_k4, "basicvsr segments",
                                    device)
    if out.dtype != torch.uint8 or tuple(out.shape) != (t, 4 * h, 4 * w, 3):
        raise AssertionError(f"bad basicvsr output {out.dtype} {tuple(out.shape)}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    _log(f"[basicvsr] x4 bf16 segment {t}x{h}x{w} on {card}: {ms:.3f} ms a segment (host clock "
         f"over {n} after one), {t * h * w * 16 / ms / 1e3:.2f} output MPix/s; flow_warp "
         f"launches {served}; peak memory {peak} B")

    frames = rng.integers(0, 256, (BASICVSR_VIDEO, h, w, 3), dtype=np.uint8)
    segments = [(frames[i:i + t], len(frames[i:i + t])) for i in range(0, len(frames), t)]
    padded = [(np.concatenate([f, np.repeat(f[-1:], t - k, 0)]), k) for f, k in segments]
    engine = TiledUpscaler(deployed)
    written = []
    t0 = time.perf_counter()
    want_k4 = {m: sum(per_segment(k)[m] for _, k in segments) for m in ("zeros", "border")}
    n_out, video = _k4_counted(lambda: rs.video_pipeline(engine, iter(padded), written.append),
                               want_k4, "basicvsr video", device)
    secs = time.perf_counter() - t0
    own = np.concatenate([deployed(f).cpu().numpy() for f, _ in segments])
    if n_out != len(frames) or not np.array_equal(np.stack(written), own):
        raise AssertionError("basicvsr video: frames missing or not the model's own on each "
                             "segment's valid frames")
    _log(f"[basicvsr] rs.video_pipeline, {n_out} frames {h}x{w} -> x4 in segments "
         f"{[k for _, k in segments]} on {card}: {n_out / secs:.2f} frames/s (host clock); "
         f"flow_warp launches {video}")
    return {"serve basicvsr x4 (phase 20)": served,
            "rs.video_pipeline basicvsr x4 (phase 20)": video}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":  # phase 16 (b)'s ranks
        return _dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: no {PACKAGE} beside {Path(__file__).name}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # The plain versions are fp32 references: no TF32 in their convs.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, kind = phase_card()
    card = f"{smi} (nvidia-smi name, power limit)"
    logs = phase_build()
    k1 = phase_k1(kind, card, logs["fused_rdb"])
    k2 = phase_k2(kind, card, logs["matmul"])
    k3 = phase_k3(kind, card, logs["channel_attention"])
    with tempfile.TemporaryDirectory() as tmp:
        sr_isr, k1_serve = phase_sr(Path(tmp), card)
        fast_isr, k2_serve, by_variant = phase_fast(Path(tmp), card)
        k2["launches_by_variant"] = by_variant
        phase_denoise(card)
        phase_cli(Path(tmp), sr_isr, fast_isr, card)
        trained = phase_train(Path(tmp) / "train", kind, card)
        evals = phase_eval(Path(tmp) / "train", sr_isr, fast_isr, card)
        videos = phase_video(Path(tmp), sr_isr, fast_isr, card)
        k1_profile = phase_profile(Path(tmp) / "train", sr_isr, card)
        interop = phase_interop(Path(tmp) / "interop", Path(tmp) / "train", card)
        loader = phase_loader(Path(tmp) / "loader", Path(tmp) / "train" / "data" /
                              "train_images.json", card)
        t0 = time.perf_counter()
        multi = phase_multi(Path(tmp), sr_isr, fast_isr, card)
        _log(f"[multi] phase 15 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp = phase_dp(Path(tmp) / "dp", Path(tmp) / "train" / "data" / "train_images.json",
                      card)
        _log(f"[dp] phase 16 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        quality = phase_quality(Path(tmp) / "quality", card)
        quality.update(_sweep_and_gan_vs_pixel(Path(tmp) / "quality", card, "cuda"))
        _log(f"[quality] phase 17 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        wino_bench = phase_winograd_bench(sr_isr, card)
        _log(f"[wino] phase 18 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k3["launches_by_path"] = phase_rcan(Path(tmp), card)
        _log(f"[rcan] phase 19 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k4 = phase_k4(kind, card, logs["flow_warp"])
        k4["launches_by_path"] = phase_basicvsr(Path(tmp), card)
        _log(f"[basicvsr] phase 20 in {time.perf_counter() - t0:.1f} s")
    # launches: every counted main-path run, by path
    k1["launches_by_path"] = {"serve sr x4 (phase 5)": k1_serve,
                              "train -> checkpoint -> serve sr x2 (phase 9)":
                              trained["fused_rdb"],
                              "pixel -> GAN -> export -> serve sr x2 (phase 9)":
                              trained["fused_rdb gan"],
                              "rs --profile_dir, sr x4 (phase 12)": k1_profile}
    k2["launches_by_path"] = {"serve fast x4 int8 (phase 6)": k2_serve,
                              "train -> checkpoint -> serve fast x4 int8 (phase 9)":
                              trained["conv3x3_int8"]}
    k2["variants_train_serve"] = trained["conv3x3_int8 by variant"]
    if loader["launches"]:
        k2["launches_by_path"]["JPEGs -> native loader -> train -> serve fast x4 int8 "
                               "(phase 14)"] = loader["launches"]
    k1["launches_by_path"].update(interop)
    for path, n in {**evals, **videos}.items():
        if n:  # the Denoiser's eval runs neither kernel
            (k2 if "int8" in path else k1)["launches_by_path"][path] = n
    k1["launches_by_path"]["two ranks train -> checkpoint -> export -> serve sr x2 "
                           "(phase 16)"] = dp["launches"]
    for path, (kernel, n) in {**multi, **quality, **wino_bench}.items():
        if not n:
            raise AssertionError(f"{path}: {kernel} was launched no time")
        (k1 if kernel == "fused_rdb" else k2)["launches_by_path"][path] = n
    for k in (k1, k2, k3, k4):
        k["launches"] = sum(k["launches_by_path"].values())
    trained["timings"]["data-parallel step ms (phase 16)"] = dp["step_ms"]
    print(json.dumps({"kernels": [k1, k2, k3, k4], "training": trained["timings"],
                      "loader": loader["rates"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
