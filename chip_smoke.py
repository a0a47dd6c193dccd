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
   serving shape and at ragged and whole-image shapes, with the tolerance
   stated; then timed (CUDA events), whole and per launch, beside its plain
   version and the cuDNN yardstick;
4. K2: the ptxas report of ``csrc/matmul.cu`` (fails on a spill);
   ``matmul`` at the probe's check shape and a ragged one (int8 exact);
   ``conv3x3_int8`` in every variant (fp32 or int8 in, fp32 or int8 out,
   leaky on and off) at b256 t24 w128, 2x48x48, 1x93x93, 3x17x29 and two
   small odd-Cout shapes, exact against its plain version (the fp32
   stream carries ties); then the three serving variants timed at b256
   t24 beside their bounds, the plain version, a cuDNN bf16 conv and
   ``torch._int_mm``, and the 4096^3 GEMMs beside ``torch._int_mm`` and
   bf16 ``torch.matmul``;
5. ``sr`` x4 serving at full width: depth 16, width 64, random weights from
   a numpy seed -> ``.isr`` -> ``load_artifact`` -> ``DeployedModel`` in
   bf16 on a b256 t24 uint8 batch; K1's launches are counted over these
   requests, two tiles are held against the port's fp32 CPU path; then,
   outside the counted run, the request's time by stage (CUDA events) and
   by kernel (``torch.profiler``), with the device's idle share;
6. ``fast`` x4 serving at full width and depth (14, 128) on the same
   batch shape, in bf16 and then in int8 (``quantize_deployed`` calibrated
   on the batch; each conv0 site hands its conv1 an int8 tensor): K2's
   launches counted (29 per int8 forward, 0 per bf16 one) and by variant
   (14 fp32 -> int8, 14 int8 -> fp32, 1 fp32 -> fp32), two tiles held
   against the port's CPU paths, and the breakdown of both requests (the
   int8 one by K2 variant); then the same int8 path calibrated at the 99.9th
   percentile on that batch (2^24+ values per site), held to bf16;
7. ``denoise_fast`` (14, 128, downshuffle 2) in int8 through
   ``TiledUpscaler`` on one odd-sized image: output shape and launches;
8. the ``rs`` CLI on a folder of two PNGs (512x384 and odd-sized), with the
   ``sr`` artifact and then ``--int8`` with the ``fast`` artifact, each
   timed as one run: artifact load, calibration, both images and the host
   PNG codec;
9. the user's path at full width: 64 smooth 192x192 PNGs and their
   manifest written by ``cli.create_json``, then training through
   ``cli.train.main`` at the CLI defaults (batch 16, patch 96), one epoch
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
   per forward, two tiles against the CPU) and ``rs``.

It prints one JSON line of per-kernel numbers (each kernel's launches
summed over the counted runs of phases 5/6 and 9, and given by path) and
the training timings, the ``nvidia-smi`` line, and last ``{"ok": true,
"device": {...}}``. Without CUDA, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
ROOT = Path(__file__).resolve().parent
PACKAGE = "image_super_resolution_tpu_torch"
SOURCES = ("fused_rdb", "matmul")  # csrc/<name>.cu

# Dense peaks from NVIDIA's data sheets, by product name (first match):
# bf16 tensor-core FLOP/s, int8 tensor-core OP/s and device-memory bytes/s.
PEAKS = (
    ("H100 PCIe", 756e12, 1513e12, 2.0e12),
    ("H100 NVL", 835e12, 1671e12, 3.9e12),
    ("H200", 989e12, 1979e12, 4.8e12),
    ("H100", 989e12, 1979e12, 3.35e12),
)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _peaks(name: str):
    """(product, bf16 FLOP/s, int8 OP/s, bytes/s) for the card ``name``."""
    for row in PEAKS:
        if row[0] in name:
            return row
    _log(f"peaks: no entry for {name!r}; using the H100 SXM's")
    return PEAKS[-1]


def _bound(ops: float, nbytes: float, peak_ops: float, peak_bw: float):
    """(bound ms, "operations" or "bytes", ops ms, bytes ms)."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), \
        t_ops, t_bytes


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

def _k1_work(b: int, h: int, w: int):
    """(FLOP, bytes) the fused RDB needs: five 3x3 convs; x read and the
    output written once, the weights and bias read once."""
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import C, G, PC

    shapes = ((C, PC), (G, PC - G), (G, PC - 2 * G), (G, PC - 3 * G), (G, C))
    pixels = b * h * w
    flops = 2 * 9 * sum(ci * co for ci, co in shapes) * pixels
    nbytes = 2 * pixels * C * 2 + sum(9 * ci * co * 2 for ci, co in shapes) + PC * 4
    return flops, nbytes


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
    m = re.search(r"conv3x3_int8_kernelILb([01])ELb([01])ELi(\d+)E", mangled)
    if m:
        ks = "K steps unrolled" if m.group(3) != "0" else "K steps at run time"
        return (f"conv {'fp32' if m.group(1) == '1' else 'int8'} -> "
                f"{'fp32' if m.group(2) == '1' else 'int8'}, {ks}")
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

    flops, nbytes = _k1_work(*x.shape[:3])
    peak_name, peak_flops, _, peak_bw = _peaks(kind)
    bound_ms, bound_by, t_ops, t_bytes = _bound(flops, nbytes, peak_flops, peak_bw)
    _log(f"[kernel] fused_rdb b256 t24 on {card}: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, cuDNN five-conv scatter form {library_ms:.4f} ms "
         f"(its max_abs_err vs plain {lib_err:.4g}); bound {bound_ms:.4f} ms "
         f"({flops:.4g} FLOP at {peak_flops:.4g}/s = {t_ops:.4f} ms, {nbytes:.4g} B "
         f"at {peak_bw:.4g} B/s = {t_bytes:.4f} ms; {peak_name} peaks); "
         f"{flops / ms / 1e9:.1f} TFLOP/s achieved, {bound_ms / ms:.1%} of bound; "
         f"kernel / cuDNN {ms / library_ms:.3f}")
    _k1_launch_times(x, mats, card)
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


def _k1_launch_times(x, mats, card: str) -> None:
    """Each of K1's five launches timed alone (CUDA events) on the serving
    input, with its FLOP and rate: which launch leads."""
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1

    weights, bias = mats[:5], mats[5]
    out, y = k1._launch(x, weights, bias, 0.2, 0.01)
    pixels = x.shape[0] * x.shape[1] * x.shape[2]
    parts = []
    for i, launch in enumerate(k1.dense_plan()):
        ms = _cuda_ms(lambda: k1._launch(x, weights, bias, 0.2, 0.01, only=i, y=y, out=out))
        flops = 2 * pixels * 9 * k1.G * len(launch["groups"]) * launch["n"]
        parts.append(f"{i}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
    _log(f"[kernel] fused_rdb b256 t24 per launch on {card}: {'; '.join(parts)}")


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


# The conv site's variants on the fast int8 path, named as the wrapper
# counts them (matmul.conv_variant): (name, fp32 input, int8 output).
K2_VARIANTS = (("fp32 -> fp32", True, False),    # trunk_conv
               ("fp32 -> int8", True, True),     # conv0 sites
               ("int8 -> fp32", False, False))   # conv1 sites


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
    # out_inv_x.
    inv_x, out_inv_x = 0.25, 1.0

    def stream(shape):
        h32 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 40)
        h32[..., :4] = torch.tensor([0.5, -2.5, 300.0, -1e6]) / inv_x
        return h32.to(dev)

    # Every variant (fp32 or int8 in, fp32 or int8 out, leaky on and off) at
    # the serving shape, the denoise_fast and CLI tile shapes, a ragged
    # batch, and the small and odd-Cout shapes of tests/test_torch_cuda.py.
    max_err = 0.0
    for shape in ((256, 24, 24, 128, 128), (2, 48, 48, 128, 128), (1, 93, 93, 128, 128),
                  (3, 17, 29, 128, 128), (1, 1, 1, 32, 8), (1, 5, 3, 64, 130)):
        x8, w_q, deq, bias = site(*shape)
        w_k = k2.weights_k_major(w_q)
        x32 = stream(x8.shape)
        bad = total = 0
        for x, s_in in ((x32, inv_x), (x8, None)):
            for s_out in (None, out_inv_x):
                for leaky in (True, False):
                    got = k2.conv3x3_int8(x, w_q, deq, bias, leaky, s_in, s_out, w_k)
                    want = k2.conv3x3_int8_reference(x, w_q, deq, bias, leaky, s_in, s_out)
                    torch.cuda.synchronize()
                    if got.dtype != want.dtype:
                        raise AssertionError(f"conv3x3_int8 returned {got.dtype}")
                    bad += int((got != want).sum())
                    total += got.numel()
                    max_err = max(max_err, float((got.float() - want.float()).abs().max()))
        _log(f"[kernel] conv3x3_int8 {shape[:3]} {shape[3]}->{shape[4]}, 8 variants (fp32 "
             f"or int8 in, fp32 or int8 out, leaky on and off): {bad} of {total} values "
             f"differ from the plain version (tolerance: none)")
        if bad:
            raise AssertionError(f"conv3x3_int8 disagrees with its plain version at {shape}")

    x8, w_q, deq, bias = site(256, 24, 24)
    w_k = k2.weights_k_major(w_q)
    h32 = stream(x8.shape)
    b, h, w, c = x8.shape
    m = b * h * w
    ops = 2 * m * 9 * c * c
    variants = {}
    for name, f32_in, i8_out in K2_VARIANTS:
        x, s_in = (h32, inv_x) if f32_in else (x8, None)
        s_out = out_inv_x if i8_out else None
        ms = _cuda_ms(lambda: k2.conv3x3_int8(x, w_q, deq, bias, True, s_in, s_out, w_k))
        plain_ms = _cuda_ms(lambda: k2.conv3x3_int8_reference(x, w_q, deq, bias, True, s_in,
                                                              s_out), warmup=1, iters=3)
        nbytes = m * c * (4 if f32_in else 1) + w_k.numel() + 8 * c + m * c * (1 if i8_out else 4)
        bound_ms, bound_by, t_ops, t_bytes = _bound(ops, nbytes, peak_int8, peak_bw)
        # launches: filled in from the fast int8 serving phase
        variants[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
        _log(f"[kernel] conv3x3_int8 {name} b256 t24 w128 on {card}: {ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms by {bound_by} ({ops:.4g} int8 OP at {peak_int8:.4g}/s = "
             f"{t_ops:.4f} ms, {nbytes:.4g} B at {peak_bw:.4g} B/s = {t_bytes:.4f} ms; "
             f"{peak_name} peaks), {bound_ms / ms:.1%} of bound, {ops / ms / 1e9:.1f} TOP/s "
             f"achieved; plain version {plain_ms:.4f} ms")
    main = variants["fp32 -> fp32"]
    xb = x8.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last NCHW view
    wb = w_q.to(torch.bfloat16).reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    library_ms = _cuda_ms(lambda: F.conv2d(xb, wb, padding=1))
    int_mm_site_ms = _cuda_ms(_int_mm(i8(m, 9 * c), w_q))
    _log(f"[kernel] conv3x3_int8 yardsticks b256 t24 w128 on {card}: cuDNN bf16 conv "
         f"channels_last {library_ms:.4f} ms; torch._int_mm on its GEMM form ({m}x{9 * c}x{c}, "
         f"no im2col) {int_mm_site_ms:.4f} ms; fp32 -> fp32 kernel / cuDNN "
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
        "ms": main["ms"],  # the fp32 -> fp32 site (trunk_conv)
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
    _breakdown("sr bf16", lambda: deployed(xd), n, _module_stages(deployed.model))
    return isr, launches


def _event():
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _module_stages(model):
    """Stage marks from CUDA events on the model's top-level children;
    numbered repeats (rrdb0.., block0..) are summed as one stage."""
    import re

    def install(marks):
        handles = []
        for name, child in model.named_children():
            key = re.sub(r"\d+$", " (all)", name) if name.startswith(("rrdb", "block")) \
                else name

            def pre(_mod, _inp, key=key):
                marks.setdefault(key, []).append([_event(), None])

            def post(_mod, _inp, _out, key=key):
                marks[key][-1][1] = _event()

            handles += [child.register_forward_pre_hook(pre),
                        child.register_forward_hook(post)]
        return lambda: [h.remove() for h in handles]

    return install


def _int8_site_stages(marks):
    """Stage marks around each int8 trunk site, one stage per K2 variant:
    conv0 sites (fp32 in, int8 out for their conv1), conv1 sites (int8 in)
    and trunk_conv (fp32 in and out)."""
    import torch

    from image_super_resolution_tpu_torch.models import quantized

    orig = quantized.quant_site

    def timed(p, h, leaky, out_inv_x=None):
        e0 = _event()
        y = orig(p, h, leaky, out_inv_x)
        name = (f"conv3x3_int8 {'int8' if h.dtype == torch.int8 else 'fp32'} -> "
                f"{'int8' if y.dtype == torch.int8 else 'fp32'}")
        marks.setdefault(name, []).append([e0, _event()])
        return y

    quantized.quant_site = timed
    return lambda: setattr(quantized, "quant_site", orig)


def _breakdown(title: str, run, iters: int, install):
    """Where one request's time goes, after the counted run: CUDA events
    around the stages that ``install`` marks (the rest of the request --
    input copy, normalize, residual adds, shuffles, uint8 -- is the request
    less their sum), then device time by kernel name under
    ``torch.profiler`` and the device's idle share (1 - kernel time / the
    unprofiled request time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marks = {}
    cleanup = install(marks)
    try:
        start = _event()
        for _ in range(iters):
            run()
        end = _event()
        torch.cuda.synchronize()
    finally:
        cleanup()
    request_ms = start.elapsed_time(end) / iters
    stages = {f"{name} (x{len(pairs) // iters})":
              sum(a.elapsed_time(b) for a, b in pairs) / iters
              for name, pairs in marks.items()}
    stages["rest"] = request_ms - sum(stages.values())
    _log(f"[breakdown] {title}: request {request_ms:.4f} ms (CUDA events, mean of {iters})")
    for name, ms in stages.items():
        _log(f"[breakdown] {title}: stage {name:34s} {ms:9.4f} ms  {ms / request_ms:6.1%}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + dev_us / 1e3 / iters
    busy = sum(kernels.values())
    idle = (f"{1 - busy / request_ms:.1%} of the {request_ms:.4f} ms request (CUDA events, "
            f"unprofiled; {1 - busy / wall:.1%} of the {wall:.4f} ms host wall under the "
            f"profiler)" if busy else "not measured (no device events)")
    _log(f"[breakdown] {title}: profiler: device kernel time {busy:.4f} ms per request; "
         f"idle share {idle}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[breakdown] {title}: kernel {ms:9.4f} ms  {ms / max(busy, 1e-9):6.1%}  "
             f"{name[:100]}")


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
    # conv0 sites hand off int8 to their conv1; trunk_conv stays fp32
    per_forward = {"fp32 -> int8": spec.depth, "int8 -> fp32": spec.depth, "fp32 -> fp32": 1}
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
    _breakdown("fast bf16", lambda: deployed(xd), n, _module_stages(deployed.model))
    _breakdown("fast int8", lambda: quant(xd), n, _int8_site_stages)
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
        BF16_MAX_LSB, BF16_X2_MAX_LSB, DENOISE_BF16_MAX_LSB, FAST_BF16_MAX_LSB, DeploySpec,
        build_deployed, infer_family_dims)
    from image_super_resolution_tpu_torch.models.quantized import (
        INT8_CARD_MAX_LSB, Int8DeployedFast, quantize_deployed)
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8
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

    spec = spec_of("b", "fast", scale=4)
    fast, _ = build_deployed(ckpts["b"], spec, dtype=torch.bfloat16, device=device)
    x24 = np.ascontiguousarray(x[:, :24, :24])
    out16 = fast(x24)
    quant = quantize_deployed(fast, [x24])
    conv3x3_int8.launches = 0
    conv3x3_int8.launches_by_variant.clear()
    for _ in range(n):
        out8 = quant(x24)
    sync()
    counts["conv3x3_int8"] = conv3x3_int8.launches
    by_variant = dict(conv3x3_int8.launches_by_variant)
    want = {"fp32 -> int8": spec.depth * n, "int8 -> fp32": spec.depth * n, "fp32 -> fp32": n}
    if by_variant != want:
        raise AssertionError(f"trained fast int8 launched conv3x3_int8 {by_variant} in {n} "
                             f"forwards, want {want}")
    w16, s16 = _lsb(out16[:2].cpu(), build_deployed(ckpts["b"], spec, dtype=torch.float32,
                                                    device="cpu")[0](x24[:2]))
    w8, s8 = _lsb(out8[:2].cpu(), Int8DeployedFast(spec, quant.params, device="cpu")(x24[:2]))
    _log(f"[serve] trained fast x4 d{spec.depth} (checkpoint of run b) b{len(x)} t24 on {card}: int8 "
         f"conv3x3_int8 launches {counts['conv3x3_int8']} by variant {by_variant} ({n} "
         f"forwards, {2 * spec.depth + 1} per forward); 2 tiles: card int8 vs CPU int8 max {w8} LSB (bound "
         f"{INT8_CARD_MAX_LSB}), {s8:.4f} differ; card bf16 vs CPU fp32 max {w16} LSB (bound "
         f"{FAST_BF16_MAX_LSB}), {s16:.4f} differ")
    if w8 > INT8_CARD_MAX_LSB or w16 > FAST_BF16_MAX_LSB:
        raise AssertionError("trained fast card output is outside its bound")

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


def main() -> int:
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
    with tempfile.TemporaryDirectory() as tmp:
        sr_isr, k1_serve = phase_sr(Path(tmp), card)
        fast_isr, k2_serve, by_variant = phase_fast(Path(tmp), card)
        for name, counts in by_variant.items():
            k2["variants"][name].update(counts)
        phase_denoise(card)
        phase_cli(Path(tmp), sr_isr, fast_isr, card)
        trained = phase_train(Path(tmp) / "train", kind, card)
    # launches: every counted main-path run, by path
    k1["launches_by_path"] = {"serve sr x4 (phase 5)": k1_serve,
                              "train -> checkpoint -> serve sr x2 (phase 9)":
                              trained["fused_rdb"],
                              "pixel -> GAN -> export -> serve sr x2 (phase 9)":
                              trained["fused_rdb gan"]}
    k2["launches_by_path"] = {"serve fast x4 int8 (phase 6)": k2_serve,
                              "train -> checkpoint -> serve fast x4 int8 (phase 9)":
                              trained["conv3x3_int8"]}
    k2["variants_train_serve"] = trained["conv3x3_int8 by variant"]
    for k in (k1, k2):
        k["launches"] = sum(k["launches_by_path"].values())
    print(json.dumps({"kernels": [k1, k2], "training": trained["timings"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
