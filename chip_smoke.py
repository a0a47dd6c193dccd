#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run it from a checkout of the repository: it needs the package
``image_super_resolution_tpu_torch`` beside it and imports nothing of JAX.
Phases, each of which raises on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build of every CUDA source of the serving path, timed;
3. each kernel against its plain PyTorch version on the card, at the
   serving shape and at a ragged shape, with the tolerance stated; then
   timed (CUDA events) beside its plain version and the cuDNN yardstick;
4. the serving path at full width: ``sr`` x4, depth 16, width 64, random
   weights from a numpy seed -> ``.isr`` -> ``load_artifact`` ->
   ``DeployedModel`` in bf16 on a b256 t24 uint8 batch; the kernel's
   launches are counted over these requests, and two tiles are held
   against the port's fp32 CPU path; then, outside the counted run, the
   request's time by generator stage (CUDA events) and by kernel
   (``torch.profiler``), with the device's idle share;
5. the ``rs`` CLI on a folder of two PNGs (512x384 and odd-sized), timed
   as one run: artifact load, both images and the host PNG codec.

It prints one JSON line of per-kernel numbers, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. Without CUDA, or outside a
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

# Dense peaks from NVIDIA's data sheets, by product name (first match):
# bf16 tensor-core FLOP/s and device-memory bytes/s.
PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H200", 989e12, 4.8e12),
    ("H100", 989e12, 3.35e12),
)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return key, flops, bw
    _log(f"peaks: no entry for {name!r}; using the H100 SXM's")
    return "H100", PEAKS[-1][1], PEAKS[-1][2]


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
    log = _build.build("fused_rdb")
    secs = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            _log(f"[build] fused_rdb: {line.strip()}")
    _log(f"[build] nvcc sm_90a fused_rdb: {'built' if log else 'already built'} "
         f"in {secs:.1f} s")


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


def phase_kernel(kind: str):
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

    x, max_err = check(256, 24, 24)
    check(3, 17, 29)
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
    peak_name, peak_flops, peak_bw = _peaks(kind)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    _log(f"[kernel] fused_rdb b256 t24 on {kind}: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, cuDNN five-conv scatter form {library_ms:.4f} ms "
         f"(its max_abs_err vs plain {lib_err:.4g}); bound {bound_ms:.4f} ms "
         f"({flops:.4g} FLOP at {peak_flops:.4g}/s = {t_ops:.4f} ms, {nbytes:.4g} B "
         f"at {peak_bw:.4g} B/s = {t_bytes:.4f} ms; {peak_name} peaks); "
         f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {
        "name": "fused_rdb",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/fused_rdb.cu",
        "replaces": "image_super_resolution_tpu/ops/pallas/fused_rdb.py:84",
        "launches": None,  # filled in from the serving phase
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


# ------------------------------------------------------------------ phase 4 --

def phase_serve(work: Path, kind: str):
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
    scatter_rdb.launches = 0
    out = deployed(xd)  # first request
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = deployed(xd)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    launches = scatter_rdb.launches
    if launches != per_forward * (n + 1):
        raise AssertionError(f"fused_rdb launched {launches} times in {n + 1} "
                             f"forwards, want {per_forward} per forward")
    if out.dtype != torch.uint8 or tuple(out.shape) != (b, t * s, t * s, 3):
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    mpix = b * (t * s) ** 2 / (ms / 1e3) / 1e6
    _log(f"[serve] sr x4 d16 w64 bf16 b{b} t{t} on {kind}: {ms:.3f} ms/iter "
         f"(host clock over {n} requests after one), {mpix:.2f} output MPix/s; "
         f"fused_rdb launches {launches} ({per_forward} per forward); artifact "
         f"load {load_s:.2f} s; peak memory "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ref = load_artifact(isr, dtype=torch.float32, device="cpu")(x[:2]).numpy()
    diff = np.abs(out[:2].cpu().numpy().astype(int) - ref.astype(int))
    _log(f"[serve] 2 tiles, card bf16 vs CPU fp32: max {diff.max()} LSB "
         f"(bound {BF16_MAX_LSB}), {(diff > 0).mean():.4f} of values differ")
    if diff.max() > BF16_MAX_LSB:
        raise AssertionError("card bf16 output is outside the recorded bound")
    _breakdown(deployed, xd, n)
    return isr, launches


def _breakdown(deployed, x, iters: int):
    """Where one request's time goes, after the counted run: CUDA events
    around each top-level module of the generator (the rest of the request
    -- input copy, normalize, tail shuffles, uint8 -- is the request less
    their sum), then device time by kernel name under ``torch.profiler`` and
    the device's idle share over that window (1 - kernel time / wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marks = {}

    def pre(name):
        def hook(_mod, _inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(name, []).append([ev, None])
        return hook

    def post(name):
        def hook(_mod, _inp, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev
        return hook

    handles = []
    for name, child in deployed.model.named_children():
        handles.append(child.register_forward_pre_hook(pre(name)))
        handles.append(child.register_forward_hook(post(name)))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            deployed(x)
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    request_ms = start.elapsed_time(end) / iters
    stages = {name: sum(a.elapsed_time(b) for a, b in pairs) / iters
              for name, pairs in marks.items()}
    shown = {k: v for k, v in stages.items() if not k.startswith("rrdb")}
    shown["rrdb (all)"] = sum(v for k, v in stages.items() if k.startswith("rrdb"))
    shown["rest"] = request_ms - sum(stages.values())
    _log(f"[breakdown] request {request_ms:.4f} ms (CUDA events, mean of {iters})")
    for name, ms in shown.items():
        _log(f"[breakdown] stage {name:12s} {ms:9.4f} ms  {ms / request_ms:6.1%}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            deployed(x)
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
    idle = f"{1 - busy / wall:.1%}" if busy else "not measured (no device events)"
    _log(f"[breakdown] profiler: device kernel time {busy:.4f} ms of {wall:.4f} ms "
         f"wall per request; idle share {idle}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[breakdown] kernel {ms:9.4f} ms  {ms / max(busy, 1e-9):6.1%}  {name[:100]}")


# ------------------------------------------------------------------ phase 5 --

def phase_cli(work: Path, isr: Path):
    import numpy as np

    from image_super_resolution_tpu_torch.cli import rs
    from image_super_resolution_tpu_torch.infer.tiling import plan_tiles
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb
    from image_super_resolution_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(SEED + 2)
    src, dst = work / "in", work / "out"
    src.mkdir()
    sizes = {"photo": (384, 512), "odd": (77, 53)}
    for name, hw in sizes.items():
        write_png(src / f"{name}.png", rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    window, overlap, batch = 96, 8, 8  # the CLI's defaults
    want = 0
    for h, w in sizes.values():
        tiles = plan_tiles(h, w, min(window, max(h, w) + 2 * overlap), overlap)[0]
        want += 48 * -(-len(tiles) // batch)
    scatter_rdb.launches = 0
    t0 = time.perf_counter()
    rs.main(["--model", str(isr), "--src", str(src), "--save_dir", str(dst)])
    secs = time.perf_counter() - t0
    if scatter_rdb.launches != want:
        raise AssertionError(f"rs launched fused_rdb {scatter_rdb.launches} times, want {want}")
    for name, (h, w) in sizes.items():
        got = read_png(dst / f"{name}.png")
        if got.shape != (4 * h, 4 * w, 3):
            raise AssertionError(f"rs wrote {got.shape} for {name} {(h, w)}")
    _log(f"[cli] rs --device cuda on 2 PNGs {list(sizes.values())}: x4 outputs, "
         f"fused_rdb launches {want}, {secs:.2f} s wall")


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
    phase_build()
    k1 = phase_kernel(kind)
    with tempfile.TemporaryDirectory() as tmp:
        isr, k1["launches"] = phase_serve(Path(tmp), kind)
        phase_cli(Path(tmp), isr)
    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
