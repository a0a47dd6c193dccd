#!/usr/bin/env python3
"""A/B of design variants of the port's int8 conv kernel (K2, csrc/matmul.cu)
on one NVIDIA GPU.

    python3 scripts/torch_k2_variants.py [--rounds 2] [--shape 256,24,24]
        [--variants "as built,no turns"]

Each variant is the kernel's source with a few lines replaced (VARIANTS
below); all (or those named) are compiled side by side with nvcc into
build/k2_variants/ and timed by CUDA events, in turns, on the five sites of
the fast int8 forward (SITES: block 0's conv0, the other conv0 sites, the
conv1 sites with their residual epilogue, the last conv1, trunk_conv) at a
batch shape, 128 -> 128 channels: the fast x4 serving tiles (b256 t24, the
default) or video frames (8,270,480); each library counts its own
rectangles. Each result
line also counts the values that differ from the plain version: the
diagnostic variants (no epilogue, no wgmma) compute the wrong result on
purpose and show where the time goes. A variant that does not build is left
out with nvcc's message. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> (what it tests, [(text in csrc/matmul.cu, replacement)])
VARIANTS = {
    "as built": ("the committed kernel", []),
    "lockstep": ("one shared full barrier for all three consumer warpgroups "
                 "instead of one per warpgroup", [
        ("constexpr int FULL_THREADS = 256;", "constexpr int FULL_THREADS = CONV_THREADS;"),
        ("for (int m = 0; m < TILES; ++m) bar_arrive(kWFull + m, FULL_THREADS);",
         "bar_arrive(kWFull, FULL_THREADS);"),
        ("for (int m = 0; m < TILES; ++m) bar_arrive(kFull + TILES * b + m, FULL_THREADS);",
         "bar_arrive(kFull + TILES * b, FULL_THREADS);"),
        ("bar_sync(kWFull + wg, FULL_THREADS);", "bar_sync(kWFull, FULL_THREADS);"),
        ("bar_sync(kFull + TILES * b + wg, FULL_THREADS);",
         "bar_sync(kFull + TILES * b, FULL_THREADS);"),
    ]),
    "weights per rectangle": ("the weights copied from L2 again for every "
                              "rectangle instead of once per block", [
        ("      if (s == 0 || p.nch > 1) {", "      if (true) {"),
        ("    if (s == 0 || p.nch > 1) bar_sync(kWFull", "    if (true) bar_sync(kWFull"),
        ("    if (p.nch > 1 && s + 1 < items) bar_arrive(kWEmpty",
         "    if (s + 1 < items) bar_arrive(kWEmpty"),
    ]),
    "rectangle 16 x 8": ("two 64-row tiles per rectangle (16 x 8 pixels, two consumer "
                         "warpgroups) instead of three", [
        ("constexpr int TILES = 3;", "constexpr int TILES = 2;")]),
    "producer unroll 2": ("two 64-byte fp32 chunks in flight per producer thread, not 4", [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")]),
    "producer unroll 5": ("five 64-byte fp32 chunks in flight per producer thread", [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 5;")]),
    "producer unroll 6": ("six 64-byte fp32 chunks in flight per producer thread", [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 6;")]),
    "no residual prefetch": ("the residual read by the epilogue without its L2 prefetch "
                             "while the wgmmas run", [
        ("          if (k * 128 < span) prefetch_l2(row + k * 128);", "          ;")]),
    "fp32 stores direct": ("the epilogue's fp32 stores straight from the accumulator layout "
                           "(8 bytes a lane), not staged", [
        ("            if constexpr ((OUT & kOutF32) != 0) *at = y[a];",
         "            if constexpr ((OUT & kOutF32) != 0)\n"
         "              if (in_image(px))\n"
         "                *reinterpret_cast<float2*>(p.out + row + (long long)px * p.Cout +\n"
         "                                           32 * g + 8 * a + nl) = y[a];"),
        ("          if constexpr ((OUT & kOutF32) != 0) {\n#pragma unroll",
         "          if constexpr (false) {\n#pragma unroll")]),
    "no turns": ("the warpgroups issue their wgmmas as their patch arrives, together", [
        ("    if (s > 0 || wg > 0) bar_sync(kTurn + wg, 256);\n", ""),
        ("    if (s + 1 < items || wg + 1 < TILES) bar_arrive(kTurn + (wg + 1) % TILES, 256);\n",
         "")]),
    "no epilogue": ("diagnostic: nothing stored", [
        ("    if (ch != p.nch - 1) continue;", "    continue;")]),
    "no wgmma": ("diagnostic: no multiply, the epilogue stores the zero sums", [
        ("        tap_wgmmas(acc, at, bt, scale_d, std::make_integer_sequence<int, KS>());",
         "")]),
}
# (name, fp32 input, outputs, residual epilogue), as models/quantized.int8_forward
# runs them
SITES = (("conv0 fp32 -> int8", True, "int8", False),
         ("conv0 int8 -> int8", False, "int8", False),
         ("conv1 int8 -> fp32 + int8, residual", False, "both", True),
         ("last conv1 int8 -> int8, residual", False, "int8", True),
         ("trunk_conv int8 -> fp32, residual", False, "fp32", True))


def build(out_dir: Path, names) -> dict:
    from image_super_resolution_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc
    from image_super_resolution_tpu_torch.ops.kernels.matmul import bind_conv

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    base = (CSRC / "matmul.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        reps = VARIANTS[name][1]
        src = base
        for old, new in reps:
            if old not in src:
                raise SystemExit(f"variant {name!r}: {old!r} is not in csrc/matmul.cu")
            src = src.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = (out_dir / f"v{i}.so", subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[build] {name}: nvcc failed, left out:\n{log[-2000:]}", flush=True)
            continue
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        lib = ctypes.CDLL(str(so))
        rh, rw, _, _ = bind_conv(lib)
        libs[name] = lib
        print(f"[build] {name}: {VARIANTS[name][0]}; rectangle {rh} x {rw}; "
              f"{'spills: ' + '; '.join(spills) if spills else 'no spills'}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", default="256,24,24", help="batch, height, width")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of the variants to build (default: all)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_variants: CUDA is not available", file=sys.stderr)
        return 2
    from image_super_resolution_tpu_torch.ops.kernels import matmul as k2

    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    libs = build(ROOT / "build" / "k2_variants", names)
    if "as built" not in libs:
        raise SystemExit("the committed kernel did not build")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, h, w = (int(v) for v in args.shape.split(","))
    c = 128
    x32 = torch.from_numpy(rng.standard_normal((b, h, w, c), dtype=np.float32) * 40).to(dev)
    res = x32 * 0.01
    x8 = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)).to(dev)
    w_q = torch.from_numpy(rng.integers(-127, 128, (9 * c, c), dtype=np.int8)).to(dev)
    w_k = k2.weights_k_major(w_q)
    deq = torch.from_numpy(rng.uniform(1e-4, 1e-3, c).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(dev)
    # one block per SM: every variant has more rectangles than SMs here
    plan = k2.conv_plan(b, h, w, c, c, torch.cuda.get_device_properties(0).multi_processor_count)
    inv_x, out_inv_x, rate = 0.25, 1.0, 0.2

    def run(name, f32_in, outs, residual, poison=False):
        x = x32 if f32_in else x8

        def alloc(dtype):
            if poison:  # no stale result
                return torch.full((b, h, w, c), 99, device=dev, dtype=dtype)
            return torch.empty((b, h, w, c), device=dev, dtype=dtype)

        out = alloc(torch.float32) if outs != "int8" else None
        out8 = alloc(torch.int8) if outs != "fp32" else None
        err = libs[name].isr_conv3x3_int8(
            x.data_ptr(), w_k.data_ptr(), deq.data_ptr(), bias.data_ptr(),
            res.data_ptr() if residual else None, None if out is None else out.data_ptr(),
            None if out8 is None else out8.data_ptr(), b, h, w, c, c, int(f32_in),
            int(not residual), k2.LEAKY_SLOPE, rate, inv_x, out_inv_x, plan["cc"],
            plan["grid_x"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return tuple(t for t in (out, out8) if t is not None)

    def cuda_ms(fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    want = {}
    for site, f32_in, outs, residual in SITES:  # conv0 sites leaky, the others not
        got = k2.conv3x3_int8_reference(
            x32 if f32_in else x8, w_q, deq, bias, not residual, inv_x if f32_in else None,
            None if outs == "fp32" else out_inv_x, res if residual else None, rate,
            outs == "both")
        want[site] = got if outs == "both" else (got,)
    for rnd in range(args.rounds):
        for name in libs:
            parts = []
            for site, f32_in, outs, residual in SITES:
                got = run(name, f32_in, outs, residual, poison=True)
                bad = sum(int((g != wt).sum()) for g, wt in zip(got, want[site]))
                ms = cuda_ms(lambda: run(name, f32_in, outs, residual))
                parts.append(f"{site} {ms:.4f} ms ({bad} values differ)")
            print(f"[round {rnd}] {name:22s} " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
