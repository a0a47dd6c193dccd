#!/usr/bin/env python3
"""A/B of design variants of the port's fused RDB kernel (K1,
csrc/fused_rdb.cu) on one NVIDIA GPU.

    python3 scripts/torch_k1_variants.py [--rounds 2] [--shape 8,270,480]
        [--variants "as built,no stores"]

Each variant is the kernel's source with a few lines replaced (VARIANTS
below); all (or those named) are compiled side by side with nvcc into
build/k1_variants/ and timed by CUDA events, in turns, whole and launch by
launch, at a batch shape: video frames (8,270,480, the default) or the
serving tiles (256,24,24). Each result line also says whether the variant's
y buffer and output are bit-equal to the committed kernel's: the diagnostic
variants (no stores, no wgmma, ...) compute the wrong result on purpose and
show where the time goes. A variant that does not build is left out with
nvcc's message. Prints the card's name and power limit first, and each
variant's ptxas report (registers, spills, wgmma serialisations, injected wgmma
fences).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_STORE = "          *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);"
_WGMMA = ("              Wgmma<N>::run(acc[m], at + ((8 * m * PW * PIX_BYTES + ks * KSTEP_BYTES) >> 4),\n"
          "                            bt + (ks * 16 * N * 2 >> 4));\n")
_TAPS = "        for (int tap = 0; tap < 9; ++tap) {"
_COMPUTE_ONLY = [
    ("        mbar_wait(full(stage), round & 1);\n"
     "        if constexpr (LAST) mbar_wait(wfull(k & 1), (k >> 1) & 1);\n", ""),
    ("    if (tid == CONSUMERS) load_patches();\n", ""),
    ("    if (tid == CONSUMERS + 32) load_all_weights();",
     "    if (!LAST && tid == CONSUMERS + 32) load_all_weights();")]
# The patch layout not chosen, (b): four planes of 8 channels of every
# patch pixel, 16 bytes a pixel, no swizzle (each plane a TMA box, 128-byte
# aligned), read by a descriptor whose LBO is the plane stride; a k16 step
# is two planes on.
_LAYOUT_B = [
    ("constexpr int PIX_BYTES = G * 2;          // A: from one patch pixel to the next\n"
     "constexpr int KSTEP_BYTES = 32;           // A: from one k16 step to the next\n",
     "constexpr int PLANE = (PPIX * 16 + 127) / 128 * 128;\n"
     "constexpr int PIX_BYTES = 16;\n"
     "constexpr int KSTEP_BYTES = 2 * PLANE;\n"),
    ("  return smem_desc(addr, 16, PW * PIX_BYTES) | (2ull << 62);\n",
     "  return smem_desc(addr, PLANE, PW * PIX_BYTES);\n"),
    ("  const cuuint32_t box[4] = {G, PW, TH + 2, 1};\n"
     "  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, 4, dims, strides, box,\n"
     "                    CU_TENSOR_MAP_SWIZZLE_64B);\n",
     "  const cuuint32_t box[4] = {8, PW, TH + 2, 1};\n"
     "  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, 4, dims, strides, box,\n"
     "                    CU_TENSOR_MAP_SWIZZLE_NONE);\n"),
    ("        tma_load_4d(ring + stage * PATCH_STRIDE, &maps.src[g.src], g.src_c0, w0 - 1, h0 - 1, b,\n"
     "                    full(stage));\n",
     "        for (int c = 0; c < G / 8; ++c)\n"
     "          tma_load_4d(ring + stage * PATCH_STRIDE + c * PLANE, &maps.src[g.src], g.src_c0 + 8 * c,\n"
     "                      w0 - 1, h0 - 1, b, full(stage));\n")]
_FENCE = "        wgmma_fence();\n        // One tap an iteration"
_COMMIT = "        wgmma_commit();\n"
_TAP_DESC = "          const uint64_t at = as + ((tap / 3 * PW + tap % 3) * PIX_BYTES >> 4);\n"

# name -> (what it tests, diagnostic (a wrong result on purpose), [(text, replacement)])
VARIANTS = {
    "as built": ("the committed kernel", False, []),
    "registers 56/152": ("the producer warpgroup keeps 56 registers a thread, the consumers "
                         "get 152", False,
                         [("PRODUCER_REGS = 24, CONSUMER_REGS = 160;",
                           "PRODUCER_REGS = 56, CONSUMER_REGS = 152;")]),
    "patch (b)": ("the patch in four 8-channel planes, no swizzle, four TMA boxes of 16 bytes "
                  "a pixel", False, _LAYOUT_B),
    "base offset": ("each tap's descriptor with the base offset (start >> 7) & 7 (reads "
                    "wrong values: the swizzle applies to the address computed)", True,
                    [(_TAP_DESC, _TAP_DESC.replace("const uint64_t at", "uint64_t at")
                      + "          at |= ((at >> 3) & 7) << 49;\n")]),
    "turns": ("the consumer warpgroups take turns on the tensor cores, a named barrier each "
              "passed on once a group's wgmmas are issued (K2's scheme)", False, [
        (_FENCE, "        if (t != (int)blockIdx.x || gi > 0 || wg > 0) bar_sync(1 + wg, 256);\n"
         + _FENCE),
        (_COMMIT, _COMMIT + "        if (t + (int)gridDim.x < p.tiles || gi + 1 < p.groups || wg + 1 < 3)\n"
                            "          bar_arrive(1 + (wg + 1) % 3, 256);\n")]),
    "stages 3": ("at most 3 ring stages (the y launches)", False,
                 [("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 3;")]),
    "stages 2": ("at most 2 ring stages", False,
                 [("constexpr int MAX_STAGES = 4;", "constexpr int MAX_STAGES = 2;")]),
    "no stores": ("the epilogue computes but does not store", True,
                  [(_STORE, "          if (v0 == 1234.5f) " + _STORE.strip())]),
    "no wgmma": ("the descriptors are computed but nothing is multiplied", True,
                 [(_WGMMA, "              if (at == bt + ks) acc[m][ks] += 1.f;\n")]),
    "loads only": ("1 tap of 9 a group: the load ring and the epilogue", True,
                   [(_TAPS, _TAPS.replace("tap < 9", "tap < 1"))]),
    "compute only": ("no loads: the consumers multiply whatever shared memory holds", True,
                     _COMPUTE_ONLY),
    "compute only without stores": ("no loads and no stores", True, _COMPUTE_ONLY + [
        (_STORE, "          if (v0 == 1234.5f) " + _STORE.strip())]),
    "loads only without stores": ("the load ring alone", True,
                              [(_TAPS, _TAPS.replace("tap < 9", "tap < 1")),
                               (_STORE, "          if (v0 == 1234.5f) " + _STORE.strip())]),
}


def sass_report(so: Path) -> str:
    """Per kernel instantiation in the library's SASS: local-memory stores
    and loads (spills), ldmatrix (LDSM) and wgmma (HGMMA) instructions, and
    whether setmaxnreg survived into the code."""
    from image_super_resolution_tpu_torch.ops.kernels._build import _nvcc

    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    parts = []
    for chunk in sass.split("Function : ")[1:]:
        m = re.search(r"rdb_dense_convILi(\d+)E", chunk.split("\n", 1)[0])
        if not m:
            continue
        where = [f"{w}@{o}" for o, w in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(\S*SETMAXREG\S*|STL\S*)", chunk)]
        parts.append(f"N={m.group(1)} SASS: {len(re.findall(r'\bSTL', chunk))} STL, "
                     f"{len(re.findall(r'\bLDL', chunk))} LDL, "
                     f"{len(re.findall(r'SETMAXREG', chunk))} SETMAXREG, "
                     f"{len(re.findall(r'LDSM', chunk))} LDSM, {len(re.findall(r'HGMMA', chunk))} HGMMA; "
                     f"at {' '.join(where[:12])}")
    return "; ".join(parts)


def build(out_dir: Path, names) -> dict:
    from image_super_resolution_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    base = (CSRC / "fused_rdb.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        src = base
        for old, new in VARIANTS[name][2]:
            if old not in src:
                raise SystemExit(f"variant {name!r}: {old!r} is not in csrc/fused_rdb.cu")
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
            print(f"[build] {name}: nvcc failed, left out:\n{log[-3000:]}", flush=True)
            continue
        report = []
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*rdb_dense_convILi(\d+)E", line)
            if m:
                report.append(f"N={m.group(1)}:")
            elif report and ("registers" in line or "spill" in line):
                report.append(line.split(":", 1)[-1].strip())
        def notes(codes, n):
            return sum(any(c in line for c in codes) and f"rdb_dense_convILi{n}E" in line
                       for line in log.splitlines())
        serial = {n: notes(("C7510", "C7513"), n) for n in (32, 64)}
        # C7519: ptxas put a wgmma fence (warpgroup.arrive) where the source has none
        arrives = {n: notes(("C7519",), n) for n in (32, 64)}
        lib = ctypes.CDLL(str(so))
        lib.isr_fused_rdb_forward.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.isr_fused_rdb_forward.restype = ctypes.c_int
        libs[name] = lib
        print(f"[build] {name}: {VARIANTS[name][0]}; {' '.join(report)}; "
              f"wgmma serialisation notes N=32 {serial[32]}, N=64 {serial[64]}; "
              f"fences injected N=32 {arrives[32]}, N=64 {arrives[64]}; "
              f"{sass_report(so)}", flush=True)
        for line in log.splitlines():
            if "warning" in line.lower() and "C7519" not in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", default="8,270,480", help="batch, height, width")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of the variants to build (default: all)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_variants: CUDA is not available", file=sys.stderr)
        return 2
    from image_super_resolution_tpu_torch.models.deploy import DeploySpec, init_fused_params
    from image_super_resolution_tpu_torch.ops.kernels import fused_rdb as k1
    from image_super_resolution_tpu_torch.ops.scatter import rdb_params_to_scatter

    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    if "as built" not in names:
        names.insert(0, "as built")
    libs = build(ROOT / "build" / "k1_variants", names)
    if "as built" not in libs:
        raise SystemExit("the committed kernel did not build")

    dev = torch.device("cuda")
    b, h, w = (int(v) for v in args.shape.split(","))
    fused = init_fused_params(DeploySpec(family="sr", depth=1, width=64, scale=4), 0)
    mats = [t.to(dev) for t in k1.scatter_params_to_matmul(
        rdb_params_to_scatter(fused["rrdb0"]["rdb0"]))]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, h, w, k1.C), np.float32)).to(dev, torch.bfloat16)
    ints = k1._plan_ints()
    plan = (ctypes.c_int * len(ints))(*ints)
    grid = k1.tile_schedule(b, h, w, torch.cuda.get_device_properties(0).multi_processor_count)[1]

    def run(name, y, out, only=-1):
        err = libs[name].isr_fused_rdb_forward(
            x.data_ptr(), *(t.data_ptr() for t in mats[:5]), mats[5].data_ptr(), y.data_ptr(),
            out.data_ptr(), b, h, w, 0.2, 0.01, plan, only, grid,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    bufs = {}
    for name in libs:
        y = torch.full((b, h, w, 4 * k1.G), float("nan"), device=dev, dtype=torch.bfloat16)
        out = torch.full_like(x, float("nan"))
        run(name, y, out)
        bufs[name] = (y, out)
    torch.cuda.synchronize()
    ref_y, ref_out = bufs["as built"]
    times = {name: [[] for _ in range(6)] for name in libs}
    for r in range(args.rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        for name in order:
            y, out = bufs[name]
            times[name][5].append(ms(lambda: run(name, y, out)))
            for i in range(5):
                times[name][i].append(ms(lambda: run(name, y, out, i)))
    print(f"shape {b}x{h}x{w}, {grid} blocks; ms, best of {args.rounds} rounds in turns", flush=True)
    for name in libs:
        y, out = bufs[name]
        same = torch.equal(y.view(torch.int16), ref_y.view(torch.int16)) and torch.equal(
            out.view(torch.int16), ref_out.view(torch.int16))
        t = [min(v) for v in times[name]]
        tag = "diagnostic" if VARIANTS[name][1] else ("bit-equal" if same else "DIFFERS")
        print(f"{name:28s} call {t[5]:.4f}  launches " + " ".join(f"{v:.4f}" for v in t[:5])
              + f"  ({tag})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
