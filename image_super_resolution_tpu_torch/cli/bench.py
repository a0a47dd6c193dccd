"""Headline benchmark: SR inference throughput on one device (counterpart of
the JAX package's root ``bench.py``, the same flags plus ``--device``):

    python -m image_super_resolution_tpu_torch.cli.bench            # fast, then sr
    python -m image_super_resolution_tpu_torch.cli.bench --int8
    python -m image_super_resolution_tpu_torch.cli.bench --family sr
    python -m image_super_resolution_tpu_torch.cli.bench --preset denoise_fullres
    python -m image_super_resolution_tpu_torch.cli.bench --device cpu \
        --family fast --depth 1 --batch 2 --tile 8

Prints ONE JSON line on stdout,
``{"metric": "...", "value": N, "unit": "MPix/s", "vs_baseline": null}``:
output megapixels per second of the deployment path uint8 -> normalize ->
generator -> uint8 (``models/deploy.DeployedModel``; ``--int8``:
``models/quantized.quantize_deployed``, calibrated on the first batch of the
bench inputs, as the JAX bench does). With no ``--family`` the line is the
``fast`` flagship's (x4, depth 14, width 128) and the reference topology
(``sr`` x4, depth 16, width 64) follows on stderr as a diagnostic line.
``vs_baseline`` is always null: the repo's only baseline (``BASELINE.json``)
was set for another device. The metric names keep JAX's (``..._per_chip``).

Method, as JAX's: k DISTINCT device-resident input batches per call, each
forward's output folded into a device-side int32 checksum that is fetched
once at the end of the call; chains of ``k_short`` and ``k_long`` forwards,
each the best of 3 calls after a warm one, differenced to cancel the
per-call cost. stderr also carries the mean per-forward time by CUDA events
over the ``k_long`` chain, the card's ``nvidia-smi`` name and power limit,
and the fused kernels' launches per forward (K1 ``scatter_rdb``, K2
``conv3x3_int8``).

Inputs are uint8 from a seeded ``torch.Generator`` and the weights come
from ``init_fused_params`` (a numpy seed, torch's default conv init): the
JAX bench's ``PRNGKey`` streams and flax init cannot be matched, and the
throughput does not depend on the values.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..core.device import resolve_device
from ..models.deploy import DeployedModel, DeploySpec, family_defaults, init_fused_params
from ..ops.kernels.fused_rdb import scatter_rdb
from ..ops.kernels.matmul import conv3x3_int8


@torch.inference_mode()
def _timed_chain(deployed, xs, k: int) -> float:
    """Seconds for one call of k chained forwards over k distinct inputs and
    the fetch of their int32 checksum: the best of 3 after a warm call."""
    def chain() -> int:
        total = torch.zeros((), dtype=torch.int32, device=xs.device)
        for x in xs[:k]:
            total += deployed(x)[..., 0].sum(dtype=torch.int32)
        return int(total)  # the fetch waits for every forward

    chain()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chain()
        best = min(best, time.perf_counter() - t0)
    return best


@torch.inference_mode()
def _event_ms(deployed, xs) -> float:
    """Mean device ms per forward over the chain, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for x in xs:
        deployed(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(xs)


@torch.inference_mode()
def launches_per_forward(deployed, x) -> dict:
    """K1 and K2 launches of one forward (both 0 off the card), as
    differences of the counts, which run on."""
    before = scatter_rdb.launches, conv3x3_int8.launches
    deployed(x)
    return {"scatter_rdb": scatter_rdb.launches - before[0],
            "conv3x3_int8": conv3x3_int8.launches - before[1]}


def card_line(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the CPU's name."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def bench(
    family: str = "sr",
    depth: int = 16,
    width: int = 64,
    scale: int = 4,
    batch: int = 256,
    tile: int = 24,
    k_short: int = 1,
    k_long: int = 6,
    int8: bool = False,
    refine_blocks: int = 0,
    refine_width: int = 64,
    downshuffle: int | None = None,
    device: str = "cuda",
) -> dict:
    dev = resolve_device(device)
    denoise = family.startswith("denoise")
    if downshuffle is None:
        downshuffle = 2 if family == "denoise_fast" else 1
    spec = DeploySpec(
        family=family, depth=depth, width=width,
        scale=1 if denoise else scale,
        downshuffle=downshuffle,
        refine_blocks=refine_blocks, refine_width=refine_width,
    )
    scale = spec.output_scale
    deployed = DeployedModel(spec, init_fused_params(spec, seed=0), device=dev)
    gen = torch.Generator().manual_seed(1)
    xs = torch.randint(0, 256, (k_long, batch, tile, tile, 3), dtype=torch.uint8,
                       generator=gen).to(dev)
    if int8:
        # PTQ trunk calibrated on the bench inputs, as rs --int8 calibrates
        # on the images it serves
        from ..models.quantized import quantize_deployed

        deployed = quantize_deployed(deployed, [xs[0]])
    print(
        f"bench config: {family} depth={depth} width={width} x{scale}, "
        f"batch={batch}, tile={tile}, int8={int8}, "
        f"refine={refine_blocks}x{refine_width if refine_blocks else 0}, "
        f"device={dev} ({card_line(dev)})",
        file=sys.stderr,
    )
    t_short = _timed_chain(deployed, xs, k_short)
    t_long = _timed_chain(deployed, xs, k_long)
    per_iter = (t_long - t_short) / (k_long - k_short)
    out_mpix = batch * (tile * scale) ** 2 / 1e6
    mpix_per_s = out_mpix / per_iter
    events = (f"{_event_ms(deployed, xs):.3f} ms by CUDA events"
              if dev.type == "cuda" else "no CUDA events on the CPU")
    print(
        f"per-iter {per_iter * 1e3:.2f} ms ({out_mpix:.2f} MPix/iter); "
        f"t_short={t_short * 1e3:.1f} ms t_long={t_long * 1e3:.1f} ms; "
        f"per forward {events}; launches per forward "
        f"{json.dumps(launches_per_forward(deployed, xs[0]))}",
        file=sys.stderr,
    )
    kind = "denoise" if denoise else "sr"
    return {
        "metric": f"x{scale}_{kind}_output_megapixels_per_sec_per_chip"
                  + ("_int8" if int8 else ""),
        "value": round(mpix_per_s, 2),
        "unit": "MPix/s",
        "vs_baseline": None,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--family", default=None,
                        choices=["sr", "fast", "denoise", "denoise_fast"],
                        help="default: fast flagship, then the reference "
                             "topology as a diagnostic second line on stderr; "
                             "denoise families measure x1 restoration "
                             "throughput")
    parser.add_argument("--scale", type=int, default=4,
                        help="SR output scale (2 or 4)")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--tile", type=int, default=None,
                        help="input tile size (default 24 for the SR "
                             "families, 96 for x1 denoise: equal output "
                             "MPix per iteration either way)")
    parser.add_argument("--int8", action="store_true",
                        help="bench the fast family's int8 PTQ trunk "
                             "(models/quantized.py); errors on the other "
                             "families")
    parser.add_argument("--refine_blocks", type=int, default=0,
                        help="fast families: bench with the full-res "
                             "refinement tail (models/fast.py)")
    parser.add_argument("--refine_width", type=int, default=64)
    parser.add_argument("--depth", type=int, default=None,
                        help="override the family's preset trunk depth "
                             "(e.g. the full-resolution denoise_fast W "
                             "configuration: --depth 6 --downshuffle 1)")
    parser.add_argument("--downshuffle", type=int, default=None,
                        help="denoise_fast: trunk resolution factor "
                             "(default 2; 1 = full-resolution trunk)")
    parser.add_argument("--preset", type=str, default=None,
                        choices=["denoise_fullres"],
                        help="named configuration shortcut: denoise_fullres "
                             "= the x1 fidelity preset (denoise_fast, "
                             "depth 6, full-resolution trunk). Explicit "
                             "flags override")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default), cuda:N, or cpu")
    return parser


def main(argv=None) -> dict:
    """Returns the JSON line's dict (the one printed on stdout)."""
    parser = build_parser()
    opt = parser.parse_args(argv)

    if opt.preset == "denoise_fullres":
        if opt.family is None:
            opt.family = "denoise_fast"
        if opt.depth is None:
            opt.depth = 6
        if opt.downshuffle is None:
            opt.downshuffle = 1

    if opt.downshuffle is not None and opt.family != "denoise_fast":
        parser.error("--downshuffle applies to --family denoise_fast only")
    if opt.depth is not None and opt.family is None:
        parser.error("--depth requires an explicit --family")

    common = dict(scale=opt.scale, batch=opt.batch, device=opt.device)
    if opt.family is not None:
        depth, width = family_defaults(opt.family)
        if opt.depth is not None:
            depth = opt.depth
        tile = opt.tile if opt.tile is not None else (
            96 if opt.family.startswith("denoise") else 24)
        result = bench(family=opt.family, depth=depth, width=width, tile=tile,
                       int8=opt.int8, refine_blocks=opt.refine_blocks,
                       refine_width=opt.refine_width, downshuffle=opt.downshuffle,
                       **common)
    else:
        # the flagship's line, then the reference topology's on stderr
        tile = opt.tile if opt.tile is not None else 24
        depth, width = family_defaults("fast")
        result = bench(family="fast", depth=depth, width=width, tile=tile,
                       int8=opt.int8, refine_blocks=opt.refine_blocks,
                       refine_width=opt.refine_width, **common)
        depth, width = family_defaults("sr")
        ref = bench(family="sr", depth=depth, width=width, tile=tile, **common)
        print(f"reference-topology diagnostic: {json.dumps(ref)}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
