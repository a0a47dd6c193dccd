"""Build the port's CUDA sources at first use, load them with ctypes, and
bind each kernel to PyTorch as an op ``isr::<name>``: the one place that
knows how a hand-written kernel is bound.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/kernels/lib<name>-<hash>.so`` at
the root of the checkout (listed in ``.gitignore``). The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt. Every library exports ``isr_error_string``
and takes the CUDA stream as the last argument of each launch.

A wrapper (``fused_rdb``, ``matmul``, ``channel_attention``, ``flow_warp``)
registers its op with ``register``: the CPU implementation is the plain
version, the CUDA one the counted launch (``launch``), the fake one the output's shape
and dtype, so ``torch.export`` records one node a call and a loaded
program launches the kernel. The ops are defined on a plain
``torch.library.Library``, whose first call imports nothing more: the
decorator API of ``torch.library`` runs its kernel inside
``torch._disable_dynamo``, whose first call imports ``torch._dynamo``,
seconds of a process's set-up.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> dict:
    """Compile each ``csrc/<name>.cu`` whose library does not exist yet, one
    ``nvcc`` per source, all started together. Returns {name: nvcc's output
    (ptxas register and shared-memory report), or "" if nothing was built};
    raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build cannot tear it
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    lib.isr_error_string.argtypes = [ctypes.c_int]
    lib.isr_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = torch.library.Library("isr", "DEF")


def register(name: str, schema: str, cpu, cuda, fake):
    """Define the op ``isr::<name>`` by its ``schema`` (arguments and
    returns, in ``torch.library``'s syntax) with its CPU, CUDA and fake
    implementations; returns the op."""
    LIBRARY.define(name + schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"isr::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.isr, name).default


def check_device(t: torch.Tensor) -> None:
    """A wrapper's first check: the ops serve the CPU and CUDA devices. A
    fake implementation also serves the Meta key, so the dispatcher alone
    would not refuse a meta tensor."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def check_operands(*tensors, align: int = 16) -> None:
    """A launch's operands (None skipped): on one device, each contiguous
    and ``align``-byte aligned."""
    tensors = [t for t in tensors if t is not None]
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"operands must be contiguous and {align}-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """``lib.<name>(*args, stream)`` with ``device`` current and its current
    stream; a nonzero return is a CUDA error, raised with the library's own
    string for it. The device is exchanged and the stream read by the calls
    that ``torch.cuda.device`` and ``torch.cuda.current_stream`` make: those
    two wrappers cost about 10 us of host time a launch on the H100's host,
    a quarter of a K2 call."""
    prev = torch.cuda._exchange_device(device.index)
    try:
        err = getattr(lib, name)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    finally:
        torch.cuda._maybe_exchange_device(prev)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({lib.isr_error_string(err).decode()})")
