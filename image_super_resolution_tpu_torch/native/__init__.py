"""ctypes binding of the port's C++ patch loader (``native/loader.cpp``),
counterpart of the JAX package's ``native/__init__.py``.

The library is built with ``g++`` at first use into
``build/native/libisr_loader-<hash>.so`` at the root of the checkout (listed
in ``.gitignore``); the hash covers the source and the flags, so an edited
source is rebuilt. It needs libjpeg-turbo >= 1.5 and libpng with their
headers. When it cannot be built or loaded, ``available()`` is False and
``build_error()`` holds the reason (the compiler's message); the data
pipeline then uses its Python backend under ``backend="auto"`` and raises
under ``backend="native"``. Setting ``ISR_NO_NATIVE`` disables the library,
as in the JAX package. ctypes releases the GIL for every call. Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-pthread")
VERSION = 2  # isr_version() of loader.cpp

_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libisr_loader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``loader.cpp`` unless its library exists; returns its path.
    The compiler writes to a name of this process's own and the result is
    moved into place with ``os.replace``, so processes that build at once
    never load a torn library. Raises RuntimeError with the compiler's
    message when the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # no g++, or it hung
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.isr_version.argtypes = []
    lib.isr_version.restype = ctypes.c_int
    lib.isr_decode_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.isr_decode_dims.restype = ctypes.c_int
    lib.isr_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int]
    lib.isr_decode_rgb.restype = ctypes.c_int
    lib.isr_load_patches.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.isr_load_patches.restype = ctypes.c_int
    if lib.isr_version() != VERSION:
        raise RuntimeError(f"{path}: isr_version() is {lib.isr_version()}, want {VERSION}")
    return lib


@functools.lru_cache(maxsize=None)
def _load_once() -> Tuple[Optional[ctypes.CDLL], str]:
    if os.environ.get("ISR_NO_NATIVE"):
        return None, "ISR_NO_NATIVE is set"
    try:
        return _bind(build()), ""
    except (RuntimeError, OSError) as e:  # build failed, or dlopen refused it
        return None, str(e)


def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, "") or (None, why not); built and loaded once per
    process (the lock keeps two threads from building at once)."""
    with _lock:
        return _load_once()


def available() -> bool:
    """True when the C++ loader built and loaded on this host."""
    return _load()[0] is not None


def build_error() -> str:
    """Why the library is unavailable ("" when it is available)."""
    return _load()[1]


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """Decode a JPEG/PNG to an (H, W, 3) uint8 RGB array; None on failure
    or when the library is unavailable."""
    lib = _load()[0]
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    p = str(path).encode()
    if lib.isr_decode_dims(p, ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.isr_decode_rgb(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            h.value, w.value)
    return out if rc == 0 else None


def load_patches(paths: Sequence[str], patch: int, seeds: Sequence[int],
                 threads: int = 4) -> Optional[Tuple[np.ndarray, int]]:
    """Decode and crop ``paths[i]`` at the offsets ``seeds[i]`` draws, on
    ``threads`` native threads, into one (N, patch, patch, 3) uint8 array;
    returns (array, number of zero patches substituted), or None when the
    library is unavailable. Slots the library cannot decode (formats beyond
    JPEG/PNG -- bmp/webp/tiff/... -- or corrupt files) are decoded again
    in Python (cv2/PIL) and cropped with ``default_rng(seed)``, as in the
    JAX package; only files that neither decoder reads become zero patches,
    with a warning."""
    lib = _load()[0]
    if lib is None:
        return None
    n = len(paths)
    if len(seeds) != n:
        raise ValueError(f"{n} paths but {len(seeds)} seeds")
    if patch <= 0:
        raise ValueError(f"patch must be positive, got {patch}")
    out = np.empty((n, patch, patch, 3), np.uint8)
    status = np.zeros(n, np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_seeds = np.ascontiguousarray(np.asarray(seeds, np.uint64))
    not_ok = lib.isr_load_patches(
        c_paths, n, patch, c_seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(threads))
    unreadable = []
    if not_ok:
        from ..data.pipeline import _random_crop, _read_rgb  # pipeline imports this module

        for i in np.nonzero(status)[0]:
            img = _read_rgb(str(paths[i]))
            if img is None:
                unreadable.append(str(paths[i]))  # stays a zero patch
                continue
            out[i] = _random_crop(img, patch, np.random.default_rng(np.uint64(seeds[i])))
        if unreadable:
            warnings.warn(f"{len(unreadable)} image(s) unreadable by both the native and "
                          f"Python decoders; substituted zero patches (first: "
                          f"{unreadable[0]})")
    return out, len(unreadable)


_MASK = (1 << 64) - 1


def _splitmix64(state: int) -> Tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


def crop_offsets(h: int, w: int, patch: int, seed: int) -> Tuple[int, int]:
    """(top, left) of the crop that ``isr_load_patches`` cuts from an h x w
    image with ``seed``: splitmix64 draws bounded by Lemire's multiply, top
    first, each drawn only where the (reflect-padded) side exceeds the
    patch. A Python mirror of loader.cpp, for checks."""
    state, offsets = seed & _MASK, []
    for side in (max(h, patch), max(w, patch)):
        if side > patch:
            state, r = _splitmix64(state)
            offsets.append((r * (side - patch + 1)) >> 64)
        else:
            offsets.append(0)
    return offsets[0], offsets[1]
