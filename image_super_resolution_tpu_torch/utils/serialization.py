"""flax's msgpack encoding, with ``msgpack`` alone: the ``.isr`` artifact and
the training checkpoint are both written this way by the JAX package.

A numpy array is msgpack ext type 1 and a numpy scalar ext type 3, each
with the payload ``msgpack.packb((shape, dtype_name, C-order bytes))``.
Dicts, strings and Python numbers are plain msgpack. (flax splits arrays
above 2^30 bytes into chunks; no tree here comes near that.)
"""

from __future__ import annotations

from typing import Any, Mapping

import msgpack
import numpy as np

_NDARRAY, _NPSCALAR = 1, 3


def _pack(obj):
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return msgpack.ExtType(
            _NDARRAY if isinstance(obj, np.ndarray) else _NPSCALAR,
            msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _unpack(code: int, data: bytes):
    if code in (_NDARRAY, _NPSCALAR):
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr[()] if code == _NPSCALAR else arr
    raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_serialize(tree: Mapping[str, Any]) -> bytes:
    return msgpack.packb(tree, default=_pack, strict_types=True)


def msgpack_restore(blob: bytes) -> Any:
    return msgpack.unpackb(blob, ext_hook=_unpack, raw=False)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf; dict keys come out sorted, as a JAX
    tree_map orders them."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def to_fp16(x):
    x = np.asarray(x)
    return x.astype(np.float16) if np.issubdtype(x.dtype, np.floating) else x


def to_fp32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == np.float16 else x
