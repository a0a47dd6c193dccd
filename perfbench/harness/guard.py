"""The JAX package is the port's reference in the CPU tests and is never
measured: a run that finds it, or JAX itself, loaded fails. Names are
compared by their whole top-level part, since the port's package name
begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "image_super_resolution_tpu"})


def forbidden_loaded(modules: Iterable[str] = ()) -> List[str]:
    names = modules or list(sys.modules)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
