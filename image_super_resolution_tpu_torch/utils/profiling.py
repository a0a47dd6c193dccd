"""Profiling (counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of everything inside it
  (host ops, and the card's kernels and copies when CUDA is there),
  written into ``logdir`` as a TensorBoard-loadable ``*.pt.trace.json``.
- ``annotate(name)``: a named span of the port's serving path (the tiler's
  stages, a model's upload and forward, the video pipeline's stages). Its
  calls and host nanoseconds always add up in ``annotate.totals``; under
  any profiler it is also an event of that trace.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from time import perf_counter_ns
from typing import Dict, Iterator, List

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[None]:
    """Profile the block into ``logdir`` (view with TensorBoard's profiler
    plugin or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


_totals: Dict[str, List[int]] = {}  # annotate.totals: name -> [calls, host ns]
_spans: Dict[str, "_Span"] = {}


class _Span:
    """The span of one name: its totals, and what each open span of that
    name needs at its end (spans of one name may nest)."""

    __slots__ = ("name", "total", "_open")

    def __init__(self, name: str):
        self.name = name
        self.total = _totals.setdefault(name, [0, 0])
        self._open: list = []  # per open span: its profiler event (or None), its start ns

    def __enter__(self) -> "_Span":
        self._open.append(torch.profiler.record_function(self.name).__enter__()
                          if _autograd_profiler._is_profiler_enabled else None)
        self._open.append(perf_counter_ns())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        ns = perf_counter_ns() - self._open.pop()
        event = self._open.pop()
        if event is not None:
            event.__exit__(exc_type, exc, tb)
        total = self.total
        total[0] += 1
        total[1] += ns
        return False


def annotate(name: str) -> _Span:
    """``with annotate(name): ...`` adds one call and the block's host
    nanoseconds (``time.perf_counter_ns``) to ``annotate.totals[name]``,
    ``[calls, ns]``. The totals only grow: a reader takes the difference of
    two copies. With no profiler active that is all it does; under one
    (``trace``, the benchmark's traced window) the block is also a
    ``record_function`` event, on the same clock as the kernels and copies
    it launches.

    Spans nest, and are entered only on the thread that drives the device
    (the video pipeline's decoder thread enters none): a name's span
    object is shared, and neither it nor the totals are locked."""
    span = _spans.get(name)
    if span is None:
        span = _spans[name] = _Span(name)
    return span


annotate.totals = _totals
