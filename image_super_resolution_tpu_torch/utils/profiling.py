"""Profiling (counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of everything inside it
  (host ops, and the card's kernels and copies when CUDA is there),
  written into ``logdir`` as a TensorBoard-loadable ``*.pt.trace.json``.
- ``annotate(name)``: a named region in that trace (the video
  pipeline's stages).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[None]:
    """Profile the block into ``logdir`` (view with TensorBoard's profiler
    plugin or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def annotate(name: str):
    """Label a region in the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)
