"""One ``torch.profiler`` window (host and device) and what the benchmark
reads from it.

The events stay in memory: no trace file is written. From the device's
operations (kernels, copies, fills) come the seconds in which the device
was busy, the time per operation name, and the idle gaps between them.
Each gap is named by the innermost host event open at its midpoint on the
thread that issued the work ("host outside any profiled op" where none
is), so the breakdown says what the host was doing while the device
waited.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

DEVICE_WORK = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
ANNOTATION = "gpu_user_annotation"
OUTSIDE = "host outside any profiled op"
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # host op -> seconds

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k[:NAME_CHARS], v] for k, v in Counter(d).most_common(top)]
        return {"device_ops": head(self.device_ops), "idle_gaps": head(self.idle_by_host)}


class Profiled:
    """``with Profiled(device) as p: ...`` profiles the block; ``p.trace``
    holds the reduction afterwards. The device is synchronized at both ends,
    so the window holds all the work launched inside it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Trace | None = None

    def __enter__(self) -> "Profiled":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self._prof.profiler.kineto_results.events(), window_s)
        return False


def _span(e) -> Tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


def merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) spans, as sorted disjoint spans."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def innermost(events: List[Tuple[int, int, str]], points: List[int]) -> List[str]:
    """For each sorted point, the name of the latest-starting event of one
    thread's properly nested ``events`` (start, end, name) that holds it."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))  # parents first
    names, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else OUTSIDE)
    return names


def kind(e) -> str:
    """The event's kineto activity type. Where the event does not say it
    (older PyTorch), a device event is taken as work ("kernel") and a host
    event as an op; device-side copies of host annotations are dropped by
    name in ``reduce``."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    note = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return ANNOTATION if note else "kernel"
    return "user_annotation" if note else "cpu_op"


def reduce(events, window_s: float) -> Trace:
    device, host = [], defaultdict(list)
    for e in events:
        k = kind(e)
        if k in DEVICE_WORK:
            device.append((*_span(e), e.name()))
        elif k in HOST:
            host[e.start_thread_id()].append((*_span(e), e.name()))
    # an annotation's device-side range bears its host name: not device work
    host_names = {name for spans in host.values() for *_, name in spans}
    device = [d for d in device if d[2] not in host_names]
    ops: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        ops[name] += (e - s) / 1e9
    busy = merge([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    if busy and host:
        issuing = max(host.values(), key=len)  # the thread that launched the work
        lo = min(s for s, _, _ in issuing)
        hi = max(e for _, e, _ in issuing)
        edges = [lo] + [t for span in busy for t in span] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        mids = [(a + b) // 2 for a, b in gaps]
        for (a, b), name in zip(gaps, innermost(issuing, mids)):
            idle[name] += (b - a) / 1e9
    return Trace(window_s=window_s, busy_s=busy_s, device_ops=dict(ops),
                 idle_by_host=dict(idle))

