"""The reduction from a `torch.profiler` trace to the numbers the per-layer
readers take: device busy time (the sum of kernel and copy durations; the
work of one stream does not overlap), each named host range's device time
and kernel count (kernels launched inside it, through their runtime calls),
the kernels by name and the device's idle gaps by what the host was doing.
The arithmetic follows `chip_smoke.py`'s `profile_call`."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

RANGE_PREFIXES = ("bench.", "Optimizer.step#")


@dataclass
class Profile:
    wall_s: float = 0.0
    busy_s: float = 0.0
    calls: int = 0                       # calls (or steps) the traced stretch made
    kernels: List[Tuple[str, float]] = field(default_factory=list)   # (name, seconds)
    ranges: Dict[str, List[Tuple[float, int]]] = field(default_factory=dict)  # (device s, kernels)
    gaps: List[Tuple[str, float]] = field(default_factory=list)       # (host op, seconds)

    def top_kernels(self, n: int = 10) -> List[List]:
        total = defaultdict(float)
        for name, s in self.kernels:
            total[name[:120]] += s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        total = defaultdict(float)
        for name, s in self.gaps:
            total[name[:120]] += s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _under(event) -> Tuple[float, int]:
    """Device seconds and kernel count of the kernels launched inside a host
    event and its children."""
    seconds = sum(k.duration for k in event.kernels) / 1e6
    count = len(event.kernels)
    for child in event.cpu_children:
        s, c = _under(child)
        seconds += s
        count += c
    return seconds, count


def run_profiled(fn: Callable[[], int], device: torch.device) -> Profile:
    """Trace `fn()` (which returns the calls it made) and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        calls = fn()
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out = Profile(wall_s=wall, calls=calls)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    out.kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e6) for e in dev]
    out.busy_s = sum(s for _, s in out.kernels)
    host = [e for e in events if e.device_type != cuda and not e.is_async]
    for e in host:
        if e.name.startswith(RANGE_PREFIXES):
            out.ranges.setdefault(e.name, []).append(_under(e))
    out.gaps = _gaps(dev, host)
    return out


def _gaps(dev, host) -> List[Tuple[str, float]]:
    """Each idle stretch between the device's operations, named by the
    innermost host event running at its middle on the busiest host thread."""
    mids, last_end = [], None
    for e in dev:
        if last_end is not None and e.time_range.start > last_end:
            mids.append(((last_end + e.time_range.start) / 2,
                         (e.time_range.start - last_end) / 1e6))
        last_end = e.time_range.end if last_end is None else max(last_end, e.time_range.end)
    if not mids or not host:
        return [(" (no host event)", g) for _, g in mids]
    threads = defaultdict(int)
    for e in host:
        threads[e.thread] += 1
    main = max(threads, key=threads.get)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                   if e.thread == main)
    starts = [s[0] for s in spans]
    out = []
    for mid, gap in mids:
        # events of one thread nest: the latest-starting one that still runs
        # at `mid` is the innermost
        i = bisect.bisect_right(starts, mid)
        name = "(host between events)"
        for j in range(i - 1, max(i - 5000, -1), -1):
            if spans[j][1] >= mid:
                name = spans[j][2]
                break
        out.append((name, gap))
    return out
