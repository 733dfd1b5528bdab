"""Tracing and step timing.

Counterpart of tal_asrd_tpu/utils/profiling.py:

  * `trace(logdir)`: a context manager around `torch.profiler` with CPU and
    (where there is a card) CUDA activities; on exit it writes a Chrome
    trace, `<logdir>/trace.json` (chrome://tracing, Perfetto, TensorBoard),
    and it yields the profiler, whose `key_averages()` sum the operations;
  * `sync(tree)`: waits for the devices of a tree's tensors (CUDA
    launches return before the card finishes; CPU tensors need no wait);
  * `StepTimer`: host-clock step timing with a rolling mean and per-second
    rates (fence each step with `sync` for the card's time).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "out/torch-trace") -> Iterator[torch.profiler.profile]:
    """Profile the block; write its Chrome trace to `<logdir>/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait until the work on every CUDA device holding a tensor of `tree`
    (a tensor, or dicts / lists / tuples of them) is done."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


class StepTimer:
    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def throughput(self, units_per_step: float) -> float:
        """units/sec given units processed per step."""
        return units_per_step / self.mean_s if self.times else float("nan")

    def audio_hours_per_hour(self, audio_seconds_per_step: float) -> float:
        return self.throughput(audio_seconds_per_step)
