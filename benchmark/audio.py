"""Speech-like test audio made on the device from a generator: noise plus a
few amplitude-modulated tones a row, each row at its own level (so the
frontend's batch mean depends on every row of a batch)."""
from __future__ import annotations

import math

import torch


def speechlike(gen: torch.Generator, rows: int, n: int, a: dict, device) -> torch.Tensor:
    """[rows, n] float32 in [-1, 1]; `a` holds the mix's `audio` parameters."""
    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)
    t = torch.arange(n, device=device, dtype=torch.float32) / 16000.0
    x = torch.randn((rows, n), generator=gen, device=device) * a["noise"]
    f0 = uniform(a["f_lo"], a["f_hi"], rows, a["tones"], 1)
    am = uniform(a["am_lo"], a["am_hi"], rows, a["tones"], 1)
    for j in range(a["tones"]):
        x += a["tone_amp"] * 0.5 * (1.0 + torch.sin(2 * math.pi * am[:, j] * t)) \
            * torch.sin(2 * math.pi * f0[:, j] * t)
    gain = 10.0 ** (uniform(a["gain_db_lo"], a["gain_db_hi"], rows, 1) / 20.0)
    return (x * gain).clamp_(-1.0, 1.0)
