"""Seeding, parameter counting and integer helpers.

Counterpart of tal_asrd_tpu/core/utils.py. `set_seed` seeds Python's and
numpy's global generators exactly as the reference does (the data pipeline
draws from them: `SegmentDataset`'s window jitter and length without
`det_seed`), and returns a seeded CPU `torch.Generator` where the reference
returns its root PRNG key; the port draws its initial weights from it.
"""
from __future__ import annotations

import random
from typing import Any

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed `random` and `numpy.random`; return a CPU generator seeded with
    `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def count_parameters(tree: Any) -> int:
    """Number of elements of a module's parameters, or of a parameter tree
    (nested dicts of arrays or tensors)."""
    if isinstance(tree, torch.nn.Module):
        return int(sum(p.numel() for p in tree.parameters()))
    if isinstance(tree, dict):
        return int(sum(count_parameters(v) for v in tree.values()))
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return int(np.size(tree))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
