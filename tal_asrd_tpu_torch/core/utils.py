"""Seeding, parameter counting, a print silencer, a tensor-census logger
and integer helpers.

Counterpart of tal_asrd_tpu/core/utils.py. `set_seed` seeds Python's and
numpy's global generators exactly as the reference does (the data pipeline
draws from them: `SegmentDataset`'s window jitter and length without
`det_seed`) and seeds PyTorch's default generators (dropout; the
reference draws it from its seeded key), and returns a seeded CPU
`torch.Generator` where the reference returns its root PRNG key; the port
draws its initial weights from it.
`debug_log` prints what the reference's prints for the same values: a
tensor is moved to the host (as float32 for the census of a float tensor)
and described under its own dtype; a tree's leaves come in JAX's order
(dict keys sorted, None an empty subtree).
"""
from __future__ import annotations

import os
import random
import sys
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed `random`, `numpy.random` and PyTorch's default generators (the
    dropout draws: the reference draws them from its seeded key); return a
    CPU generator seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
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


class SuppressPrint:
    """Context manager that silences stdout."""

    def __enter__(self):
        self._original_stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._original_stdout
        return False


def _census(arr: np.ndarray, dtype: str) -> str:
    pieces = [f"shape={tuple(arr.shape)}", f"dtype={dtype}"]
    if arr.size and np.issubdtype(arr.dtype, np.floating):
        with np.errstate(all="ignore"):
            pieces.append(f"min={np.nanmin(arr):.4g}")
            pieces.append(f"max={np.nanmax(arr):.4g}")
            pieces.append(f"mean={np.nanmean(arr):.4g}")
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        if n_nan:
            pieces.append(f"NANS={n_nan}")
        if n_inf:
            pieces.append(f"INFS={n_inf}")
    return " ".join(pieces)


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return _census(t.float().numpy() if t.is_floating_point() else t.numpy(),
                       str(t.dtype).replace("torch.", ""))
    if isinstance(x, np.ndarray):
        return _census(x, str(x.dtype))
    return repr(x)


def _leaves(x: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, path + (i,))
    elif x is not None:
        yield path, x


def debug_log(x: Any, msg: str = "", debug: bool = True) -> None:
    """Print shape / dtype / min / max / mean and the NaN / Inf census of a
    tensor or array, or of each leaf of nested dicts / lists / tuples of
    them. No-op when debug=False so call sites can stay in place."""
    if not debug:
        return
    if isinstance(x, (dict, list, tuple)):
        print(f"[debug] {msg}:")
        for path, leaf in _leaves(x):
            print(f"  {'/'.join(str(p) for p in path)}: {_describe(leaf)}")
    else:
        print(f"[debug] {msg}: {_describe(x)}")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
