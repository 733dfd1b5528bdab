"""Dynamic time warping.

Counterpart of tal_asrd_tpu/align/dtw.py. The accumulated cost
D[i, j] = cost[i, j] + min(min(D[i-1, j], D[i, j-1]), D[i-1, j-1]), with
row 0 the running sum of cost[0] and the out-of-range neighbours 1e30, is
computed on the cost's device as an anti-diagonal wavefront: every cell of
an anti-diagonal depends only on the two before it, so the N + M - 1
diagonals are N + M - 1 vector steps (the reference scans rows, each row a
scan over its cells). A cell is the same f32 sum of its cost and an exact
minimum in either order, so the wavefront gives the scan's values; row 0
is `torch.cumsum`, which may round otherwise than XLA's cumsum. The
optimal path is backtraced on the host (`dtw_path`), as in the reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

INF = 1e30


def dtw_cost_matrix(cost: torch.Tensor) -> torch.Tensor:
    """Accumulated DTW cost D [N, M] of a local cost matrix [N, M] (f32), on
    its device."""
    n, m = cost.shape
    dev = cost.device
    cost = cost.to(torch.float32)
    n_diag = n + m - 1
    rows = torch.arange(n, device=dev)
    # the skewed layout: s[k, i] = D[i, k - i]; cells with k - i outside
    # [0, m) hold INF (a left or diagonal neighbour left of column 0)
    cols = torch.arange(n_diag, device=dev)[:, None] - rows[None, :]
    valid = (cols >= 0) & (cols < m)
    c_skew = torch.where(valid, cost[rows[None, :], cols.clamp(0, m - 1)],
                         torch.full((), INF, dtype=torch.float32, device=dev))
    s = torch.full((n_diag, n), INF, dtype=torch.float32, device=dev)
    s[:m, 0] = torch.cumsum(cost[0], dim=0)
    inf_col = torch.full((1,), INF, dtype=torch.float32, device=dev)
    for k in range(1, n_diag):
        up = s[k - 1, :-1]                       # D[i-1, j]
        left = s[k - 1, 1:]                      # D[i, j-1]
        diag = s[k - 2, :-1] if k >= 2 else inf_col.expand(n - 1)   # D[i-1, j-1]
        cell = c_skew[k, 1:] + torch.minimum(torch.minimum(up, left), diag)
        s[k, 1:] = torch.where(valid[k, 1:], cell, s[k, 1:])
    return s[rows[:, None] + torch.arange(m, device=dev)[None, :], rows[:, None]]


def dtw_path(cost: np.ndarray, device="cuda") -> List[Tuple[int, int]]:
    """Backtrace the optimal path from a local cost matrix (D on `device`,
    the backtrace on the host)."""
    return backtrace(
        dtw_cost_matrix(torch.as_tensor(np.asarray(cost, np.float32)).to(device)).cpu().numpy())


def backtrace(d: np.ndarray) -> List[Tuple[int, int]]:
    """The optimal path over an accumulated cost D [N, M] (host numpy):
    from (N-1, M-1) back to (0, 0), diagonal before up before left."""
    i, j = d.shape[0] - 1, d.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            options = [d[i - 1, j - 1], d[i - 1, j], d[i, j - 1]]
            k = int(np.argmin(options))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    path.reverse()
    return path


def monotonic_segmentation(cost: np.ndarray, device="cuda") -> List[Tuple[int, int]]:
    """For each row i, the [start, end) column span covered by the DTW path —
    a monotonic assignment of rows (tokens) to column (frame) spans."""
    path = dtw_path(cost, device)
    n = cost.shape[0]
    spans = [[None, None] for _ in range(n)]
    for i, j in path:
        if spans[i][0] is None:
            spans[i][0] = j
        spans[i][1] = j + 1
    return [(int(a), int(b)) for a, b in spans]
