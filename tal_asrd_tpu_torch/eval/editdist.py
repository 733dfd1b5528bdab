"""Edit distance + alignment opcodes: ctypes binding to native/editdist.cpp
with an equivalent pure-Python path.

Counterpart of tal_asrd_tpu/eval/editdist.py: `eval_distance` is the WER
Levenshtein; `opcodes` returns [('equal'|'replace'|'delete'|'insert', a0,
a1, b0, b1), ...], the alignment stream calculate_wder consumes. The library
is built at first use (utils/native.py); TAL_ASRD_NO_NATIVE=1 forces the
Python path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.utils.native import load_host_library

_OP_NAMES = ["equal", "replace", "delete", "insert"]


def _editdist():
    """native/editdist.cpp with its signatures declared, or None."""
    lib = load_host_library("editdist")
    if lib is None:
        return None
    lib.levenshtein.restype = ctypes.c_int64
    lib.levenshtein.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.edit_opcodes.restype = ctypes.c_int64
    lib.edit_opcodes.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    return lib


def intern_symbols(*seqs: Sequence[Hashable]) -> List[np.ndarray]:
    """Map arbitrary hashable symbols (words) to int32 ids, shared table."""
    table: Dict[Hashable, int] = {}
    out = []
    for seq in seqs:
        ids = np.empty(len(seq), np.int32)
        for i, s in enumerate(seq):
            ids[i] = table.setdefault(s, len(table))
        out.append(ids)
    return out


# ---------------------------------------------------------------------------
# Pure-Python path (diag > insert > delete tie-breaking, as the native one)
# ---------------------------------------------------------------------------

def _py_distance(a: np.ndarray, b: np.ndarray) -> int:
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    row = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        prev = row.copy()
        row[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        for j in range(1, m + 1):
            row[j] = min(sub[j - 1], prev[j] + 1, row[j - 1] + 1)
    return int(row[m])


def _py_opcodes(a: np.ndarray, b: np.ndarray):
    n, m = len(a), len(b)
    cost = np.zeros((n + 1, m + 1), np.int64)
    cost[0, :] = np.arange(m + 1)
    cost[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        sub_row = cost[i - 1, :-1] + (a[i - 1] != b)
        for j in range(1, m + 1):
            cost[i, j] = min(sub_row[j - 1], cost[i - 1, j] + 1, cost[i, j - 1] + 1)
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            ops.append("M" if a[i - 1] == b[j - 1] else "S")
            i, j = i - 1, j - 1
        elif j > 0 and cost[i, j] == cost[i, j - 1] + 1:
            ops.append("I")
            j -= 1
        else:
            ops.append("D")
            i -= 1
    ops.reverse()
    # compress runs
    out = []
    i = j = 0
    k = 0
    while k < len(ops):
        op = ops[k]
        i0, j0 = i, j
        while k < len(ops) and ops[k] == op:
            if op in "MS":
                i += 1
                j += 1
            elif op == "D":
                i += 1
            else:
                j += 1
            k += 1
        name = {"M": "equal", "S": "replace", "D": "delete", "I": "insert"}[op]
        out.append((name, i0, i, j0, j))
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def eval_distance(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Levenshtein distance over symbol sequences (editdistance.eval analog)."""
    ia, ib = intern_symbols(a, b)
    lib = _editdist()
    if lib is None:
        return _py_distance(ia, ib)
    pa = ia.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    pb = ib.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return int(lib.levenshtein(pa, len(ia), pb, len(ib)))


def opcodes(a: Sequence[Hashable], b: Sequence[Hashable]
            ) -> List[Tuple[str, int, int, int, int]]:
    """Alignment opcodes (SequenceMatcher.get_opcodes analog)."""
    ia, ib = intern_symbols(a, b)
    lib = _editdist()
    if lib is None:
        return _py_opcodes(ia, ib)
    cap = len(ia) + len(ib) + 1
    out = np.zeros((cap, 5), np.int32)
    rows = lib.edit_opcodes(
        ia.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ia),
        ib.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ib),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
    )
    assert rows >= 0, "opcode buffer overflow"
    return [
        (_OP_NAMES[int(r[0])], int(r[1]), int(r[2]), int(r[3]), int(r[4]))
        for r in out[:rows]
    ]
