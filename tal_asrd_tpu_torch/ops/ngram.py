"""N-gram repetition mask, the repetition test of the unaligned state machine.

Counterpart of tal_asrd_tpu/ops/ngram.py: the same static-shape O(L^2)
comparison, on tensors of any device. The state machine
(decode/unaligned.py) asks the same question once a token on the host and
answers it incrementally (`RepeatCounter`), one new n-gram a step; this
function is its definition and its test oracle.

Semantics: scanning j = 0..L-n-1, an n-gram starting at j is "repeated" if
an identical n-gram started at any j' < j (the n-gram starting at L-n is
recorded as seen but never flagged, and the first occurrence is never
flagged). Positions [j, j+n) of flagged n-grams get mask 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def ngram_repeat_mask(xs: torch.Tensor, n: int,
                      valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs: [B, L] int tokens -> [B, L] int32 mask with 1 on repeated n-grams.

    valid_len: optional [B] effective lengths; positions >= valid_len are
    treated as nonexistent (the history buffers are fixed-size and padded).
    """
    b, l = xs.shape
    dev = xs.device
    if l <= n:
        return torch.zeros((b, l), dtype=torch.int32, device=dev)

    n_starts = l - n + 1
    windows = xs.unfold(1, n, 1)                                          # [B, S, n]
    eq = (windows[:, :, None, :] == windows[:, None, :, :]).all(dim=-1)   # [B, S, S]
    starts = torch.arange(n_starts, device=dev)
    earlier = starts[None, :] < starts[:, None]                           # j' < j
    if valid_len is not None:
        # only n-grams wholly inside the valid region take part
        ok = (starts[None, :] + n) <= valid_len.to(dev)[:, None]          # [B, S]
        eq = eq & ok[:, :, None] & ok[:, None, :]
    repeated = (eq & earlier[None]).any(dim=-1) & (starts <= l - n - 1)[None]

    pos = torch.arange(l, device=dev)
    cover = (pos[None, :] >= starts[:, None]) & (pos[None, :] < (starts + n)[:, None])
    return (repeated[:, :, None] & cover[None]).any(dim=1).to(torch.int32)


class RepeatCounter:
    """`ngram_repeat_mask(buf[None], n, [valid]).sum()` for a buffer that
    grows one token at a time, in O(n) a token.

    `count(tokens, valid)` takes the buffer's first `valid` tokens (any
    sequence; `length` is the buffer length L, which bounds the flaggable
    starts). Calls whose buffer extends the previous call's by one token
    (same `key`, valid + 1) add one n-gram; any other call starts over."""

    def __init__(self, n: int, length: int):
        self.n, self.length = n, length
        self._key: object = None
        self._valid = 0
        self._seen: Dict[Tuple[int, ...], int] = {}
        self._covered_to = 0          # end of the last flagged span
        self._count = 0

    def count(self, tokens: Sequence[int], valid: int, key: object = None) -> int:
        if key != self._key or valid < self._valid:
            self._key, self._valid = key, 0
            self._seen, self._covered_to, self._count = {}, 0, 0
        n = self.n
        while self._valid < valid:
            self._valid += 1
            j = self._valid - n                   # the n-gram now wholly valid
            if j < 0 or self.length <= n:
                continue
            gram = tuple(tokens[j:j + n])
            if gram not in self._seen:
                self._seen[gram] = j
            elif j <= self.length - n - 1:
                # flagged starts come in increasing order: the union of their
                # spans grows at its end only
                self._count += j + n - max(j, self._covered_to)
                self._covered_to = j + n
        return self._count
