"""Tokenizer abstraction with speaker-token handling.

Counterpart of tal_asrd_tpu/text/tokenizer.py:

  * special ids: bos=0, eos=1, pad=2, unk=3 — and the reference's quirk that
    id 0 (the BOS slot) doubles as the EOT "end of transcript" token;
  * ids >= len(tokenizer) are speaker tokens: speaker s <-> id vocab+s,
    rendered '<S{s}>';
  * decode_speakers splits a decoded stream into [(utterance_text, speaker)]
    at EOS boundaries and returns the split indices: BOS ids are skipped, a
    speaker token sets the *pending* speaker of the utterance closed by the
    next EOS, empty buffers produce no utterance, and the trailing
    unterminated buffer is appended when add_last.

Backends implement _encode / decode_pieces; the BPE backend is text/bpe.py.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Tuple

import numpy as np


class Tokenizer(ABC):
    """Base tokenizer: integer special ids + speaker-token conventions."""

    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 2
    unk_token_id: int = 3
    eot_token_id: int = 0  # reference quirk: EOT shares the BOS slot

    @abstractmethod
    def __len__(self) -> int:
        """Text vocabulary size (speaker ids start here)."""

    @abstractmethod
    def _encode(self, sentence: str) -> List[int]:
        ...

    @abstractmethod
    def decode_pieces(self, ids: Sequence[int]) -> str:
        """Decode a run of in-vocab text ids to a string."""

    def encode(self, sentence: str, bos_token: bool = True, eos_token: bool = True) -> List[int]:
        ids = self._encode(sentence)
        if bos_token:
            ids = [self.bos_token_id] + ids
        if eos_token:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, tokens) -> str:
        """Decode ids; EOT renders '<EOT>', speaker ids render '<S{n}>'."""
        if isinstance(tokens, np.ndarray):
            tokens = tokens.tolist()
        out = []
        buf: List[int] = []
        n = len(self)
        for x in tokens:
            x = int(x)
            if x == self.eot_token_id or x >= n:
                if buf:
                    out.append(self.decode_pieces(buf))
                    buf = []
                out.append("<EOT>" if x == self.eot_token_id else f"<S{x - n}>")
            else:
                buf.append(x)
        if buf:
            out.append(self.decode_pieces(buf))
        return "".join(out)

    def speaker_token_id(self, speaker: int) -> int:
        return len(self) + speaker

    def decode_speakers(self, tokens: Sequence[int], add_last: bool = True
                        ) -> Tuple[List[Tuple[str, Optional[int]]], List[int]]:
        """Split a decoded stream into utterances with speakers.

        Returns ([(utterance_text, speaker_or_None), ...], split_indices)
        where split_indices[i] is the token index at which utterance i closed.
        """
        n = len(self)
        utterances: List[Tuple[str, Optional[int]]] = []
        split_indices: List[int] = []
        buf: List[int] = []
        cur_speaker = None
        i = -1
        for i, x in enumerate(int(t) for t in tokens):
            if x == self.bos_token_id:
                continue
            if x >= n:
                cur_speaker = x - n
            elif x == self.eos_token_id:
                if buf:
                    utterances.append((self.decode(buf), cur_speaker))
                    cur_speaker = None
                    buf = []
                    split_indices.append(i)
            else:
                buf.append(x)
        if buf and add_last:
            utterances.append((self.decode(buf), cur_speaker))
            split_indices.append(i)
        return utterances, split_indices
