"""Native BPE tokenizer (SentencePiece-compatible behaviour, no
sentencepiece dependency).

Counterpart of tal_asrd_tpu/text/bpe.py:

  * SentencePiece-style pretokenization: whitespace runs collapse, each word
    gets the U+2581 LOWER-ONE-EIGHTH-BLOCK boundary marker;
  * greedy rank-based BPE merging;
  * the JSON model format `tal_asrd_tpu.bpe.v1` (pieces + merges), trainable
    from a text corpus with BpeTrainer;
  * id layout: 0=<s> (BOS, doubling as EOT), 1=</s> (EOS), 2=<pad>,
    3=<unk>, then the learned pieces.

The merge loop and the trainer run in native/fastbpe.cpp and
native/bpetrain.cpp when those build (utils/native.py); their Python loops
give the same ids and merges.
"""
from __future__ import annotations

import ctypes
import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.text.tokenizer import Tokenizer
from tal_asrd_tpu_torch.utils.native import load_host_library

WORD_BOUNDARY = "▁"  # same marker sentencepiece uses
SPECIALS = ["<s>", "</s>", "<pad>", "<unk>"]


def _fastbpe():
    """native/fastbpe.cpp with its signatures declared, or None."""
    lib = load_host_library("fastbpe")
    if lib is None:
        return None
    lib.load_merges.restype = ctypes.c_void_p
    lib.load_merges.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.encode_word.restype = ctypes.c_int64
    lib.encode_word.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.free_merges.restype = None
    lib.free_merges.argtypes = [ctypes.c_void_p]
    return lib


def _bpetrain():
    """native/bpetrain.cpp with its signature declared, or None."""
    lib = load_host_library("bpetrain")
    if lib is None:
        return None
    lib.bpe_train.restype = ctypes.c_int
    lib.bpe_train.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _pretokenize(text: str) -> List[str]:
    """Whitespace-split; each word carries the boundary marker prefix."""
    return [WORD_BOUNDARY + w for w in text.split()]


class BpeModel:
    """Immutable trained model: pieces + merge ranks."""

    def __init__(self, pieces: List[str], merges: List[Tuple[str, str]]):
        self.pieces = list(pieces)
        self.merges = [tuple(m) for m in merges]
        self.piece_to_id: Dict[str, int] = {
            p: i for i, p in enumerate(SPECIALS + self.pieces)
        }
        self.rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(self.merges)
        }
        self._native_handle = None  # lazy C++ merge table (not pickled)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_native_handle"] = None
        return state

    def _native(self):
        """C++ merge engine handle, built lazily; None when unavailable."""
        if self._native_handle is not None:
            return self._native_handle
        lib = _fastbpe()
        if lib is None:
            return None
        n = len(self.merges)
        pairs = np.empty((n, 2), np.int32)
        merged = np.empty((n,), np.int32)
        for i, (a, b) in enumerate(self.merges):
            pairs[i, 0] = self.piece_to_id[a]
            pairs[i, 1] = self.piece_to_id[b]
            merged[i] = self.piece_to_id[a + b]
        handle = lib.load_merges(
            pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            merged.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
        )
        self._native_handle = (lib, handle)
        return self._native_handle

    def encode_word_ids(self, word: str, unk_id: int) -> List[int]:
        """Word -> final token ids, via the C++ engine when every character
        is in-vocabulary (the Python path otherwise)."""
        native = self._native()
        char_ids = [self.piece_to_id.get(ch) for ch in word]
        if native is None or any(c is None for c in char_ids):
            out: List[int] = []
            for piece in self.encode_word(word):
                pid = self.piece_to_id.get(piece)
                if pid is None:
                    out.extend(self.piece_to_id.get(ch, unk_id) for ch in piece)
                else:
                    out.append(pid)
            return out
        lib, handle = native
        syms = np.asarray(char_ids, np.int32)
        buf = np.empty(max(len(syms), 1), np.int32)
        n = lib.encode_word(
            handle,
            syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(syms),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(buf),
        )
        assert n >= 0
        return buf[:n].tolist()

    def __len__(self) -> int:
        return len(SPECIALS) + len(self.pieces)

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"format": "tal_asrd_tpu.bpe.v1", "pieces": self.pieces,
                 "merges": [list(m) for m in self.merges]},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BpeModel":
        with open(path) as f:
            d = json.load(f)
        assert d.get("format") == "tal_asrd_tpu.bpe.v1", d.get("format")
        return cls(d["pieces"], [tuple(m) for m in d["merges"]])

    # -- encoding -------------------------------------------------------
    def encode_word(self, word: str) -> List[str]:
        """Greedy lowest-rank pair merging of one marked word."""
        symbols = list(word)
        if not symbols:
            return []
        while len(symbols) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                r = self.rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols


class BpeTokenizer(Tokenizer):
    """Tokenizer over a trained BpeModel (the reference's Tokenizer analog)."""

    def __init__(self, model_path: Optional[str] = None, model: Optional[BpeModel] = None):
        assert (model_path is None) != (model is None)
        self.model_path = model_path
        self.model = model if model is not None else BpeModel.load(model_path)

    def __len__(self) -> int:
        return len(self.model)

    def __getstate__(self):
        """Pickle-safety across worker processes: a path-based instance is
        pickled without its model and loads it again on the other side."""
        state = self.__dict__.copy()
        if self.model_path is not None:
            state["model"] = None
        return state

    def __setstate__(self, state):
        self.__dict__ = state
        if self.model is None:
            self.model = BpeModel.load(self.model_path)

    def _encode(self, sentence: str) -> List[int]:
        unk = self.unk_token_id
        out: List[int] = []
        for word in _pretokenize(sentence):
            out.extend(self.model.encode_word_ids(word, unk))
        return out

    def decode_pieces(self, ids: Sequence[int]) -> str:
        table = SPECIALS + self.model.pieces
        text = "".join(
            table[i] if 0 <= i < len(table) else "" for i in ids
            if i >= len(SPECIALS)
        )
        return text.replace(WORD_BOUNDARY, " ").lstrip(" ")


class BpeTrainer:
    """Learn a BPE model from text (SentencePieceTrainer.Train analog)."""

    def __init__(self, vocab_size: int = 10000, character_coverage: float = 1.0):
        self.vocab_size = vocab_size
        self.character_coverage = character_coverage

    def train(self, lines: Iterable[str]) -> BpeModel:
        word_freq: Counter = Counter()
        for line in lines:
            for w in _pretokenize(line):
                word_freq[w] += 1

        # Character alphabet (coverage: keep the most frequent chars)
        char_freq: Counter = Counter()
        for w, f in word_freq.items():
            for ch in w:
                char_freq[ch] += f
        chars = [c for c, _ in char_freq.most_common()]
        if self.character_coverage < 1.0:
            keep = max(1, int(len(chars) * self.character_coverage))
            chars = chars[:keep]
        alphabet = set(chars)

        words = {
            w: (tuple(ch if ch in alphabet else None for ch in w), f)
            for w, f in word_freq.items()
        }
        # Drop uncovered chars entirely from the merge corpus
        corpus: Dict[Tuple[str, ...], int] = Counter()
        for sym, f in words.values():
            sym = tuple(s for s in sym if s is not None)
            if sym:
                corpus[sym] += f

        pieces: List[str] = list(chars)
        merges: List[Tuple[str, str]] = []
        budget = self.vocab_size - len(SPECIALS) - len(pieces)

        corpus = dict(corpus)

        native = _bpetrain()
        if native is not None and budget > 0 and corpus:
            return BpeModel(*self._train_native(native, corpus, pieces, budget))

        for _ in range(max(budget, 0)):
            pair_freq: Counter = Counter()
            for sym, f in corpus.items():
                for i in range(len(sym) - 1):
                    pair_freq[(sym[i], sym[i + 1])] += f
            if not pair_freq:
                break
            (a, b), f = pair_freq.most_common(1)[0]
            if f < 2:
                break
            merges.append((a, b))
            pieces.append(a + b)
            new_corpus: Dict[Tuple[str, ...], int] = {}
            for sym, cf in corpus.items():
                out = []
                i = 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                t = tuple(out)
                new_corpus[t] = new_corpus.get(t, 0) + cf
            corpus = new_corpus

        return BpeModel(pieces, merges)

    def _train_native(self, lib, corpus, pieces, budget):
        """Run the merge loop in native/bpetrain.cpp (bit-compatible with the
        Python loop above, including Counter insertion-order tie-breaking)."""
        char_id = {c: i for i, c in enumerate(pieces)}
        seq_lens, flat, freqs = [], [], []
        for sym, f in corpus.items():
            seq_lens.append(len(sym))
            flat.extend(char_id[s] for s in sym)
            freqs.append(f)
        seqs = np.asarray(flat, np.int32)
        lens = np.asarray(seq_lens, np.int32)
        fr = np.asarray(freqs, np.int64)
        out = np.zeros((budget * 2,), np.int32)
        n = lib.bpe_train(
            seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(lens), len(pieces), budget,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        piece_str = list(pieces)
        merges: List[Tuple[str, str]] = []
        for i in range(n):
            a, b = piece_str[out[2 * i]], piece_str[out[2 * i + 1]]
            merges.append((a, b))
            piece_str.append(a + b)
        return piece_str, merges

    def train_file(self, path: str, model_path: str) -> BpeModel:
        with open(path) as f:
            model = self.train(f)
        model.save(model_path)
        return model
