"""Standalone long-audio transcription: overlapped windows, batched beam
decode, longest-match splicing.

Counterpart of tal_asrd_tpu/decode/transcribe.py: fixed windows (e.g. 20-40
s) with a fractional overlap, decoded in batches through `make_generate_fn`
(encode + beam search), then adjacent window texts spliced at their longest
common substring inside the overlap (difflib's find_longest_match; matches
shorter than 5 characters are ignored, and both sides kept). Optional VAD
pre-gating (`speech_only`). Under `use_eot` the search is primed with BOS
and stops at EOT (the tokenizer's shared id 0); otherwise EOS primes and
stops it. Rows that reach `max_new_tokens` without a stop are kept
(`force_output`).
"""
from __future__ import annotations

from dataclasses import dataclass
from difflib import SequenceMatcher
from typing import List, Sequence, Union

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, load_audio_segment
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, make_generate_fn
from tal_asrd_tpu_torch.vad.core import VadConfig, get_speech_frames


# ---------------------------------------------------------------------------
# Overlap splicing
# ---------------------------------------------------------------------------
def overlap_ix(a: str, b: str, word_overlap: int = 5):
    a_ix = len(a) - len(" ".join(a.split()[-word_overlap:]))
    b_ix = len(" ".join(b.split()[: word_overlap + 1]))
    return a_ix, b_ix


def splice_ix(a: str, b: str, word_overlap: int = 5):
    aix, bix = overlap_ix(a, b, word_overlap)
    match = SequenceMatcher(None, a, b).find_longest_match(aix, len(a), 0, bix)
    if not match or match.size < 5:  # < ~1-2 words matched: keep both sides
        return len(a), 0
    return match.a, match.b


def splice_strings(strs: List[str], word_overlap: int = 20) -> str:
    if not strs:
        return ""
    if len(strs) == 1:
        return strs[0].strip()
    first_end, a_start = splice_ix(strs[0], strs[1], word_overlap)
    out = strs[0][:first_end].strip()
    for i in range(1, len(strs) - 1):
        a_end, b_start = splice_ix(strs[i], strs[i + 1], word_overlap)
        out += " " + strs[i][a_start:a_end].strip()
        a_start = b_start
    out += " " + strs[-1][a_start:].strip()
    return out


# ---------------------------------------------------------------------------
# Windowed transcription
# ---------------------------------------------------------------------------
@dataclass
class TranscribeConfig:
    window_seconds: float = 30.0
    overlap: float = 0.25            # fraction of a window overlapped
    batch_size: int = 16
    beam_size: int = 4
    lm_weight: float = 0.0           # inert: no LM is given here, as in the reference's CLI
    max_new_tokens: int = 120
    use_eot: bool = True             # prime with BOS, stop at EOT (else EOS)
    speech_only: bool = False        # VAD pre-gate
    splice: bool = True
    sample_rate: int = DEFAULT_SR


class Transcriber:
    """Window-batched transcription around a model (on `device`) and a
    tokenizer; `decoder` as in make_generate_fn (a FusedASRDecoder built on
    the model decodes through kernel K1 on the card)."""

    def __init__(self, model, tokenizer, cfg: TranscribeConfig, decoder=None,
                 device: str = "cuda"):
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.device = device
        self._generate = make_generate_fn(model, self._spec(), decoder=decoder,
                                          device=device)

    def _spec(self) -> BeamSearchSpec:
        c = self.cfg
        return BeamSearchSpec(
            beam_size=c.beam_size,
            max_new_tokens=c.max_new_tokens,
            eos_id=self.tokenizer.eot_token_id if c.use_eot else self.tokenizer.eos_token_id,
            vocab_size=self.model.cfg.num_tokens,
            text_vocab_size=len(self.tokenizer),
            lm_weight=c.lm_weight,
            force_output=True,
        )

    def transcribe_batch(self, windows: Sequence[np.ndarray]) -> List[str]:
        c = self.cfg
        b = len(windows)
        t = max(len(w) for w in windows)
        audio = np.zeros((b, t), np.float32)
        lens = np.zeros((b,), np.int32)
        for i, w in enumerate(windows):
            audio[i, : len(w)] = w
            lens[i] = len(w)
        prime_id = self.tokenizer.bos_token_id if c.use_eot else self.tokenizer.eos_token_id
        out = self._generate(audio, lens, np.full((b, 1), prime_id, np.int64))
        tokens = out["tokens"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        return [self.tokenizer.decode([int(t) for t in tokens[i, 1: lengths[i]]])  # drop the prime
                for i in range(b)]

    def transcribe_file(self, audio_path: str, truncate: float = -1.0,
                        log: bool = False) -> Union[str, List[str]]:
        c = self.cfg
        x = load_audio_segment(audio_path, 0.0, None, c.sample_rate)
        if truncate > 0:
            x = x[: int(truncate * len(x))]
        if c.speech_only:
            x = get_speech_frames(x, VadConfig(sample_rate=c.sample_rate), device=self.device)
        return self.transcribe_array(x, log=log)

    def transcribe_array(self, x: np.ndarray, log: bool = False) -> Union[str, List[str]]:
        c = self.cfg
        window = int(c.window_seconds * c.sample_rate)
        stride = int(window * (1.0 - c.overlap))
        n_windows = max(int(np.ceil((len(x) - window) / stride)) + 1, 1)

        texts: List[str] = []
        batch: List[np.ndarray] = []
        for i in range(n_windows):
            w = x[stride * i: stride * i + window]
            if len(w) == 0:
                break
            if len(w) < window:      # pad to a full window: one shape a batch
                w = np.pad(w, (0, window - len(w)))
            batch.append(w)
            if len(batch) == c.batch_size or i == n_windows - 1:
                texts.extend(self.transcribe_batch(batch))
                batch = []
        if log:
            print(f"{n_windows} windows -> {len(texts)} texts")
        if c.splice:
            merge_window = 3 * int((window - stride) // c.sample_rate)
            return splice_strings(texts, max(merge_window, 5))
        return texts
