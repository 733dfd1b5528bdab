"""Bucketed collation.

Counterpart of tal_asrd_tpu/data/collate.py: batches pad up to a small fixed
set of bucket sizes (audio 5/10/20/30 s, text 32/64/128/256 tokens), as the
reference does for its compiled steps. The port keeps the buckets although
eager PyTorch needs no static shapes: the encoder's padding mask scales the
lengths by the padded length, so only the same bucket gives the same
features. Masks and lengths carry the true sizes.

Output batches are dicts of numpy arrays:
  audio [B, T_bucket] f32, audio_lens [B] i32, text [B, L_bucket] i32,
  text_mask [B, L_bucket] bool, spk_ids [B, L_bucket] i32, idx [B] i32

`SDCollater` batches the speaker baseline's (wav, speaker id, index)
samples: audio padded to a 5 / 10 / 20 s bucket (cut to the last), audio_lens,
speaker [B] i32, idx [B] i32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR


def pcm16(w: np.ndarray) -> np.ndarray:
    """Float audio in [-1, 1] -> int16 PCM (rounded, clipped)."""
    return np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BucketedCollater:
    def __init__(
        self,
        pad_id: int,
        audio_bucket_seconds: Sequence[float] = (5, 10, 20, 30),
        text_buckets: Sequence[int] = (32, 64, 128, 256),
        sample_rate: int = DEFAULT_SR,
        truncate_to_bucket: bool = True,
        audio_int16: bool = False,
    ):
        self.pad_id = pad_id
        self.audio_buckets = [int(s * sample_rate) for s in audio_bucket_seconds]
        self.text_buckets = list(text_buckets)
        self.truncate = truncate_to_bucket
        # int16 audio halves the host->device transfer; the model rescales
        # on the device (lossless for 16-bit PCM sources).
        self.audio_int16 = audio_int16

    def __call__(self, samples: List[Tuple]) -> Dict[str, np.ndarray]:
        wavs, texts, spks, idxs = zip(*samples)
        b = len(wavs)

        t_max = max(len(w) for w in wavs)
        t_bucket = pick_bucket(t_max, self.audio_buckets)
        l_max = max(len(t) for t in texts)
        l_bucket = pick_bucket(l_max, self.text_buckets)

        audio = np.zeros((b, t_bucket),
                         np.int16 if self.audio_int16 else np.float32)
        audio_lens = np.zeros((b,), np.int32)
        text = np.full((b, l_bucket), self.pad_id, np.int32)
        text_mask = np.zeros((b, l_bucket), bool)
        spk_ids = np.full((b, l_bucket), self.pad_id, np.int32)

        for i, (w, t, s) in enumerate(zip(wavs, texts, spks)):
            wlen = min(len(w), t_bucket) if self.truncate else len(w)
            tlen = min(len(t), l_bucket) if self.truncate else len(t)
            audio[i, :wlen] = pcm16(w[:wlen]) if self.audio_int16 else w[:wlen]
            audio_lens[i] = wlen
            text[i, :tlen] = t[:tlen]
            text_mask[i, :tlen] = True
            spk_ids[i, :tlen] = np.asarray(s)[:tlen]

        return {
            "audio": audio,
            "audio_lens": audio_lens,
            "text": text,
            "text_mask": text_mask,
            "spk_ids": spk_ids,
            "idx": np.asarray(idxs, np.int32),
        }


class SDCollater:
    """Speaker-ID batches for SDModel training (data/baseline_speaker.py)."""

    def __init__(self, audio_bucket_seconds: Sequence[float] = (5, 10, 20),
                 sample_rate: int = DEFAULT_SR, audio_int16: bool = False):
        self.audio_buckets = [int(s * sample_rate) for s in audio_bucket_seconds]
        self.audio_int16 = audio_int16

    def __call__(self, samples):
        wavs, sids, idxs = zip(*samples)
        b = len(wavs)
        t_bucket = pick_bucket(max(len(w) for w in wavs), self.audio_buckets)
        audio = np.zeros((b, t_bucket),
                         np.int16 if self.audio_int16 else np.float32)
        audio_lens = np.zeros((b,), np.int32)
        for i, w in enumerate(wavs):
            wlen = min(len(w), t_bucket)
            audio[i, :wlen] = pcm16(w[:wlen]) if self.audio_int16 else w[:wlen]
            audio_lens[i] = wlen
        return {
            "audio": audio,
            "audio_lens": audio_lens,
            "speaker": np.asarray(sids, np.int32),
            "idx": np.asarray(idxs, np.int32),
        }
