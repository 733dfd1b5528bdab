"""Unlabeled random audio chunk dataset.

Counterpart of tal_asrd_tpu/data/audio.py `RandomSegmentDataset`: random
fixed-length windows from a directory of wavs, for pretraining-style use,
with corrupt-file quarantine (a bad file is logged and a random other file
is taken instead). The draws (`rng.random()` for a window's start,
`rng.randrange` for a substitute) are the JAX package's, so the same `rng`
state gives the same windows.
"""
from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, get_duration, load_audio_segment


class RandomSegmentDataset:
    def __init__(
        self,
        data_dir: str,
        segment_seconds: float = 15.0,
        ext: str = ".wav",
        sample_rate: int = DEFAULT_SR,
        quarantine_log: Optional[str] = "out/bad_wav.log",
        rng: Optional[random.Random] = None,
    ):
        self.data_dir = data_dir
        self.segment_seconds = segment_seconds
        self.sample_rate = sample_rate
        self.quarantine_log = quarantine_log
        self.rng = rng or random
        self.files: List[str] = sorted(
            os.path.join(data_dir, f)
            for f in os.listdir(data_dir)
            if f.endswith(ext)
        )
        if not self.files:
            raise ValueError(f"No {ext} files in {data_dir}")
        self.bad: set = set()

    def __len__(self) -> int:
        return len(self.files)

    def _quarantine(self, path: str, err: Exception) -> None:
        self.bad.add(path)
        if self.quarantine_log:
            os.makedirs(os.path.dirname(self.quarantine_log), exist_ok=True)
            with open(self.quarantine_log, "a") as f:
                f.write(f"{path}\t{type(err).__name__}: {err}\n")

    def __getitem__(self, i: int) -> np.ndarray:
        for _ in range(len(self.files)):
            path = self.files[i % len(self.files)]
            if path in self.bad:
                i = self.rng.randrange(len(self.files))
                continue
            try:
                dur = get_duration(path)
                start = (0.0 if dur <= self.segment_seconds
                         else self.rng.random() * (dur - self.segment_seconds))
                wav = load_audio_segment(
                    path, start, start + self.segment_seconds, self.sample_rate
                )
                if wav.shape[0] == 0:
                    raise ValueError("empty audio")
                return wav
            except Exception as e:  # corrupt file: quarantine + resample
                self._quarantine(path, e)
                i = self.rng.randrange(len(self.files))
        raise RuntimeError("All audio files quarantined")
