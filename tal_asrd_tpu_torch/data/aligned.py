"""Aligned utterance dataset.

Counterpart of tal_asrd_tpu/data/aligned.py: sliding windows of
`num_utterances` consecutive valid utterances (or whole episodes when None),
duration pruning, `<EOS> tokens <spk> <EOS>` formatting, returning (wav
float32, token ids, speaker ids, index). Plain Python over numpy (no torch
Dataset base); data/collate.py batches the items.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, load_audio_segment
from tal_asrd_tpu_torch.data.format import tokenize_utterances
from tal_asrd_tpu_torch.data.transcript import SpeakerIds, build_index, load_speaker_map


class AlignedDataset:
    def __init__(
        self,
        data_dir: str,
        tokenizer,
        speaker_map_loc: Optional[str] = None,
        ext: str = ".wav",
        num_utterances: Optional[int] = 1,
        min_segment_duration: Optional[float] = 3.0,
        max_segment_duration: Optional[float] = None,
        discontinuity_threshold: float = 3.0,
        tokenizer_speakers: bool = False,
        return_spk_ids: bool = False,
        sample_rate: int = DEFAULT_SR,
        cache_items: bool = False,
    ):
        self.data_dir = data_dir
        self.ext = ext
        self.tokenizer = tokenizer
        self.num_utterances = num_utterances
        self.tokenizer_speakers = tokenizer_speakers
        self.return_spk_ids = return_spk_ids
        self.sample_rate = sample_rate
        # In-RAM item cache; pays off from the second epoch when the host is
        # the bottleneck.
        self._cache = {} if cache_items else None

        speaker_map = load_speaker_map(speaker_map_loc) if speaker_map_loc else None
        self.speaker_ids = SpeakerIds(
            speaker_map,
            first_speaker_id=len(tokenizer) if tokenizer_speakers else 0,
            tokenizer_speakers=tokenizer_speakers,
        )

        full = build_index(
            data_dir, num_utterances, ext, discontinuity_threshold
        )
        # Duration pruning
        self.index = [
            (stub, utts)
            for stub, utts, duration in full
            if (min_segment_duration is None or duration >= min_segment_duration)
            and (max_segment_duration is None or duration < max_segment_duration)
        ]

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        stub, utterances = self.index[i]
        tokens, spk_ids = tokenize_utterances(
            utterances,
            list(enumerate(utterances)),
            self.tokenizer,
            add_eot=False,
            tokenize_speaker=self.tokenizer_speakers,
            speaker_to_id=self.speaker_ids,
            return_spk_ids=self.return_spk_ids,
        )
        path = os.path.join(self.data_dir, f"{stub}{self.ext}")
        wav = load_audio_segment(
            path,
            utterances[0]["utterance_start"],
            utterances[-1]["utterance_end"],
            self.sample_rate,
        )
        if wav.shape[0] == 0 or len(tokens) < 2:
            raise ValueError(f"item {i} of {self.data_dir}: empty audio or text")
        if spk_ids is None:
            spk_ids = [0] * len(tokens)
        item = (wav, np.asarray(tokens, np.int32),
                np.asarray(spk_ids, np.int32), i)
        if self._cache is not None:
            self._cache[i] = item
        return item
