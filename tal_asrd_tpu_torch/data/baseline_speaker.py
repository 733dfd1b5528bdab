"""Speaker-ID utterance dataset of the separate speaker-diarization baseline.

Counterpart of tal_asrd_tpu/data/baseline_speaker.py `SDUtteranceDataset`:
one utterance a sample — the first utterance of each item of
`build_index(num_utterances=1)` whose duration is at least
`min_segment_duration` (3 s) and under `max_segment_duration` — as
(wav, speaker id, index), for training SDModel as a frame-level speaker
classifier. `num_speakers` is the map's size plus one (the id an unknown
speaker gets), 1 without a map.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, load_audio_segment
from tal_asrd_tpu_torch.data.transcript import SpeakerIds, build_index, load_speaker_map


class SDUtteranceDataset:
    def __init__(
        self,
        data_dir: str,
        speaker_map_loc: Optional[str] = None,
        ext: str = ".wav",
        min_segment_duration: Optional[float] = 3.0,
        max_segment_duration: Optional[float] = None,
        sample_rate: int = DEFAULT_SR,
    ):
        self.data_dir = data_dir
        self.ext = ext
        self.sample_rate = sample_rate
        speaker_map = load_speaker_map(speaker_map_loc) if speaker_map_loc else None
        self.speaker_ids = SpeakerIds(speaker_map)
        self.num_speakers = (len(speaker_map) + 1) if speaker_map else 1

        full = build_index(data_dir, num_utterances=1, ext=ext)
        self.index = [
            (stub, utts)
            for stub, utts, duration in full
            if (min_segment_duration is None or duration >= min_segment_duration)
            and (max_segment_duration is None or duration < max_segment_duration)
        ]

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        stub, utts = self.index[i]
        utt = utts[0]
        path = os.path.join(self.data_dir, f"{stub}{self.ext}")
        wav = load_audio_segment(
            path, utt["utterance_start"], utt["utterance_end"], self.sample_rate
        )
        return wav, np.int32(self.speaker_ids(utt["speaker"])), i
