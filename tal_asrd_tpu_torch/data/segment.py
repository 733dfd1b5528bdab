"""Shift-augmentation segment dataset.

Counterpart of tal_asrd_tpu/data/segment.py: item i is a random window of
10 s to `segment_size` s starting near i x `segment_shift` s of the split's
concatenated episodes (jitter +-`random_segment_shift` s), with the
utterances that intersect it. Boundary utterances are cut in proportion to
the time outside the window (`_proportional_truncate`), or at the window's
bounds by their word alignments (`aligned_truncation`); a window without
an utterance reads `UNK_PHRASE`; tokens are capped at `max_tokens`.

The jitter and the length are drawn from the global `random` module (or
`rng`) in the order the loader asks for items, so after `core.utils.
set_seed` one process with `num_workers=0` draws the reference's windows.
With `det_seed` they come from a generator seeded by (det_seed, item), the
same every epoch: the validation windows.
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, load_audio_segment
from tal_asrd_tpu_torch.data.format import (
    tokenize_utterances,
    tokenize_utterances_word_align,
)
from tal_asrd_tpu_torch.data.transcript import (
    SpeakerIds,
    build_episode_durations,
    load_speaker_map,
)

UNK_PHRASE = "[UNINTELLIGIBLE]"


class SegmentDataset:
    def __init__(
        self,
        data_dir: str,
        tokenizer,
        speaker_map_loc: Optional[str] = None,
        min_segment_size: float = 10.0,
        segment_size: float = 30.0,
        segment_shift: float = 10.0,
        random_segment_shift: float = 5.0,
        max_tokens: int = 128,
        ext: str = ".wav",
        aligned_truncation: bool = False,
        tokenizer_speakers: bool = False,
        return_spk_ids: bool = False,
        sample_rate: int = DEFAULT_SR,
        rng: Optional[random.Random] = None,
        det_seed: Optional[int] = None,
    ):
        if aligned_truncation and return_spk_ids:
            raise ValueError("aligned_truncation gives no speaker ids")
        self.data_dir = data_dir
        self.ext = ext
        self.tokenizer = tokenizer
        self.segment_size = segment_size
        self.min_segment_size = min_segment_size
        self.segment_shift = segment_shift
        self.random_segment_shift = random_segment_shift
        self.max_tokens = max_tokens
        self.aligned_truncation = aligned_truncation
        self.tokenizer_speakers = tokenizer_speakers
        self.return_spk_ids = return_spk_ids
        self.sample_rate = sample_rate
        self.rng = rng or random
        self.det_seed = det_seed

        speaker_map = load_speaker_map(speaker_map_loc) if speaker_map_loc else None
        self.speaker_ids = SpeakerIds(
            speaker_map,
            first_speaker_id=len(tokenizer) if tokenizer_speakers else 0,
            tokenizer_speakers=tokenizer_speakers,
        )
        self.index = build_episode_durations(data_dir, ext)
        self.total_seconds = sum(d for _, _, d in self.index)

    def __len__(self) -> int:
        return int(self.total_seconds) // int(self.segment_shift)

    def __getitem__(self, i: int):
        # the episode that holds chunk i, and i within it
        stub, utterances, f_duration = self.index[-1]
        for stub, utterances, f_duration in self.index:
            num_segments = int(f_duration // self.segment_shift)
            if i < num_segments:
                break
            i -= num_segments
        if f_duration < self.segment_size:
            raise ValueError(f"episode {stub} ({f_duration} s) is shorter than a "
                             f"{self.segment_size} s segment")

        rng = (random.Random(self.det_seed * 1_000_003 + i)
               if self.det_seed is not None else self.rng)
        jitter = (rng.random() - 0.5) * 2 * self.random_segment_shift
        start_time = min(
            max(i * self.segment_shift + jitter, 0.0),
            f_duration - self.segment_size,
        )
        end_time = min(
            start_time
            + rng.random() * (self.segment_size - self.min_segment_size)
            + self.min_segment_size,
            f_duration,
        )

        # the utterances that intersect the window (one run of them)
        selected = []
        for j, utt in enumerate(utterances):
            if utt["utterance_end"] > start_time and utt["utterance_start"] <= end_time:
                selected.append((j, utt))
            elif selected:
                break

        if not selected:
            tokens = self.tokenizer.encode(UNK_PHRASE, bos_token=False, eos_token=False)
            spk_ids = [self.speaker_ids("unknown")] * len(tokens)
        elif self.aligned_truncation:
            tokens = tokenize_utterances_word_align(
                utterances, selected, start_time, end_time, self.tokenizer,
                tokenize_speaker=self.tokenizer_speakers,
                speaker_to_id=self.speaker_ids,
            )
            spk_ids = [0] * len(tokens)
        else:
            tokens, spk_ids = tokenize_utterances(
                utterances, selected, self.tokenizer,
                tokenize_speaker=self.tokenizer_speakers,
                speaker_to_id=self.speaker_ids,
                return_spk_ids=True,
            )
            tokens, spk_ids = self._proportional_truncate(
                tokens, spk_ids, selected, start_time, end_time
            )

        tokens = tokens[: self.max_tokens]
        spk_ids = (spk_ids or [0] * len(tokens))[: self.max_tokens]

        path = os.path.join(self.data_dir, f"{stub}{self.ext}")
        wav = load_audio_segment(path, start_time, end_time, self.sample_rate)
        return wav, np.asarray(tokens, np.int32), np.asarray(spk_ids, np.int32), i

    def _proportional_truncate(self, tokens, spk_ids, selected, start_time, end_time):
        """Cut the boundary utterances' tokens by the share of their time
        that lies outside the window."""
        start_utt = selected[0][1]
        end_utt = selected[-1][1]
        utt_start = start_utt["utterance_start"]
        utt_end = end_utt["utterance_end"]
        if utt_end - utt_start <= self.segment_size:
            return tokens, spk_ids

        def n_tokens(u):
            return len(self.tokenizer.encode(u["utterance"], bos_token=False,
                                             eos_token=False))

        start_oob = start_time - utt_start
        end_oob = utt_end - end_time
        start_prct = start_oob / max(start_utt["utterance_end"] - utt_start, 1e-9)
        end_prct = end_oob / max(utt_end - end_utt["utterance_start"], 1e-9)
        trunc_start = max(round(start_prct * n_tokens(start_utt)), 0)
        trunc_end = max(round(end_prct * n_tokens(end_utt)), 0)
        stop = len(tokens) - trunc_end
        return tokens[trunc_start:stop], spk_ids[trunc_start:stop]
