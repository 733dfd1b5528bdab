"""Transcript substrate: loading, validity checks, index construction.

Counterpart of tal_asrd_tpu/data/transcript.py. A split directory holds
  transcript.pkl     {episode_stub: [utterance dicts]}
  <stub>.wav         the episode audio
  speaker_map.json   lowercased speaker name -> id
Utterance dict keys: utterance, speaker, utterance_start, utterance_end,
role (optional), alignments (optional).

The index is built episode by episode, in the transcript's order (sliding
windows of num_utterances consecutive valid utterances with a
discontinuity threshold; the whole episode when num_utterances is None),
and cached in the split directory in the reference's format and file.
`build_episode_durations` is the segment dataset's index: each episode's
valid utterances and its duration.
"""
from __future__ import annotations

import json
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

from tal_asrd_tpu_torch.data.audio_io import get_duration

CACHE_VERSION = 1


def is_valid_utterance(utt: dict, file_max_duration: float) -> bool:
    """Bounds checks of one utterance against its file's duration."""
    start, end = utt["utterance_start"], utt["utterance_end"]
    if start > file_max_duration:
        return False
    if end is not None and not (isinstance(end, float) and math.isnan(end)):
        if start > end:
            return False
        if end > file_max_duration:
            return False
    elif start > (end if end is not None else float("inf")):
        return False
    return True


def is_valid_segment(utterances: Sequence[dict], discontinuity_threshold: float = 3.0) -> bool:
    """Adjacent utterances must not be separated by a long gap."""
    for a, b in zip(utterances, utterances[1:]):
        if b["utterance_start"] - a["utterance_end"] > discontinuity_threshold:
            return False
    return True


def load_transcripts(data_dir: str) -> Dict[str, List[dict]]:
    with open(os.path.join(data_dir, "transcript.pkl"), "rb") as f:
        return pickle.load(f)


def load_speaker_map(path: str) -> Dict[str, int]:
    with open(path) as f:
        return json.load(f)


def episode_index(
    data_dir: str,
    file_stub: str,
    utterances: List[dict],
    num_utterances: Optional[int],
    ext: str,
    discontinuity_threshold: float,
) -> List[Tuple[str, List[dict], float]]:
    """Index one episode: [(stub, segment_utts, duration_s)]."""
    audio_file = os.path.join(data_dir, f"{file_stub}{ext}")
    if not os.path.exists(audio_file):
        raise FileNotFoundError(audio_file)
    f_duration = get_duration(audio_file)

    if num_utterances is None:
        return [(file_stub, utterances, f_duration)]

    valid = [u for u in utterances if is_valid_utterance(u, f_duration)]
    for u in valid:
        end = u["utterance_end"]
        if end is None or (isinstance(end, float) and math.isnan(end)):
            u["utterance_end"] = f_duration

    out = []
    for i in range(len(valid) + 1 - num_utterances):
        seg = valid[i : i + num_utterances]
        if is_valid_segment(seg, discontinuity_threshold):
            dur = sum(u["utterance_end"] - u["utterance_start"] for u in seg)
            out.append((file_stub, seg, dur))
    return out


def build_index(
    data_dir: str,
    num_utterances: Optional[int] = 1,
    ext: str = ".wav",
    discontinuity_threshold: float = 3.0,
    use_cache: bool = True,
) -> List[Tuple[str, List[dict], float]]:
    """Full-split index, cached in the split directory under a key of the
    arguments. The cache is written under a temporary name and moved into
    place, so a reader never sees half of it."""
    arghash = (num_utterances, ext, discontinuity_threshold, CACHE_VERSION)
    cache_loc = os.path.join(data_dir, f"cache_tpu_aligned_{num_utterances}u.pkl")
    if use_cache and os.path.exists(cache_loc):
        try:
            with open(cache_loc, "rb") as f:
                marker, index = pickle.load(f)
            if marker == arghash:
                return index
        except (OSError, EOFError, pickle.UnpicklingError, ValueError, TypeError):
            pass

    transcripts = load_transcripts(data_dir)
    index = [seg for stub, utts in transcripts.items()
             for seg in episode_index(data_dir, stub, utts, num_utterances, ext,
                                      discontinuity_threshold)]
    if not index:
        raise ValueError(f"Empty index for {data_dir}")
    if use_cache:
        _write_cache(cache_loc, arghash, index)
    return index


def _write_cache(cache_loc: str, arghash, index) -> None:
    """Pickle (arghash, index) under a temporary name, then move it into
    place, so a reader never sees half of it."""
    tmp = f"{cache_loc}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump((arghash, index), f)
    os.replace(tmp, cache_loc)


def build_episode_durations(
    data_dir: str, ext: str = ".wav", use_cache: bool = True,
) -> List[Tuple[str, List[dict], float]]:
    """The segment dataset's index: per episode (stub, valid utterances,
    duration in seconds), in the transcript's order, cached in the split
    directory in the reference's format and file."""
    arghash = (ext, CACHE_VERSION)
    cache_loc = os.path.join(data_dir, "cache_tpu_segment.pkl")
    if use_cache and os.path.exists(cache_loc):
        try:
            with open(cache_loc, "rb") as f:
                marker, index = pickle.load(f)
            if marker == arghash:
                return index
        except (OSError, EOFError, pickle.UnpicklingError, ValueError, TypeError):
            pass

    index = []
    for stub, utts in load_transcripts(data_dir).items():
        dur = get_duration(os.path.join(data_dir, f"{stub}{ext}"))
        index.append((stub, [u for u in utts if is_valid_utterance(u, dur)], dur))
    if use_cache:
        _write_cache(cache_loc, arghash, index)
    return index


class SpeakerIds:
    """Speaker-name -> id mapping with the reference's unknown-speaker rule:
    unknown names get the id one past the map."""

    def __init__(self, speaker_map: Optional[Dict[str, int]],
                 first_speaker_id: int = 0, tokenizer_speakers: bool = False):
        self.speaker_map = speaker_map or {}
        self.first = first_speaker_id
        self.tokenizer_speakers = tokenizer_speakers

    def __call__(self, name: str) -> int:
        key = name.lower().strip() if isinstance(name, str) else name
        sid = self.speaker_map.get(key, len(self.speaker_map))
        return self.first + sid if self.tokenizer_speakers else sid
