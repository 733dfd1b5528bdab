"""Speech-activity-detection harness: RTTM / UEM export and binarization.

Counterpart of tal_asrd_tpu/vad/sad.py: a corpus exported to RTTM / UEM
(one SPEAKER row an utterance, one UEM row an episode), and frame speech
scores binarized with onset / offset hysteresis (pyannote's Binarize: a
region opens where a score is above `onset` and closes where one is below
`offset`; gaps shorter than `min_duration_off` are merged first, then
regions shorter than `min_duration_on` dropped). Scores are read in
float64. Host code, numpy only.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def to_rttm(episode_id: str, utterances: Sequence[dict]) -> str:
    """SPEAKER rows, one per utterance (RTTM v1.3 layout)."""
    lines = []
    for u in utterances:
        start = u["utterance_start"]
        dur = u["utterance_end"] - u["utterance_start"]
        spk = str(u.get("speaker", "spk")).replace(" ", "_")
        lines.append(
            f"SPEAKER {episode_id} 1 {start:.3f} {dur:.3f} <NA> <NA> {spk} <NA> <NA>"
        )
    return "\n".join(lines) + "\n"


def to_uem(episode_id: str, duration_s: float) -> str:
    return f"{episode_id} 1 0.000 {duration_s:.3f}\n"


def export_corpus(transcripts: Dict[str, List[dict]], durations: Dict[str, float],
                  out_dir: str) -> None:
    """OUT_DIR/corpus.rttm and OUT_DIR/corpus.uem of a corpus."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "corpus.rttm"), "w") as fr, open(
        os.path.join(out_dir, "corpus.uem"), "w"
    ) as fu:
        for stub, utts in transcripts.items():
            fr.write(to_rttm(stub, utts))
            fu.write(to_uem(stub, durations[stub]))


def binarize(
    scores: np.ndarray,
    frame_s: float,
    onset: float = 0.52,
    offset: float = 0.52,
    min_duration_on: float = 0.0,
    min_duration_off: float = 0.0,
) -> List[Tuple[float, float]]:
    """Hysteresis binarization of frame scores -> (start_s, end_s) regions."""
    regions: List[Tuple[float, float]] = []
    active = False
    start = 0.0
    for i, s in enumerate(np.asarray(scores, np.float64)):
        t = i * frame_s
        if not active and s > onset:
            active = True
            start = t
        elif active and s < offset:
            active = False
            regions.append((start, t))
    if active:
        regions.append((start, len(scores) * frame_s))

    # merge gaps shorter than min_duration_off
    if min_duration_off > 0 and regions:
        merged = [regions[0]]
        for s, e in regions[1:]:
            ps, pe = merged[-1]
            if s - pe < min_duration_off:
                merged[-1] = (ps, e)
            else:
                merged.append((s, e))
        regions = merged
    # drop regions shorter than min_duration_on
    if min_duration_on > 0:
        regions = [(s, e) for s, e in regions if e - s >= min_duration_on]
    return regions
