"""VAD evaluation: frame-level precision / recall / F1 and compression.

Counterpart of tal_asrd_tpu/vad/eval.py: predictions and gold both as
(start_s, end_s) bound lists, rasterized to 10 ms frames and scored by frame
confusion; compression = kept frames / total frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

Bounds = Sequence[Tuple[float, float]]


@dataclass
class VadScores:
    precision: float
    recall: float
    f1: float
    compression: float


def rasterize(bounds: Bounds, duration_s: float, frame_s: float = 0.01) -> np.ndarray:
    n = int(round(duration_s / frame_s))
    mask = np.zeros(n, bool)
    for s, e in bounds:
        a = max(int(round(s / frame_s)), 0)
        b = min(int(round(e / frame_s)), n)
        mask[a:b] = True
    return mask


def evaluate_vad(pred_bounds: Bounds, gold_bounds: Bounds, duration_s: float,
                 frame_s: float = 0.01) -> VadScores:
    pred = rasterize(pred_bounds, duration_s, frame_s)
    gold = rasterize(gold_bounds, duration_s, frame_s)
    tp = float(np.sum(pred & gold))
    fp = float(np.sum(pred & ~gold))
    fn = float(np.sum(~pred & gold))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return VadScores(precision, recall, f1, float(np.mean(pred)))


def utterance_gold_bounds(utterances: Sequence[dict]) -> List[Tuple[float, float]]:
    """Gold speech bounds from transcript utterance dicts."""
    return [(u["utterance_start"], u["utterance_end"]) for u in utterances]
