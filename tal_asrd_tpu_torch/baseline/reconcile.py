"""Reconciliation of a separate ASR system with the separate SD system.

Counterpart of tal_asrd_tpu/baseline/reconcile.py, on the host in numpy:
(a) the gold speaker of each SD encoder frame (a 1.41 s receptive field
advancing 0.08 s a frame), (b) the dump of an episode's SD frame features,
argmax ids and gold frame speakers, and (c) the merge of the ASR system's
hypothesis utterances (with utterance_start / utterance_end times) with the
SD frame tracks into the WDER hypothesis format. Only (b) touches the
device, through `SDSystem.frame_features`.

`<stub>.sd_features.npy` is the [T, D] array that `cli.tools wder-format
--sd-features` reads; its frames are the ASR encoder's (the same TDS), so
they line up with the state machine's `chunkStart`.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FRAME_HOP_S = 0.08   # encoder output hop (8 x 10 ms)
FRAME_RF_S = 1.41    # encoder receptive field


def frame_gold_speakers(
    utterances: Sequence[dict],
    n_frames: int,
    hop_s: float = FRAME_HOP_S,
    rf_s: float = FRAME_RF_S,
    unknown: int = -1,
) -> np.ndarray:
    """Gold speaker per encoder frame (an object array): the speaker of the
    first utterance that holds the frame's centre i * hop_s + rf_s / 2,
    `unknown` where none does."""
    out = np.full(n_frames, unknown, dtype=object)
    centers = np.arange(n_frames) * hop_s + rf_s / 2.0
    starts = np.array([u["utterance_start"] for u in utterances])
    ends = np.array([u["utterance_end"] for u in utterances])
    for i, c in enumerate(centers):
        hits = np.where((starts <= c) & (c < ends))[0]
        if len(hits):
            out[i] = utterances[hits[0]]["speaker"]
    return out


def dump_episode_features(
    sd_system, audio: np.ndarray, utterances: Sequence[dict],
    out_dir: str, stub: str, sample_rate: int = 16000,
) -> Dict[str, str]:
    """Run the SD system (its current parameters) over one episode's audio
    and save `<stub>.sd_features.npy` (the unpadded frames' embeddings,
    float32), `<stub>.sd_ids.npy` (their argmax ids) and
    `<stub>.gold_speakers.pkl` (`frame_gold_speakers`). Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    emb, pred_ids, pad = sd_system.frame_features(audio[None], np.asarray([len(audio)]))
    n_frames = int((~pad[0]).sum()) if pad is not None else emb.shape[1]
    gold = frame_gold_speakers(utterances, n_frames)
    paths = {
        "features": os.path.join(out_dir, f"{stub}.sd_features.npy"),
        "pred_ids": os.path.join(out_dir, f"{stub}.sd_ids.npy"),
        "gold": os.path.join(out_dir, f"{stub}.gold_speakers.pkl"),
    }
    np.save(paths["features"], emb[0, :n_frames])
    np.save(paths["pred_ids"], pred_ids[0, :n_frames])
    with open(paths["gold"], "wb") as f:
        pickle.dump(gold, f)
    return paths


def utterance_frame_span(utt_start_s: float, utt_end_s: float,
                         hop_s: float = FRAME_HOP_S) -> Tuple[int, int]:
    return int(utt_start_s / hop_s), max(int(utt_end_s / hop_s), 1)


def merge_asr_sd(
    hyp_utterances: Sequence[dict],
    sd_frame_ids: np.ndarray,
    sd_frame_features: Optional[np.ndarray] = None,
    role_map: Optional[dict] = None,
) -> List[Tuple]:
    """Separate-ASR hypotheses + SD frame tracks -> WDER hypothesis entries
    (text, (mean frame embedding or None, majority SD id or None), role).
    The span [a, b) is clamped to the track (a = min(a, max(b - 1, 0))); a
    majority tie goes to the smallest id; the role defaults to "subject"."""
    out = []
    for utt in hyp_utterances:
        a, b = utterance_frame_span(utt["utterance_start"], utt["utterance_end"])
        b = min(b, len(sd_frame_ids))
        a = min(a, max(b - 1, 0))
        ids = sd_frame_ids[a:b]
        if len(ids):
            vals, counts = np.unique(ids, return_counts=True)
            sid = int(vals[np.argmax(counts)])
        else:
            sid = None
        emb = None
        if sd_frame_features is not None and b > a:
            emb = np.asarray(sd_frame_features[a:b]).mean(axis=0)
        role = (role_map or {}).get(sid, "subject")
        out.append((utt["utterance"], (emb, sid), role))
    return out
