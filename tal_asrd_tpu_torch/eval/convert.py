"""Generation results -> WDER-ready format, and the score of a test run.

Counterpart of tal_asrd_tpu/eval/convert.py for the aligned case (what
`python -m tal_asrd_tpu.cli.tools wder-format` runs without SD features):
test_result.pkl entries — ref utterance dicts, hyp dicts with 'utterance',
'speakerId' and, from a speaker-token model, 'speakerEmbed' — become

    ref:  [(utt_text, speaker, role), ...]
    hyp:  [(utt_text, (speaker_embedding or None, speaker_id), role), ...]

`score_test_result` is the non-clustered path of
tal_asrd_tpu/cli/wder.py (punkt word tokens): convert, then corpus WER and
WDER. The unaligned runs' attention-windowed embeddings (SD features) and the
clustering of embeddings belong to the embedding chain (ROADMAP A16.2).
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.eval.wder import corpus_wder


def hyp_utterance_entry(hyp: dict, role_map: Optional[dict]) -> Tuple:
    """One hypothesis dict -> (text, (embedding | None, speakerId), role)."""
    sid = hyp.get("speakerId")
    role = (role_map or {}).get(sid, "subject")
    emb = np.asarray(hyp["speakerEmbed"], np.float32) if "speakerEmbed" in hyp else None
    return (hyp["utterance"], (emb, sid), role)


def ref_utterance_entry(ref: dict, role_map: Optional[dict] = None) -> Tuple:
    role = ref.get("role") or (role_map or {}).get(ref.get("speaker"), "subject")
    return (ref["utterance"], ref.get("speaker"), role)


def convert_results(results: Sequence[Tuple[List[dict], List[dict]]],
                    role_map: Optional[dict] = None):
    """(ref_utts, hyp_utts) pairs -> wder-ready pairs."""
    return [([ref_utterance_entry(r, role_map) for r in refs],
             [hyp_utterance_entry(h, role_map) for h in hyps])
            for refs, hyps in results]


def score_test_result(path: str, allow_degenerate: bool = False) -> Dict:
    """WER and WDER of a test_result.pkl, as `cli.tools wder-format` then
    `cli.wder --eval-file` (no clustering) compute them. Returns the fields
    cli.wder writes to its `-wder.pkl` (ref_speakers, hyp_speakers,
    overall_wder, dist, n_words, overall_wer) and the segment count."""
    with open(path, "rb") as f:
        results = pickle.load(f)
    ref_spk, hyp_spk, overall_wder, dist, n_words, overall_wer = corpus_wder(
        convert_results(results), allow_degenerate=allow_degenerate)
    return {"ref_speakers": ref_spk, "hyp_speakers": hyp_spk,
            "overall_wder": overall_wder, "dist": dist, "n_words": n_words,
            "overall_wer": overall_wer, "n_segments": len(results)}
