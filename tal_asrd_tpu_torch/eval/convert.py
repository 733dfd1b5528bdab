"""Generation results -> WDER-ready format, and the score of a test run.

Counterpart of tal_asrd_tpu/eval/convert.py (what `python -m
tal_asrd_tpu_torch.cli.tools wder-format` runs): test_result.pkl entries —
ref utterance dicts, hyp dicts with 'utterance', 'speakerId' and, from a
speaker-token model, 'speakerEmbed', or from an unaligned run 'attention'
[n_tokens x chunk], 'chunkStart' [n_tokens] and 'utteranceTokens' — become

    ref:  [(utt_text, speaker, role), ...]
    hyp:  [(utt_text, (speaker_embedding or None, speaker_id), role), ...]

With separate-SD frame features an utterance's embedding is the
attention-weighted sum of the features under each token's encoder window,
emb[t] = attn[t] . sd_features[chunkStart[t] : chunkStart[t] + chunk], one
gather and product on `device` an utterance (`_window_embed`); the
word-level variant groups the decoder tokens into words and also takes the
SD speaker id with the most attention mass under the word.

`score_test_result` is the non-clustered path of cli/wder.py (punkt word
tokens): convert, then corpus WER and WDER.
"""
from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.align.forced import token_word_groups
from tal_asrd_tpu_torch.eval.wder import corpus_wder


def _window_embed(attention: np.ndarray, chunk_starts: np.ndarray,
                  sd_features: np.ndarray, device="cuda") -> np.ndarray:
    """[n_tok, chunk] x [n_tok] x [T, D] -> [n_tok, D]: windows clamped into
    the zero-padded features, attention masked past the last real frame."""
    attention = np.asarray(attention, np.float32)
    chunk_starts = np.asarray(chunk_starts, np.int64)
    _, chunk = attention.shape
    t_total, d = sd_features.shape
    feats = np.concatenate([np.asarray(sd_features, np.float32),
                            np.zeros((chunk, d), np.float32)], axis=0)
    idx = np.minimum(chunk_starts[:, None] + np.arange(chunk)[None, :],
                     t_total + chunk - 1)
    attn = attention * (idx < t_total)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.einsum("tc,tcd->td", torch.from_numpy(attn).to(device),
                           torch.from_numpy(feats).to(device)[torch.from_numpy(idx).to(device)])
        return out.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def hyp_utterance_entry(hyp: dict, role_map: Optional[dict],
                        sd_features: Optional[np.ndarray] = None, chunk: int = 357,
                        device="cuda") -> Tuple:
    """One hypothesis dict -> (text, (embedding | None, speakerId), role)."""
    sid = hyp.get("speakerId")
    role = (role_map or {}).get(sid, "subject")
    emb = None
    if "speakerEmbed" in hyp:
        emb = np.asarray(hyp["speakerEmbed"], np.float32)
    elif sd_features is not None and "attention" in hyp and "chunkStart" in hyp:
        att = np.asarray(hyp["attention"], np.float32)
        if att.shape[-1] != chunk:
            att = att[..., :chunk]
        emb = _window_embed(att, hyp["chunkStart"], sd_features, device)
    return (hyp["utterance"], (emb, sid), role)


def hyp_word_entries(hyp: dict, tokenizer, role_map: Optional[dict],
                     sd_features: np.ndarray, sd_ids: Optional[Sequence] = None,
                     chunk: int = 357, device="cuda") -> List[Tuple]:
    """Word-level entries: a word's embedding from its tokens' windows, and
    with `sd_ids` the SD speaker id with the most attention under it."""
    u_tok = list(hyp["utteranceTokens"])
    att = np.asarray(hyp["attention"], np.float32)
    cs = np.asarray(hyp["chunkStart"], np.int64)
    sid = hyp.get("speakerId")
    role = (role_map or {}).get(sid, "subject")
    out = []
    for a, b in token_word_groups(tokenizer, u_tok):
        word = tokenizer.decode(u_tok[a:b]).strip()
        if not word:
            continue
        emb = _window_embed(att[a:b], cs[a:b], sd_features, device)
        word_sid = sid
        if sd_ids is not None:
            weights: Dict = defaultdict(float)
            ids = np.asarray(sd_ids)
            for t in range(a, b):
                lo = int(cs[t])
                hi = min(lo + chunk, len(ids))
                for wi, s in zip(att[t, :hi - lo], ids[lo:hi]):
                    weights[int(s)] += float(wi)
            if weights:
                word_sid = max(weights.items(), key=lambda kv: kv[1])[0]
        out.append((word, (emb, word_sid), role))
    return out


def ref_utterance_entry(ref: dict, role_map: Optional[dict] = None) -> Tuple:
    role = ref.get("role") or (role_map or {}).get(ref.get("speaker"), "subject")
    return (ref["utterance"], ref.get("speaker"), role)


def convert_results(results: Sequence[Tuple[List[dict], List[dict]]],
                    role_map: Optional[dict] = None,
                    sd_features: Optional[np.ndarray] = None,
                    sd_ids: Optional[Sequence] = None, word_level: bool = False,
                    tokenizer=None, chunk: int = 357, device="cuda"):
    """(ref_utts, hyp_utts) pairs -> wder-ready pairs."""
    out = []
    for refs, hyps in results:
        hyp_entries: List[Tuple] = []
        for h in hyps:
            if word_level and sd_features is not None and "utteranceTokens" in h:
                hyp_entries.extend(hyp_word_entries(h, tokenizer, role_map, sd_features,
                                                    sd_ids, chunk, device))
            else:
                hyp_entries.append(hyp_utterance_entry(h, role_map, sd_features, chunk,
                                                       device))
        out.append(([ref_utterance_entry(r, role_map) for r in refs], hyp_entries))
    return out


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
