"""Word-level forced alignment.

Counterpart of tal_asrd_tpu/align/forced.py (the reference's capability
target is aeneas: per-utterance word alignments [(begin_s, end_s,
word_ix)] merged into transcript-aligned.pkl, with a skip-if-present
resume). The aligner is model based:

  * the utterance's tokens are teacher-forced through the joint ASR model
    over the utterance audio (`ASRModel.encode`, K2 in its frontend, then
    the causal `decode`), and the cross-attention [layers, B, L, S] is
    averaged over layers;
  * DTW over the negative log attention (tokens x encoder frames, on the
    model's device: align/dtw.py) makes the token -> frame path monotonic;
  * tokens are grouped into words at decode boundaries; a word spans the
    frames of its tokens (the frame length is the utterance's duration over
    its encoder frames: 0.08 s for the production frontend).
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.align.dtw import monotonic_segmentation
from tal_asrd_tpu_torch.data.audio_io import DEFAULT_SR, load_audio_segment

ENC_FRAME_S = 0.08  # encoder output hop: 8 x 10 ms


def token_word_groups(tokenizer, token_ids: Sequence[int]) -> List[Tuple[int, int]]:
    """Group token indices into words at decode boundaries: token i opens a
    new word when appending it to the running slice introduces a space."""
    groups: List[Tuple[int, int]] = []
    last = 0
    ids = list(token_ids)
    for i in range(1, len(ids)):
        if " " in tokenizer.decode(ids[last : i + 1]):
            groups.append((last, i))
            last = i
    if last < len(ids):
        groups.append((last, len(ids)))
    return groups


@torch.no_grad()
def attention_alignment_matrix(model, audio: np.ndarray,
                               token_ids: Sequence[int]) -> np.ndarray:
    """[n_tokens, enc_frames] mean cross-attention under teacher forcing, on
    the model's device (float32 on the host)."""
    dev = next(model.parameters()).device
    toks = torch.tensor([list(token_ids)], dtype=torch.long, device=dev)
    x = torch.from_numpy(np.asarray(audio, np.float32)[None]).to(dev)
    enc = model.encode(x, torch.tensor([x.shape[1]], device=dev))
    _, attn = model.decode(toks, enc, True)
    return attn.to(torch.float32).mean(dim=0)[0].cpu().numpy()   # [L, S]


def align_utterance(model, tokenizer, audio: np.ndarray, text: str,
                    utterance_start_s: float = 0.0) -> List[Tuple[float, float, int]]:
    """Word alignments [(begin_s, end_s, word_ix)] for one utterance
    (absolute times offset by utterance_start_s; aeneas output contract)."""
    token_ids = tokenizer.encode(text, bos_token=False, eos_token=False)
    if not token_ids:
        return []
    attn = attention_alignment_matrix(model, audio, token_ids)
    # DTW over -log attention enforces a monotonic token->frame path
    cost = -np.log(attn + 1e-8)
    spans = monotonic_segmentation(cost, next(model.parameters()).device)
    groups = token_word_groups(tokenizer, token_ids)
    # encoder frame duration from the actual output grid
    frame_s = (len(audio) / DEFAULT_SR) / attn.shape[1]
    out = []
    for w_ix, (a, b) in enumerate(groups):
        f_start = spans[a][0]
        f_end = spans[b - 1][1]
        out.append((
            utterance_start_s + f_start * frame_s,
            utterance_start_s + f_end * frame_s,
            w_ix,
        ))
    return out


def align_episode(model, tokenizer, data_dir: str, stub: str, utterances: List[dict],
                  ext: str = ".wav", sample_rate: int = DEFAULT_SR,
                  max_utt_seconds: float = 30.0) -> List[dict]:
    """Align every utterance of an episode; returns dicts with an
    `alignments` key added (empty for an utterance longer than
    max_utt_seconds, or one whose alignment raised: that is printed and the
    episode goes on, as the reference's)."""
    path = os.path.join(data_dir, f"{stub}{ext}")
    out = []
    for utt in utterances:
        u = dict(utt)
        start, end = u["utterance_start"], u["utterance_end"]
        if end - start <= 0 or end - start > max_utt_seconds:
            u.setdefault("alignments", [])
            out.append(u)
            continue
        audio = load_audio_segment(path, start, end, sample_rate)
        try:
            u["alignments"] = align_utterance(model, tokenizer, audio, u["utterance"], start)
        except Exception as e:
            print(f"[align] {stub} utterance failed: {e}")
            u.setdefault("alignments", [])
        out.append(u)
    return out


def full_force_align(model, tokenizer, data_dir: str, out_path: Optional[str] = None,
                     ext: str = ".wav") -> dict:
    """Align a whole split, writing transcript-aligned.pkl after each
    episode; episodes already present in the output are skipped."""
    from tal_asrd_tpu_torch.data.transcript import load_transcripts

    out_path = out_path or os.path.join(data_dir, "transcript-aligned.pkl")
    done = {}
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            done = pickle.load(f)
    transcripts = load_transcripts(data_dir)
    for stub, utts in transcripts.items():
        if stub in done:
            continue
        done[stub] = align_episode(model, tokenizer, data_dir, stub, utts, ext)
        with open(out_path, "wb") as f:
            pickle.dump(done, f)
    return done
