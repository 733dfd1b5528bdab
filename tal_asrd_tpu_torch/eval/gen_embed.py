"""Speaker-embedding export from a trained speaker-token model.

Counterpart of tal_asrd_tpu/eval/gen_embed.py: run the joint model teacher
forced over a split (`train=False`: no SpecAugment; the frontend's log-mel
projection is kernel K2 on the card) and, at every target position that
holds a speaker token, softmax the speaker-token slice of the logits in f32
and take the expectation over the speaker-token rows of the embedding
table:

    probs = softmax(logits[:, vocab:])                  # over speakers
    expected_embed = probs @ E[vocab:]                  # [n, embed_size]

saving (embeddings, speaker_ids) with an 80/20 train/valid split, as pickles
of numpy arrays that either package reads.
"""
from __future__ import annotations

import pickle
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.data.loader import to_device


def speaker_posteriors(model, audio: torch.Tensor, audio_lens: torch.Tensor,
                       text: torch.Tensor):
    """Teacher-forced forward of `model` (an ASRModel) on text [B, L]:
    (probs [B, L-1, num_speakers] f32 — the softmax over the speaker
    tokens' logits at each target position — speaker_mask [B, L-1], true
    where the target is a speaker token, speaker_ids [B, L-1], the target's
    speaker index or -1)."""
    vocab = model.cfg.vocab_size
    y_prev, y_target = text[:, :-1], text[:, 1:]
    (logits, _), _ = model(audio, y_prev, audio_lens, train=False)
    probs = torch.softmax(logits[..., vocab:].to(torch.float32), dim=-1)
    speaker_mask = y_target >= vocab
    speaker_ids = torch.where(speaker_mask, y_target - vocab, torch.full_like(y_target, -1))
    return probs, speaker_mask, speaker_ids


def make_embed_fn(model) -> Callable:
    """(audio [B, T], audio_lens [B], text [B, L]) on the model's device ->
    (expected [B, L-1, E] f32, speaker_mask [B, L-1], speaker_ids [B, L-1])."""

    def batch_embeddings(audio, audio_lens, text):
        with torch.inference_mode():
            probs, speaker_mask, speaker_ids = speaker_posteriors(model, audio, audio_lens,
                                                                  text)
            rows = model.speaker_rows().to(torch.float32)
            return probs @ rows, speaker_mask, speaker_ids

    return batch_embeddings


def generate_speaker_embeddings(model, batches: Iterable) -> Tuple[np.ndarray, np.ndarray]:
    """Collect (embeddings [N, E] float32, speaker_ids [N] int32) over the
    speaker-token positions of all batches (dicts of numpy arrays, as the
    DataLoader yields them), in order; padded positions are excluded."""
    fn = make_embed_fn(model)
    device = next(model.parameters()).device
    embs, sids = [], []
    for batch in batches:
        t = to_device({k: batch[k] for k in ("audio", "audio_lens", "text")}, device)
        expected, mask, ids = fn(t["audio"], t["audio_lens"], t["text"].to(torch.long))
        mask = mask.cpu().numpy() & np.asarray(batch["text_mask"])[:, 1:]
        embs.append(expected.cpu().numpy()[mask])
        sids.append(ids.cpu().numpy()[mask].astype(np.int32))
    return np.concatenate(embs, axis=0), np.concatenate(sids, axis=0)


def save_split(embeddings: np.ndarray, speaker_ids: np.ndarray,
               out_path: str, train_frac: float = 0.8) -> None:
    """The first `train_frac` of the rows to OUT.train.pkl, the rest to
    OUT.valid.pkl, each a pickled (embeddings, speaker_ids) tuple."""
    n_train = int(len(embeddings) * train_frac)
    with open(out_path + ".train.pkl", "wb") as f:
        pickle.dump((embeddings[:n_train], speaker_ids[:n_train]), f)
    with open(out_path + ".valid.pkl", "wb") as f:
        pickle.dump((embeddings[n_train:], speaker_ids[n_train:]), f)
