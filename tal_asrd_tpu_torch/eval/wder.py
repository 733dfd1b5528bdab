"""WER / WDER metric core.

Counterpart of tal_asrd_tpu/eval/wder.py, without the clustering of speaker
embeddings (the embedding chain's clustering half, ROADMAP A16.2):
  * compute_sequence_match: count matrix + Hungarian assignment (scipy's
    linear_sum_assignment), the optimal speaker-label matching accuracy
    between two equal-length label sequences;
  * convert_to_wder_format: utterance list -> (word, relative speaker id)
    tuples, None speakers filled forward from the next known speaker;
  * calculate_wder: WDER = 1 - optimal assignment accuracy over the speaker
    pairs at substitution and equal word positions of the ref/hyp alignment
    (arXiv:1907.05337);
  * corpus_wder: corpus WDER = mean over segments, corpus WER = sum(dist) /
    sum(ref words). Segments are scored one after another, in order.
"""
from __future__ import annotations

from itertools import chain
from typing import Callable, List, Sequence, Tuple

import numpy as np
from scipy import optimize

from tal_asrd_tpu_torch.eval.editdist import eval_distance, opcodes
from tal_asrd_tpu_torch.utils.wordtok import word_tokenize


def compute_sequence_match(sequence1: list, sequence2: list):
    """Optimal matching accuracy between two label sequences."""
    if not isinstance(sequence1, list) or not isinstance(sequence2, list):
        raise TypeError("sequence1 and sequence2 must be lists")
    if not sequence1 or len(sequence1) != len(sequence2):
        raise ValueError("sequence1 and sequence2 must have the same non-zero length")
    uniq1 = sorted(set(sequence1))
    uniq2 = sorted(set(sequence2))
    inv1 = {u: i for i, u in enumerate(uniq1)}
    inv2 = {u: i for i, u in enumerate(uniq2)}
    count = np.zeros((len(uniq1), len(uniq2)))
    for x, y in zip(sequence1, sequence2):
        count[inv1[x], inv2[y]] += 1.0
    rows, cols = optimize.linear_sum_assignment(-count)
    accuracy = count[rows, cols].sum() / len(sequence1)
    return rows, cols, accuracy


def convert_to_wder_format(
    speaker_utterances: Sequence[Tuple],
    wer_only: bool,
    tokenizer: Callable[[str], List[str]] = word_tokenize,
):
    """Utterances -> ([(word, relative speaker id)], number of speakers).

    Inputs may be (text, speaker_id) or (text, (embedding, speaker_id)), each
    optionally carrying trailing fields (the role that convert_results
    adds), which are dropped. Speaker ids are numbered by first appearance.
    """
    if speaker_utterances and any(len(u) > 2 for u in speaker_utterances):
        speaker_utterances = [(u[0], u[1]) for u in speaker_utterances]
    if not wer_only and isinstance(speaker_utterances[0][-1], tuple):
        speaker_utterances = [(utt, sid) for utt, (_emb, sid) in speaker_utterances]

    # Fill None speakers forward from the next known one; -1 if none follows.
    filled = []
    for i, (u, s) in enumerate(speaker_utterances):
        cur = s
        if cur is None:
            for _, future in speaker_utterances[i + 1:]:
                if future is not None:
                    cur = future
                    break
        filled.append((u, -1 if cur is None else cur))

    all_speakers: List = []
    pairs: List[Tuple[str, int]] = []
    for u, speaker in filled:
        key = speaker.tobytes() if isinstance(speaker, np.ndarray) else speaker
        try:
            idx = all_speakers.index(key)
        except ValueError:
            idx = len(all_speakers)
            all_speakers.append(key)
        pairs.extend((w, idx) for w in tokenizer(u))
    return pairs, len(all_speakers)


def calculate_wder(seg_id, ref, hyp, wer_only: bool = False):
    """Core WDER. ref/hyp: [(word, speaker_id)]. Returns (wer, dist, n_ref,
    wder, ref_labels, hyp_labels); `seg_id` names the segment."""
    ref_words = [w for w, _ in ref]
    ref_spk = [s for _, s in ref]
    hyp_words = [w for w, _ in hyp]
    hyp_spk = [s for _, s in hyp]

    dist = eval_distance(ref_words, hyp_words)
    n_ref = len(ref_words)
    wer = dist / n_ref

    if wer_only:
        return wer, dist, n_ref, 1e8, None, None

    ops = opcodes(ref_words, hyp_words)
    sub_pairs = list(chain.from_iterable(
        zip(ref_spk[r0:r1], hyp_spk[h0:h1])
        for op, r0, r1, h0, h1 in ops if op == "replace"
    ))
    cor_pairs = list(chain.from_iterable(
        zip(ref_spk[r0:r1], hyp_spk[h0:h1])
        for op, r0, r1, h0, h1 in ops if op == "equal"
    ))
    all_pairs = sub_pairs + cor_pairs
    if not all_pairs:
        return wer, dist, n_ref, 1.0, None, None
    seq_r = [r for r, _ in all_pairs]
    seq_h = [h for _, h in all_pairs]
    ref_labels, hyp_labels, acc = compute_sequence_match(seq_r, seq_h)
    return wer, dist, n_ref, 1.0 - acc, ref_labels, hyp_labels


def wder_segment(seg_id, ref_us, hyp_us, wer_only, tokenizer=word_tokenize):
    """One segment: ([dist, n_ref], [ref_labels, hyp_labels], wder)."""
    ref, _ = convert_to_wder_format(ref_us, wer_only=True, tokenizer=tokenizer)
    hyp, _ = convert_to_wder_format(hyp_us, wer_only=wer_only, tokenizer=tokenizer)
    wer, dist, n_ref, wder, ref_labels, hyp_labels = calculate_wder(
        seg_id, ref, hyp, wer_only)
    return [dist, n_ref], [ref_labels, hyp_labels], wder


def corpus_wder(paired_results, wer_only: bool = False, tokenizer=word_tokenize,
                allow_degenerate: bool = False):
    """Corpus aggregation: mean WDER over segments, WER = sum(dist) /
    sum(ref words). Segments with an empty ref or hyp list are skipped, as
    the reference does. Returns (ref_labels per segment, hyp_labels per
    segment, overall_wder, dist per segment, ref words per segment,
    overall_wer)."""
    results = [
        wder_segment(i, ref_us, hyp_us, wer_only, tokenizer=tokenizer)
        for i, (ref_us, hyp_us) in enumerate(paired_results)
        if ref_us and hyp_us
    ]
    if not results:
        # Every segment was skipped: the hypothesis stream holds no complete
        # utterance. allow_degenerate scores the worst case instead.
        if allow_degenerate:
            print(f"corpus_wder: DEGENERATE — all {len(paired_results)} "
                  "segments skipped; scoring worst-case WER 100% / WDER 100%")
            return (), (), 1.0, [], 0, 1.0
        raise ValueError(
            f"corpus_wder: all {len(paired_results)} segments were skipped "
            "(empty ref or hyp utterance lists) — the hypothesis stream "
            "contains no complete utterances; nothing to score")
    wer_components, wder_components, wders = zip(*results)
    ref_spk_t, hyp_spk_t = zip(*wder_components)
    overall_wder = float(np.mean(wders))
    dist_t, n_words_t = zip(*wer_components)
    overall_wer = sum(dist_t) / sum(n_words_t)
    return ref_spk_t, hyp_spk_t, overall_wder, dist_t, n_words_t, overall_wer
