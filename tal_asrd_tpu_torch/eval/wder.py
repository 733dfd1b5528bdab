"""WER / WDER metric core.

Counterpart of tal_asrd_tpu/eval/wder.py:
  * compute_sequence_match: count matrix + Hungarian assignment (scipy's
    linear_sum_assignment), the optimal speaker-label matching accuracy
    between two equal-length label sequences;
  * convert_to_wder_format: utterance list -> (word, relative speaker id)
    tuples, None speakers filled forward from the next known speaker, and
    optionally the speaker embeddings clustered (eval/clustering.py);
  * calculate_wder: WDER = 1 - optimal assignment accuracy over the speaker
    pairs at substitution and equal word positions of the ref/hyp alignment
    (arXiv:1907.05337);
  * corpus_wder: corpus WDER = mean over segments, corpus WER = sum(dist) /
    sum(ref words). Segments are scored in order, in a pool of spawned
    processes when workers > 1.
"""
from __future__ import annotations

import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from itertools import chain
from typing import Callable, List, Optional, Sequence, Tuple

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
    should_cluster: bool = False,
    cluster_fn: Optional[Callable] = None,
    **cluster_kwargs,
):
    """Utterances -> ([(word, relative speaker id)], number of speakers).

    Inputs may be (text, speaker_id), (text, (embedding, speaker_id)) or
    (text, embedding), each optionally carrying trailing fields (the role
    that convert_results adds), which are dropped. With `should_cluster`
    the embeddings are clustered by `cluster_fn(embeddings,
    **cluster_kwargs)` and the labels are the speakers. Speakers are
    numbered by first appearance.
    """
    if speaker_utterances and any(len(u) > 2 for u in speaker_utterances):
        speaker_utterances = [(u[0], u[1]) for u in speaker_utterances]
    to_cluster = True
    if wer_only:
        to_cluster = False
    elif isinstance(speaker_utterances[0][-1], tuple):
        speaker_utterances = [(utt, emb if should_cluster else sid)
                              for utt, (emb, sid) in speaker_utterances]
        to_cluster = should_cluster
    elif isinstance(speaker_utterances[0][-1], (int, str, type(None))):
        to_cluster = False

    # Fill None speakers forward from the next known one; where none
    # follows, -1, or a zero embedding as wide as the first filled one.
    filled = []
    for i, (u, s) in enumerate(speaker_utterances):
        cur = s
        if cur is None:
            for _, future in speaker_utterances[i + 1:]:
                if future is not None:
                    cur = future
                    break
        if cur is None:
            if to_cluster:
                cur = np.zeros(len(filled[0][1]) if filled else 1)
            else:
                cur = -1
        filled.append((u, cur))

    if to_cluster:
        assert cluster_fn is not None, "clustering requested without cluster_fn"
        labels = cluster_fn([s for _, s in filled], **cluster_kwargs)
        filled = [(u, int(labels[i])) for i, (u, _) in enumerate(filled)]

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


def calculate_wer(ref, hyp):
    """(wer, distance, n_ref_words) of two [(word, speaker)] lists."""
    ref_words = [w for w, _ in ref]
    dist = eval_distance(ref_words, [w for w, _ in hyp])
    return dist / len(ref_words), dist, len(ref_words)


def calculate_wder(seg_id, ref, hyp, wer_only: bool = False, verbose: bool = False):
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
    wder = 1.0 - acc
    if verbose:
        print(f"{seg_id} - {len(set(hyp_spk))} hyp speakers, WDER: {wder*100:.2f}")
    return wer, dist, n_ref, wder, ref_labels, hyp_labels


def wder_segment(seg_id, ref_us, hyp_us, wer_only, should_cluster: bool = False,
                 cluster_fn=None, tokenizer=word_tokenize, **kwargs):
    """One segment: ([dist, n_ref], [ref_labels, hyp_labels], wder)."""
    ref, _ = convert_to_wder_format(ref_us, wer_only=True, tokenizer=tokenizer)
    hyp, _ = convert_to_wder_format(hyp_us, wer_only=wer_only, tokenizer=tokenizer,
                                    should_cluster=should_cluster,
                                    cluster_fn=cluster_fn, **kwargs)
    wer, dist, n_ref, wder, ref_labels, hyp_labels = calculate_wder(
        seg_id, ref, hyp, wer_only)
    return [dist, n_ref], [ref_labels, hyp_labels], wder


def segments_in_order(fn, jobs, workers: int, seeded: bool = False):
    """[fn(*job) for job in jobs], in `workers` spawned processes when
    workers > 1. With `seeded`, a job's clustering draws from
    RandomState(2020 + its segment index) in the processes (ROADMAP C21)."""
    if workers <= 1:
        return [fn(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(fn, *job, **(
            {"rng": np.random.RandomState(2020 + job[0])} if seeded else {}))
            for job in jobs]
        return [f.result() for f in futures]


def corpus_wder(paired_results, wer_only: bool = False, workers: int = 1,
                should_cluster: bool = False, cluster_fn=None,
                tokenizer=word_tokenize, verbose: bool = False,
                allow_degenerate: bool = False, **kwargs):
    """Corpus aggregation: mean WDER over segments, WER = sum(dist) /
    sum(ref words). Segments with an empty ref or hyp list are skipped, as
    the reference does; `workers` > 1 scores them in that many processes,
    in segment order. Returns (ref_labels per segment, hyp_labels per
    segment, overall_wder, dist per segment, ref words per segment,
    overall_wer)."""
    jobs = [(i, ref_us, hyp_us) for i, (ref_us, hyp_us) in enumerate(paired_results)
            if ref_us and hyp_us]
    results = segments_in_order(
        functools.partial(wder_segment, wer_only=wer_only, should_cluster=should_cluster,
                          cluster_fn=cluster_fn, tokenizer=tokenizer, **kwargs),
        jobs, workers, seeded=should_cluster)
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
    if verbose:
        print(f"Overall WDER: {100*overall_wder:.3f}%")
        print(f"Overall WER: {100*overall_wer:.3f}%")
    return ref_spk_t, hyp_spk_t, overall_wder, dist_t, n_words_t, overall_wer
