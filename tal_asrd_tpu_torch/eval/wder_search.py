"""WDER grid search with role attribution.

Counterpart of tal_asrd_tpu/eval/wder_search.py:
  * get_word_speakers: utterances -> (words, relative speaker ids, roles),
    None speakers filled forward, embeddings keyed by value so that each
    unique embedding is clustered once;
  * get_wder: WDER over the substitution and equal positions of the
    alignment with the optimal assignment, the errors attributed to the
    reference roles host / interviewer / subject, and the two counts
    cross-checked;
  * wder_segment_grid: a segment's edits computed once, then every
    clustering parameter set scored against them;
  * corpus_wder_map: per-parameter-set means over segments (in spawned
    processes when workers > 1), sorted by WDER;
  * default_param_grid: id / gmm / hdbscan / dbscan / agglomerative x
    {euclidean, cos_dist} x PCA {None, 16};
  * mean_utterance_embeddings (--mean), normalize_lower_no_punct,
    apply_embed_head (the contrastive metric head, on `device`, one batch a
    segment) and majority_vote_token_clusters.
"""
from __future__ import annotations

import functools
import re
from collections import defaultdict
from itertools import chain
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tal_asrd_tpu_torch.eval.clustering import cluster_embeddings
from tal_asrd_tpu_torch.eval.editdist import eval_distance, opcodes
from tal_asrd_tpu_torch.eval.wder import compute_sequence_match, segments_in_order
from tal_asrd_tpu_torch.utils.wordtok import word_tokenize

ROLES = ("host", "interviewer", "subject")


def normalize_lower_no_punct(text: str) -> str:
    """LibriSpeech-style normalisation: lower case, [a-z0-9' ] only."""
    return re.sub(r"[^a-z0-9' ]+", "", text.lower())


def get_word_speakers(
    speaker_utterances: Sequence[Tuple],
    embeddings: bool = False,
    is_ref: bool = False,
    role_based: bool = False,
    role_map: Optional[dict] = None,
    tokenizer: Callable = word_tokenize,
):
    """Returns (words, speaker_ids, roles, n_speakers, speaker_table)."""
    raw_u, raw_s, raw_r = zip(*speaker_utterances)
    if not is_ref:
        raw_speakers = [x[0 if embeddings else 1] if isinstance(x, tuple) else None
                        for x in raw_s]
        filled = []
        for i, x in enumerate(raw_speakers):
            cur = x
            if cur is None:
                for future in raw_speakers[i + 1:]:
                    if future is not None:
                        cur = future
                        break
            if cur is None:
                if embeddings:
                    prev = next((f for f in filled if isinstance(f, np.ndarray)), None)
                    cur = np.zeros(len(prev)) if prev is not None else np.zeros(1)
                else:
                    cur = -1
            filled.append(cur)
        raw_s = filled
        if role_based:
            raw_r = [role_map.get(s) if role_map else None for s in raw_s]

    all_speakers: List = []
    words: List[str] = []
    speaker_ids: List[int] = []
    roles: List = []
    for u, speaker, role in zip(raw_u, raw_s, raw_r):
        if isinstance(speaker, (str, int, np.integer)):
            key = speaker
        else:
            arr = np.asarray(speaker)
            key = (tuple(arr.flatten()), arr.shape)
        try:
            sid = all_speakers.index(key)
        except ValueError:
            sid = len(all_speakers)
            all_speakers.append(key)
        u_words = tokenizer(u)
        words.extend(u_words)
        speaker_ids.extend([sid] * len(u_words))
        roles.extend([role] * len(u_words))
    return words, speaker_ids, roles, len(all_speakers), all_speakers


def get_wder_edits(ref_words: list, hyp_words: list):
    """[r0, r1, h0, h1] of the substitution and equal opcode spans."""
    return [[r0, r1, h0, h1] for op, r0, r1, h0, h1 in opcodes(ref_words, hyp_words)
            if op in ("replace", "equal")]


def get_wder(edits, ref_spk, hyp_spk, ref_roles, optimize_assignments=True):
    """(WDER, {role: share of the errors})."""
    edit_rvh = list(chain.from_iterable(
        zip(ref_spk[r0:r1], hyp_spk[h0:h1], ref_roles[r0:r1])
        for r0, r1, h0, h1 in edits))
    if not edit_rvh:
        return 0.0, {r: 0.0 for r in ROLES}
    edit_r, edit_h, edit_roles = map(list, zip(*edit_rvh))
    attributions = {r: 0 for r in ROLES}
    wder_val = 0
    if optimize_assignments:
        r_reindex = {v: i for i, v in enumerate(sorted(set(edit_r)))}
        h_reindex = {v: i for i, v in enumerate(sorted(set(edit_h)))}
        edit_r = [r_reindex[r] for r in edit_r]
        edit_h = [h_reindex[h] for h in edit_h]
        ref_labels, hyp_labels, acc = compute_sequence_match(edit_r, edit_h)
        ref_map = dict(zip(ref_labels, range(len(ref_labels))))
        hyp_map = dict(zip(hyp_labels, range(len(hyp_labels))))
        for r, h, role in zip(edit_r, edit_h, edit_roles):
            if ref_map.get(r) != hyp_map.get(h):
                wder_val += 1
                if role in attributions:
                    attributions[role] += 1
        wder = 1 - acc
        assert abs(wder_val / len(edit_r) - wder) <= 1e-6, (wder_val, wder)
    else:
        for r, h, role in zip(edit_r, edit_h, edit_roles):
            if r != h:
                wder_val += 1
                if role in attributions:
                    attributions[role] += 1
    total_err = max(wder_val, 1)
    attributions = {k: v / total_err for k, v in attributions.items()}
    return wder_val / len(edit_r), attributions


def _unkey_embeddings(table):
    out = []
    for key in table:
        if isinstance(key, tuple) and len(key) == 2 and isinstance(key[1], tuple):
            out.append(np.asarray(key[0]).reshape(key[1]))
        else:
            out.append(key)
    return out


def cluster_param_labels(speaker_table, param_set, device="cuda",
                         rng: Optional[np.random.RandomState] = None):
    """One clustering parameter set over the unique speaker embeddings.
    param_set: ('id',) or (method, *method_params, pca_dims, metric)."""
    method = param_set[0]
    if method == "id":
        return None
    method_params = param_set[1:-2]
    pca_dims, metric = param_set[-2], param_set[-1]
    embeddings = _unkey_embeddings(speaker_table)
    kwargs = {}
    if method == "hdbscan":
        kwargs = {"min_cluster_size": method_params[0], "min_samples": method_params[1]}
    elif method == "dbscan":
        kwargs = {"eps": method_params[0], "min_samples": method_params[1]}
    elif method == "agg":
        kwargs = {"n_clusters": None, "linkage": method_params[0],
                  "distance_threshold": method_params[1]}
        method = "agglomerative"
    elif method == "gmm":
        kwargs = {"n_components": min(100, len(embeddings)), "max_iter": 400,
                  "weight_concentration_prior": method_params[0]}
    return cluster_embeddings(np.asarray(embeddings), method=method, metric=metric,
                              pca_dims=pca_dims, device=device, rng=rng, **kwargs)


def wder_segment_grid(
    seg_id,
    ref_us,
    hyp_us,
    cluster_params: Sequence[Tuple],
    tokenizer: Callable = word_tokenize,
    role_based: bool = False,
    role_map: Optional[dict] = None,
    verbose: bool = False,
    device="cuda",
    rng: Optional[np.random.RandomState] = None,
) -> Dict[Tuple, Tuple]:
    """One segment under every parameter set: {param_set: (wder, n_clusters,
    n_ref_speakers, wer, attributions)}."""
    ref_words, ref_spk, ref_roles, n_ref_spk, _ = get_word_speakers(
        ref_us, embeddings=False, is_ref=True, tokenizer=tokenizer)
    _, hyp_ids, hyp_roles, _, _ = get_word_speakers(
        hyp_us, embeddings=False, is_ref=False, role_based=role_based,
        role_map=role_map, tokenizer=tokenizer)
    hyp_words, hyp_spk, _, _, hyp_spk_table = get_word_speakers(
        hyp_us, embeddings=True, is_ref=False, tokenizer=tokenizer)

    dist = eval_distance(ref_words, hyp_words)
    wer = dist / max(len(ref_words), 1)
    edits = get_wder_edits(ref_words, hyp_words)

    results = {}
    for param_set in cluster_params:
        if param_set[0] == "id":
            hyp_mapped = hyp_ids
            n_clusters = len(set(hyp_ids))
        else:
            labels = cluster_param_labels(hyp_spk_table, param_set, device, rng)
            n_clusters = len(set(labels))
            hyp_mapped = [int(labels[i]) for i in hyp_spk]
        if role_based:
            wder, attributions = get_wder(edits, ref_roles, hyp_roles, ref_roles,
                                          optimize_assignments=False)
        else:
            wder, attributions = get_wder(edits, ref_spk, hyp_mapped, ref_roles)
        if verbose:
            print(f"{seg_id} {param_set}: WDER {wder*100:.2f} ({n_clusters} clusters)")
        results[param_set] = (wder, n_clusters, n_ref_spk, wer, attributions)
    return results


def corpus_wder_map(
    paired_results,
    cluster_params: Sequence[Tuple],
    tokenizer: Callable = word_tokenize,
    workers: int = 1,
    role_based: bool = False,
    role_map: Optional[dict] = None,
    verbose: bool = False,
    device="cuda",
    rng: Optional[np.random.RandomState] = None,
):
    """Per-parameter-set corpus means: [(param_set, wder, clusters, ref
    speakers, wer, host, interviewer, subject)] sorted by WDER. One `rng`
    serves every segment in order at workers 1; at workers > 1 segment i
    draws from RandomState(2020 + i) (ROADMAP C21)."""
    jobs = [(i, r, h) for i, (r, h) in enumerate(paired_results) if r and h]
    fn = functools.partial(wder_segment_grid, cluster_params=cluster_params,
                           tokenizer=tokenizer, role_based=role_based, role_map=role_map,
                           device=device, **({"rng": rng} if workers <= 1 else {}))
    dicts = segments_in_order(fn, jobs, workers, seeded=True)

    agg = defaultdict(lambda: defaultdict(list))
    for d in dicts:
        for pset, (wder, ncl, nref, wer, attr) in d.items():
            agg[pset]["wder"].append(wder)
            agg[pset]["ncl"].append(ncl)
            agg[pset]["nref"].append(nref)
            agg[pset]["wer"].append(wer)
            for role in ROLES:
                agg[pset][role].append(attr[role])

    rows = [(pset, float(np.mean(v["wder"])), float(np.mean(v["ncl"])),
             float(np.mean(v["nref"])), float(np.mean(v["wer"])),
             float(np.mean(v["host"])), float(np.mean(v["interviewer"])),
             float(np.mean(v["subject"])))
            for pset, v in agg.items()]
    rows.sort(key=lambda x: x[1])
    if verbose:
        for pset, wder, ncl, nref, wer, hp, ip, sp in rows:
            print(f"{str(pset):50s} WDER {wder*100:.2f} WER {wer*100:.2f} "
                  f"clusters {ncl:.1f} [H {hp*100:.1f} I {ip*100:.1f} S {sp*100:.1f}]")
    return rows


def default_param_grid(
    metrics: Sequence[str] = ("euclidean", "cos_dist"),
    pca_dims: Sequence[Optional[int]] = (None, 16),
) -> List[Tuple]:
    """The default grid of parameter sets."""
    grid: List[Tuple] = [("id",)]
    for metric in metrics:
        for pca in pca_dims:
            for mcs in (2, 5):
                grid.append(("hdbscan", mcs, 2, pca, metric))
            for eps in (0.3, 0.5):
                grid.append(("dbscan", eps, 2, pca, metric))
            for thresh in (0.5, 1.0):
                grid.append(("agg", "average", thresh, pca, metric))
            grid.append(("gmm", 1.0, pca, metric))
    return grid


# --- embedding-variant helpers ------------------------------------------------------

def mean_utterance_embeddings(hyp_us):
    """--mean: an utterance's token embeddings averaged; trailing fields kept."""
    out = []
    for utt, spk, *rest in hyp_us:
        if isinstance(spk, tuple):
            emb, sid = spk
            if emb is not None and np.asarray(emb).ndim == 2:
                emb = np.asarray(emb).mean(axis=0)
            out.append((utt, (emb, sid), *rest))
        else:
            out.append((utt, spk, *rest))
    return out


def apply_embed_head(paired_results, head_path: str, device="cuda"):
    """Every hyp utterance embedding mapped through the trained metric head
    (cli.train_embed's flax tree, read by core/checkpoint.py) before
    clustering: a segment's embeddings in one batch on `device`. Entries
    without an embedding pass through unchanged."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.train.embed_system import EmbedMLP

    params = load_pytree(head_path)
    k0, k2 = params["Dense_0"]["kernel"], params["Dense_2"]["kernel"]
    model = EmbedMLP(k0.shape[0], k0.shape[1], k2.shape[1], generator=torch.Generator())
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1", "Dense_2"):
            layer = getattr(model, name)
            layer.weight.copy_(torch.tensor(np.asarray(params[name]["kernel"], np.float32).T))
            layer.bias.copy_(torch.tensor(np.asarray(params[name]["bias"], np.float32)))
    model = model.to(device).eval()

    def mapped(x):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                return model(torch.from_numpy(x).to(device)).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    out = []
    for ref_us, hyp_us in paired_results:
        rows = [i for i, (_, spk, *_) in enumerate(hyp_us)
                if isinstance(spk, tuple) and spk[0] is not None]
        embs = [np.asarray(hyp_us[i][1][0], np.float32) for i in rows]
        if embs and all(e.shape == embs[0].shape and e.ndim == 1 for e in embs):
            heads = list(mapped(np.stack(embs)))
        else:   # token embeddings ([T, D] an utterance): one call each
            heads = [mapped(e[None])[0] for e in embs]
        new = list(hyp_us)
        for i, head in zip(rows, heads):
            utt, spk, *rest = hyp_us[i]
            new[i] = (utt, (head, spk[1]), *rest)
        out.append((ref_us, new))
    return out


def majority_vote_token_clusters(token_labels: Sequence[int],
                                 token_counts: Sequence[int]) -> List[int]:
    """Per-utterance majority vote over per-token cluster labels."""
    out = []
    pos = 0
    for n in token_counts:
        seg = list(token_labels[pos:pos + n])
        pos += n
        if not seg:
            out.append(-1)
            continue
        vals, counts = np.unique(seg, return_counts=True)
        out.append(int(vals[np.argmax(counts)]))
    return out
