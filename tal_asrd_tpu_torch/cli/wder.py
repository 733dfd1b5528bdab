"""WER / WDER scoring CLI.

    python -m tal_asrd_tpu_torch.cli.wder --eval-file wder_ready.pkl \
        [--cluster --cluster-method agglomerative --metric cos_dist] \
        [--embed-head HEAD] [--grid-search] [--workers 16] [--device cuda]

Counterpart of tal_asrd_tpu/cli/wder.py with the same flags plus --device:
reads a pickle of (ref_utterances, hyp_utterances) pairs, prints per-segment
and corpus WDER / WER and writes `<stub>-wder.pkl` beside it (ref_speakers,
hyp_speakers, overall_wder, dist, n_words, overall_wer). With --cluster the
hyp speakers are the clusters of the utterance embeddings (mapped through
the metric head with --embed-head); the Bayesian GMM draws from
RandomState(2020), as the reference's run after np.random.seed(2020).
--grid-search draws min_cluster_size and min_samples from RandomState(0)
(--n-calls times) and keeps the best.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np

from tal_asrd_tpu_torch.eval.clustering import make_cluster_fn
from tal_asrd_tpu_torch.eval.wder import corpus_wder
from tal_asrd_tpu_torch.utils.wordtok import tweet_tokenize, word_tokenize


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("WDER calculation")
    p.add_argument("--eval-file", type=str, required=True)
    p.add_argument("--wer-only", action="store_true", default=False)
    p.add_argument("--tokenizer", choices=["punkt", "tweet"], default="punkt")
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--cluster", action="store_true", default=False)
    p.add_argument("--metric", choices=["euclidean", "cos_sim", "cos_dist", "idp", "ndp"],
                   default="euclidean")
    p.add_argument("--cluster-method", default="hdbscan",
                   choices=["hdbscan", "dbscan", "agglomerative", "gmm"])
    p.add_argument("--embed-head", type=str, default=None,
                   help="trained contrastive metric head (cli.train_embed output); "
                        "maps the utterance embeddings through it before clustering")
    p.add_argument("--grid-search", action="store_true", default=False,
                   help="seeded random search over min_cluster_size / min_samples")
    p.add_argument("--n-calls", type=int, default=10)
    p.add_argument("--allow-degenerate", action="store_true", default=False,
                   help="score worst-case (WER/WDER 100%%) instead of erroring when "
                        "EVERY segment is skipped")
    p.add_argument("--device", default="cuda",
                   help="where the metric head and the cosine distances run")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    rng = np.random.RandomState(2020)

    with open(args.eval_file, "rb") as f:
        paired_results = pickle.load(f)
    print(f"{len(paired_results):,} test pairs loaded from {args.eval_file}")

    if args.embed_head:
        from tal_asrd_tpu_torch.eval.wder_search import apply_embed_head

        paired_results = apply_embed_head(paired_results, args.embed_head, args.device)
        print(f"applied metric head {args.embed_head} to hyp embeddings")

    tok_fn = word_tokenize if args.tokenizer == "punkt" else tweet_tokenize

    if args.grid_search and args.cluster:
        search = np.random.RandomState(0)
        best = (None, float("inf"), None)
        for call in range(args.n_calls):
            params = {"min_cluster_size": int(search.randint(2, 11)),
                      "min_samples": int(search.randint(2, 11))}
            fn = make_cluster_fn(args.cluster_method, metric=args.metric,
                                 device=args.device, rng=rng, **params)
            out = corpus_wder(paired_results, wer_only=args.wer_only, workers=args.workers,
                              should_cluster=True, cluster_fn=fn, tokenizer=tok_fn)
            wder = out[2]
            print(f"call {call}: {params} -> WDER {wder*100:.3f}%")
            if wder < best[1]:
                best = (params, wder, out)
        print(f"best: {best[0]} WDER {best[1]*100:.3f}%")
        outputs = best[2]
    else:
        cluster_fn = (make_cluster_fn(args.cluster_method, metric=args.metric,
                                      device=args.device, rng=rng)
                      if args.cluster else None)
        outputs = corpus_wder(paired_results, wer_only=args.wer_only, workers=args.workers,
                              should_cluster=args.cluster, cluster_fn=cluster_fn,
                              tokenizer=tok_fn, verbose=True,
                              allow_degenerate=args.allow_degenerate)
    stub = os.path.basename(args.eval_file).split(".", 1)[0]
    out = os.path.join(os.path.dirname(args.eval_file), f"{stub}-wder.pkl")
    ref_spk, hyp_spk, overall_wder, dist, n_words, overall_wer = outputs
    fields = {"ref_speakers": ref_spk, "hyp_speakers": hyp_spk,
              "overall_wder": overall_wder, "dist": dist, "n_words": n_words,
              "overall_wer": overall_wer}
    with open(out, "wb") as f:
        pickle.dump(fields, f)
    print(f"Dumped metrics to {out}")
    return fields


if __name__ == "__main__":
    main()
