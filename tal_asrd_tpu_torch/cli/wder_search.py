"""WDER clustering grid-search CLI.

    python -m tal_asrd_tpu_torch.cli.wder_search --eval-file wder_ready.pkl \
        [--mean] [--lower-no-punct] [--embed-head HEAD] [--role-based \
        --role-map MAP.json] [--workers 8] [--out-tsv out/wder_search.tsv] \
        [--device cuda]

Counterpart of tal_asrd_tpu/cli/wder_search.py with the same flags plus
--device: scores every parameter set of `default_param_grid()` over the
speaker embeddings (engines, metrics, PCA), prints the per-set WDER with its
role attributions and writes them, sorted by WDER, to a TSV. The Bayesian
GMM draws from RandomState(2020) in segment order at --workers 1; with more
workers segment i draws from RandomState(2020 + i) (ROADMAP C21).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from tal_asrd_tpu_torch.eval.wder_search import (
    apply_embed_head,
    corpus_wder_map,
    default_param_grid,
    mean_utterance_embeddings,
    normalize_lower_no_punct,
)
from tal_asrd_tpu_torch.utils.wordtok import tweet_tokenize, word_tokenize


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("WDER grid search")
    p.add_argument("--eval-file", type=str, required=True)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--tokenizer", choices=["punkt", "tweet"], default="punkt")
    p.add_argument("--mean", action="store_true", default=False,
                   help="average per-utterance token embeddings")
    p.add_argument("--lower-no-punct", action="store_true", default=False)
    p.add_argument("--embed-head", type=str, default=None,
                   help="trained contrastive metric head; maps embeddings through "
                        "it before clustering")
    p.add_argument("--role-based", action="store_true", default=False)
    p.add_argument("--role-map", type=str, default=None)
    p.add_argument("--out-tsv", type=str, default="out/wder_search.tsv")
    p.add_argument("--device", default="cuda",
                   help="where the metric head and the cosine distances run")
    return p


def main(argv: Optional[List[str]] = None) -> list:
    args = get_parser().parse_args(argv)
    with open(args.eval_file, "rb") as f:
        paired = pickle.load(f)

    if args.mean:
        paired = [(r, mean_utterance_embeddings(h)) for r, h in paired]
    if args.embed_head:
        paired = apply_embed_head(paired, args.embed_head, args.device)
    if args.lower_no_punct:
        paired = [([(normalize_lower_no_punct(u), *rest) for u, *rest in r],
                   [(normalize_lower_no_punct(u), *rest) for u, *rest in h])
                  for r, h in paired]
    role_map = None
    if args.role_map:
        with open(args.role_map) as f:
            role_map = {int(k): v for k, v in json.load(f).items()}

    tok_fn = word_tokenize if args.tokenizer == "punkt" else tweet_tokenize
    rows = corpus_wder_map(paired, default_param_grid(), tokenizer=tok_fn,
                           workers=args.workers, role_based=args.role_based,
                           role_map=role_map, verbose=True, device=args.device,
                           rng=np.random.RandomState(2020))
    os.makedirs(os.path.dirname(args.out_tsv) or ".", exist_ok=True)
    with open(args.out_tsv, "w") as f:
        f.write("params\twder\tclusters\tref_spk\twer\thost\tinterviewer\tsubject\n")
        for pset, *vals in rows:
            f.write(str(pset) + "\t" + "\t".join(f"{v:.4f}" for v in vals) + "\n")
    print(f"wrote {args.out_tsv}")
    return rows


if __name__ == "__main__":
    main()
