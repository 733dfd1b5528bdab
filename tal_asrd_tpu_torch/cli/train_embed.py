"""Contrastive embedding-head training CLI.

    python -m tal_asrd_tpu_torch.cli.train_embed --train-data OUT/spk.train.pkl \
        --valid-data OUT/spk.valid.pkl [--steps 2000] [--out out/embed_head.msgpack] \
        [--device cpu]

Counterpart of tal_asrd_tpu/cli/train_embed.py, with the same flags and
defaults plus --device (default cuda): n-way episodes from cli.gen_embed's
pickles (train seed 0, valid seed 1, 50 valid batches), --steps Adam steps
of the metric head (train/embed_system.py), then the head written as a flax
msgpack tree {"Dense_i": {"kernel", "bias"}}, which the JAX package's
`apply_embed_head` reads unchanged.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Dict, List, Optional

import numpy as np

from tal_asrd_tpu_torch.core.checkpoint import save_pytree
from tal_asrd_tpu_torch.train.embed_system import (
    ContrastiveCollator,
    ContrastiveDataset,
    EmbedSystem,
)

VALID_BATCHES = 50


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train-data", type=str, required=True,
                   help="spk.train.pkl from gen_embed")
    p.add_argument("--valid-data", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-way", type=int, default=6)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", type=str, default="out/embed_head.msgpack")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the head ('cpu' for a run without a GPU)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train and save the head. Returns {"losses", "accs" (per step),
    "train_acc" (the mean of the last 50 steps), "valid_loss", "valid_acc",
    "system"}."""
    args = get_parser().parse_args(argv)
    with open(args.train_data, "rb") as f:
        emb, ids = pickle.load(f)
    with open(args.valid_data, "rb") as f:
        v_emb, v_ids = pickle.load(f)

    ds = ContrastiveDataset(emb, ids, n_way=args.n_way,
                            epoch_len=args.steps * args.batch_size)
    vds = ContrastiveDataset(v_emb, v_ids, n_way=args.n_way,
                             epoch_len=VALID_BATCHES * args.batch_size, seed=1)
    coll = ContrastiveCollator()
    system = EmbedSystem(in_dim=emb.shape[1], lr=args.lr, batch_size=args.batch_size,
                         device=args.device)

    def batches(d, n):
        for i in range(n):
            yield coll([d[i * args.batch_size + j] for j in range(args.batch_size)])

    losses, accs = system.fit(batches(ds, args.steps))
    val_loss, val_acc = system.evaluate(batches(vds, VALID_BATCHES))
    train_acc = float(np.mean(accs[-50:]))
    print(f"train acc {train_acc:.3f} valid acc {val_acc:.3f}")
    save_pytree(args.out, system.params)
    return {"losses": losses, "accs": accs, "train_acc": train_acc,
            "valid_loss": val_loss, "valid_acc": val_acc, "system": system}


if __name__ == "__main__":
    main()
