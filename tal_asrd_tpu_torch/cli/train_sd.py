"""Training CLI of the separate speaker-diarization baseline.

    python -m tal_asrd_tpu_torch.cli.train_sd --train-data D --valid-data D \
        --name sd [--num-speakers 6008] [--batch-size 64] [--max-secs 20] \
        [--max-steps N] [--checkpoint-path models/tal-asrd-tpu] [--device cpu]

Counterpart of tal_asrd_tpu/cli/train_sd.py, with its flags (plus --device,
default cuda): SDModel trained on single-utterance speaker-ID samples
(data/baseline_speaker.py, utterances of 3 s up to --max-secs) by
baseline/sd_system.py's LAMB at lr * sqrt(batch), decayed linearly over
--max-steps when that is given. Kept as the reference has them:
--valid-data is required and never read; only the first --train-data is
used; --num-speakers sizes the classifier whatever the speaker map holds;
--quick-test stops after one step; the parameters are saved once an epoch
as CHECKPOINT_PATH/NAME/ckpt_<step>.msgpack (flax names, `latest.json`
holding the epoch); a line is printed every 50 steps.

The initial parameters are the port's own draw (SDModel.reset_parameters
from a CPU generator seeded 0): the reference's PRNGKey(0) draws come from
jax.random and cannot be reproduced here. The sampler shuffles as the
reference's (numpy, seed + epoch).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from tal_asrd_tpu_torch.baseline import SDSystem
from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager
from tal_asrd_tpu_torch.core.config import SDModelConfig, TrainConfig
from tal_asrd_tpu_torch.data import DataLoader, SDCollater, SDUtteranceDataset, ShardedSampler

LOG_EVERY = 50


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train-data", type=str, action="append", required=True)
    p.add_argument("--valid-data", type=str, action="append", required=True)
    p.add_argument("--num-speakers", type=int, default=6008)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-secs", type=float, default=20)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--checkpoint-path", type=str, default="./models/tal-asrd-tpu")
    p.add_argument("--quick-test", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains (cuda or cpu)")
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns {"system": the SDSystem, "losses": every step's loss,
    "steps": steps taken, "paths": the checkpoints written}."""
    args = get_parser().parse_args(argv)
    cfg = SDModelConfig(num_speakers=args.num_speakers)
    tc = TrainConfig(batch_size=args.batch_size, lr=args.lr, max_steps=args.max_steps)
    system = SDSystem(cfg, tc, device=args.device,
                      generator=torch.Generator().manual_seed(0))

    ds = SDUtteranceDataset(
        args.train_data[0],
        speaker_map_loc=os.path.join(args.train_data[0], "speaker_map.json"),
        max_segment_duration=args.max_secs,
    )
    loader = DataLoader(ds, args.batch_size, SDCollater(),
                        ShardedSampler(len(ds), shuffle=True), args.num_workers)
    mgr = CheckpointManager(os.path.join(args.checkpoint_path, args.name))

    def done() -> bool:
        return bool(args.quick_test or (args.max_steps and n >= args.max_steps))

    n = 0
    losses: List[float] = []
    paths: List[str] = []
    for epoch in range(1 if args.quick_test else args.max_epochs):
        loader.sampler.set_epoch(epoch)
        epoch_losses = []
        for batch in loader:
            metrics = system.train_step(batch)
            epoch_losses.append(metrics["loss"])
            n += 1
            if n % LOG_EVERY == 0 or args.quick_test:
                print(f"step {n}: loss {float(metrics['loss']):.4f} "
                      f"acc {float(metrics['spk_acc']):.4f}")
            if done():
                break
        losses += [float(x) for x in epoch_losses]
        paths.append(mgr.save(n, system.params_tree(), extra={"epoch": epoch}))
        if done():
            break
    return {"system": system, "losses": losses, "steps": n, "paths": paths}


if __name__ == "__main__":
    main()
