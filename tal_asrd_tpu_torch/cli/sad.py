"""Neural SAD CLI: train PyanNet on transcript bounds, score, binarize, evaluate.

    python -m tal_asrd_tpu_torch.cli.sad --train-data D --test-data D \
        --out-dir OUT [--steps 300] [--load OUT/pyannet.msgpack] \
        [--json-out M.json] [--device cpu]

Counterpart of tal_asrd_tpu/cli/sad.py, with its flags (plus --device,
default cuda): the train split exported to OUT/corpus.rttm and
OUT/corpus.uem (one row an utterance bound), then --steps Adam steps
(optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square
root) of the mean sigmoid binary cross entropy on --batch-size windows of
--window-secs (snapped to the 270-sample frame grid) drawn from
`np.random.default_rng(--seed)` in the reference's order (episode, then
start), a line every 25 steps and at the last; the parameters written to
OUT/pyannet.msgpack as the reference's flax tree (either package loads the
other's file). With --load the training is skipped. Each test episode is
scored (vad/pyannet.py `score_episode`), binarized at --onset / --offset with
--min-duration on and off, and scored against its transcript's bounds at
10 ms; OUT/sad_bounds.pkl holds the regions, --json-out the mean
sad_precision_pct / sad_recall_pct / sad_f1_pct.

The initial parameters are the port's own draw (PyanNet.reset_parameters
from a CPU generator seeded --seed); the reference's jax.random draws cannot
be reproduced here.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
from tal_asrd_tpu_torch.data.audio_io import get_duration, load_audio_segment
from tal_asrd_tpu_torch.data.transcript import load_transcripts
from tal_asrd_tpu_torch.vad.eval import evaluate_vad, utterance_gold_bounds
from tal_asrd_tpu_torch.vad.pyannet import (
    FRAME_HOP,
    SAMPLE_RATE,
    PyanNet,
    frame_labels,
    load_pyannet,
    score_episode,
    state_dict_to_params,
)
from tal_asrd_tpu_torch.vad.sad import binarize, export_corpus


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neural SAD")
    p.add_argument("--train-data", type=str, required=True)
    p.add_argument("--test-data", type=str, required=True)
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--window-secs", type=float, default=2.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--onset", type=float, default=0.52)
    p.add_argument("--offset", type=float, default=0.52)
    p.add_argument("--min-duration", type=float, default=0.1,
                   help="min on/off region seconds (reference: 0.1)")
    p.add_argument("--load", type=str, default=None,
                   help="skip training, score with these params")
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains and scores (cuda or cpu)")
    return p


def load_split(data_dir: str) -> Dict[str, tuple]:
    """stub -> (whole-episode wav float32, gold bounds, duration) for every
    transcript episode whose wav exists."""
    out = {}
    for stub, utts in load_transcripts(data_dir).items():
        path = os.path.join(data_dir, f"{stub}.wav")
        if not os.path.exists(path):
            continue
        dur = get_duration(path)
        wav = load_audio_segment(path, 0.0, dur, SAMPLE_RATE)
        out[stub] = (np.asarray(wav, np.float32), utterance_gold_bounds(utts), dur)
    return out


def sample_batch(train: Dict[str, tuple], rng: np.random.Generator, batch_size: int,
                 win: int):
    """One training batch: for each row an episode, then a window start,
    drawn from `rng`; (windows [B, win] f32, frame labels [B, frames])."""
    stubs = list(train)
    xs, ys = [], []
    for _ in range(batch_size):
        wav, bounds, _ = train[stubs[rng.integers(len(stubs))]]
        start = int(rng.integers(0, max(1, len(wav) - win)))
        xs.append(wav[start:start + win])
        ys.append(frame_labels(bounds, win, offset_s=start / SAMPLE_RATE))
    return np.stack(xs), np.stack(ys)


def train_steps(model: PyanNet, train: Dict[str, tuple], steps: int, batch_size: int,
                win: int, lr: float, seed: int, log=print) -> List[float]:
    """`steps` Adam steps on batches from `np.random.default_rng(seed)`;
    returns each step's loss."""
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    opt = torch.optim.Adam(model.trainable_parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    model.train()
    losses = []
    for i in range(steps):
        x, y = sample_batch(train, rng, batch_size, win)
        logits = model(torch.from_numpy(x).to(dev))
        loss = F.binary_cross_entropy_with_logits(logits, torch.from_numpy(y).to(dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 25 == 0 or i == steps - 1:
            log(f"step {i}: bce {float(losses[-1]):.4f}")
    model.eval()
    return [float(x) for x in losses]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Returns {"model", "losses" (empty with --load), "bounds", "scores"
    (per test episode: precision, recall, f1), "metrics" (the --json-out
    dict, or None)}."""
    args = get_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    win = FRAME_HOP * max(1, round(args.window_secs * SAMPLE_RATE / FRAME_HOP))

    train = load_split(args.train_data)
    test = load_split(args.test_data)
    print(f"train episodes: {len(train)}  test episodes: {len(test)}")

    # RTTM / UEM export (the reference's database-preparation leg)
    export_corpus(
        {s: [{"utterance_start": a, "utterance_end": b, "speaker": i}
             for i, (a, b) in enumerate(bounds)]
         for s, (w, bounds, d) in train.items()},
        {s: d for s, (w, bounds, d) in train.items()},
        args.out_dir)

    losses: List[float] = []
    if args.load:
        model = load_pyannet(load_pytree(args.load), args.device)
    else:
        model = PyanNet(device=args.device,
                        generator=torch.Generator().manual_seed(args.seed))
        losses = train_steps(model, train, args.steps, args.batch_size, win, args.lr,
                             args.seed)
        save_pytree(os.path.join(args.out_dir, "pyannet.msgpack"),
                    state_dict_to_params(model.state_dict()))

    # --- score + binarize the test episodes ---------------------------------
    frame_s = FRAME_HOP / SAMPLE_RATE
    pred_bounds = {}
    scores_list = []
    for stub, (wav, bounds, dur) in sorted(test.items()):
        scores = score_episode(model, wav, window_s=args.window_secs)
        pred = binarize(scores, frame_s, onset=args.onset, offset=args.offset,
                        min_duration_on=args.min_duration,
                        min_duration_off=args.min_duration)
        pred_bounds[stub] = pred
        s = evaluate_vad(pred, bounds, dur)
        scores_list.append(s)
        print(f"{stub}: P {s.precision:.3f} R {s.recall:.3f} F1 {s.f1:.3f} "
              f"({len(pred)} regions)")
    with open(os.path.join(args.out_dir, "sad_bounds.pkl"), "wb") as f:
        pickle.dump(pred_bounds, f)

    metrics = None
    if args.json_out and scores_list:
        mean = lambda k: sum(getattr(s, k) for s in scores_list) / len(scores_list)
        metrics = {"sad_precision_pct": round(100 * mean("precision"), 2),
                   "sad_recall_pct": round(100 * mean("recall"), 2),
                   "sad_f1_pct": round(100 * mean("f1"), 2)}
        with open(args.json_out, "w") as f:
            json.dump(metrics, f)
        print(f"SAD metrics -> {args.json_out}: {metrics}")
    return {"model": model, "losses": losses, "bounds": pred_bounds,
            "scores": [(s.precision, s.recall, s.f1) for s in scores_list],
            "metrics": metrics}


if __name__ == "__main__":
    main()
