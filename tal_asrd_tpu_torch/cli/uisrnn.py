"""UIS-RNN experiment CLI: k-fold cross-validation or streaming training.

    python -m tal_asrd_tpu_torch.cli.uisrnn --features 'DIR/*.pkl' \
        [--mode kfold|stream] [--observation-dim 256 --rnn-hidden-size 512 ...] \
        [--quick-test] [--device cpu]

Counterpart of tal_asrd_tpu/cli/uisrnn.py, with its flags (plus --device,
default cuda) and its output: `--mode kfold` prints the experiment summary
and `mean accuracy: A (DER D)` (the line scripts/uisrnn_der.sh parses);
`--mode stream` fits over --files-per-batch files at a time, saving
--checkpoint after each batch, resuming from it, and prints `saved PATH`.
Each fold's model draws its own initial weights (a CPU generator seeded
by the fold), as the reference's draw cannot be reproduced.
"""
from __future__ import annotations

import argparse
from glob import glob


def main(argv=None):
    p = argparse.ArgumentParser("UIS-RNN experiments")
    p.add_argument("--features", type=str, required=True,
                   help="glob of per-episode feature pickles")
    p.add_argument("--mode", choices=["kfold", "stream"], default="kfold")
    p.add_argument("--observation-dim", type=int, default=256)
    p.add_argument("--rnn-hidden-size", type=int, default=512)
    p.add_argument("--rnn-depth", type=int, default=1)
    p.add_argument("--crp-alpha", type=float, default=1.0)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--train-iteration", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--beam-size", type=int, default=10)
    p.add_argument("--look-ahead", type=int, default=1)
    p.add_argument("--test-iteration", type=int, default=2)
    p.add_argument("--k-folds", type=int, default=5)
    p.add_argument("--files-per-batch", type=int, default=10)
    p.add_argument("--checkpoint", type=str, default="out/uisrnn.msgpack")
    p.add_argument("--quick-test", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the GRU trains and steps (cuda, or cpu)")
    args = p.parse_args(argv)

    from tal_asrd_tpu_torch.diarization import (
        UISRNNConfig,
        UISRNNInferenceConfig,
        UISRNNTrainConfig,
        kfold_experiment,
        streaming_fit,
    )
    from tal_asrd_tpu_torch.diarization.experiment import load_feature_file

    model_cfg = UISRNNConfig(
        observation_dim=args.observation_dim,
        rnn_hidden_size=args.rnn_hidden_size,
        rnn_depth=args.rnn_depth,
        crp_alpha=args.crp_alpha,
    )
    train_cfg = UISRNNTrainConfig(
        learning_rate=args.learning_rate,
        train_iteration=args.train_iteration,
        batch_size=args.batch_size,
        quick_test=args.quick_test,
    )
    files = sorted(glob(args.features))
    if not files:
        raise SystemExit(f"no feature files match {args.features}")

    if args.mode == "stream":
        streaming_fit(files, model_cfg, train_cfg, args.checkpoint,
                      args.files_per_batch, device=args.device)
        print(f"saved {args.checkpoint}")
    else:
        episodes = []
        for path in files:
            seqs, ids = load_feature_file(path)
            if isinstance(seqs, list):
                episodes.extend(zip(seqs, ids))
            else:
                episodes.append((seqs, ids))
        infer_cfg = UISRNNInferenceConfig(
            beam_size=args.beam_size, look_ahead=args.look_ahead,
            test_iteration=args.test_iteration,
        )
        acc, _ = kfold_experiment(episodes, model_cfg, train_cfg, infer_cfg,
                                  k=args.k_folds, quick_test=args.quick_test,
                                  device=args.device)
        print(f"mean accuracy: {acc:.4f} (DER {1-acc:.4f})")


if __name__ == "__main__":
    main()
