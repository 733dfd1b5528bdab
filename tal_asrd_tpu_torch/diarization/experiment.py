"""UIS-RNN experiment runners: k-fold cross-validation and streaming
training (counterpart of tal_asrd_tpu/diarization/experiment.py).

  * `kfold_experiment`: folds `episodes[i::k]`; fold i trains a model seeded
    `seed + i` on the other folds, then predicts and scores its own
    episodes; `quick_test` keeps the first max(2, k) episodes, 5 training
    iterations and the first 20 observations of each test episode;
  * `streaming_fit`: `fit` over batches of feature files, the model saved
    with a `.progress` marker (the batches done) after each batch, and a
    run resumed from both.

Feature files are pickles of (sequences, cluster_ids) per episode:
sequences [N, D] float arrays, cluster_ids length-N label lists.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.diarization.evals import evaluate_result
from tal_asrd_tpu_torch.diarization.uisrnn import (
    UISRNN,
    UISRNNConfig,
    UISRNNInferenceConfig,
    UISRNNTrainConfig,
    output_result,
)


def load_feature_file(path: str) -> Tuple[List[np.ndarray], List[List[str]]]:
    with open(path, "rb") as f:
        return pickle.load(f)


def kfold_experiment(
    episodes: Sequence[Tuple[np.ndarray, Sequence[str]]],
    model_cfg: UISRNNConfig,
    train_cfg: UISRNNTrainConfig,
    infer_cfg: UISRNNInferenceConfig,
    k: int = 5,
    quick_test: bool = False,
    seed: int = 0,
    device="cuda",
):
    """k-fold CV: returns (mean_accuracy, per-fold records)."""
    episodes = list(episodes)
    if quick_test:
        episodes = episodes[: max(2, k)]
    n = len(episodes)
    folds = [episodes[i::k] for i in range(min(k, n))]
    records = []
    for fi, test_fold in enumerate(folds):
        train_eps = [e for fj, fold in enumerate(folds) if fj != fi for e in fold]
        model = UISRNN(model_cfg, seed=seed + fi, device=device)
        seqs = [np.asarray(s, float) for s, _ in train_eps]
        ids = [list(map(str, c)) for _, c in train_eps]
        tc = train_cfg
        if quick_test:
            tc = UISRNNTrainConfig(**{**train_cfg.__dict__, "quick_test": True})
        model.fit(seqs, ids, tc)
        for seq, gold in test_fold:
            seq = np.asarray(seq, float)
            if quick_test:
                seq, gold = seq[:20], list(gold)[:20]
            pred = model.predict_single(seq, infer_cfg)
            acc = evaluate_result(list(gold), pred)
            records.append((acc, len(gold)))
    mean_acc = float(np.mean([a for a, _ in records])) if records else 0.0
    print(output_result(model_cfg, train_cfg, records))
    return mean_acc, records


def streaming_fit(
    feature_files: Sequence[str],
    model_cfg: UISRNNConfig,
    train_cfg: UISRNNTrainConfig,
    checkpoint_path: str,
    files_per_batch: int = 10,
    resume: bool = True,
    device="cuda",
) -> UISRNN:
    """fit over batches of files, a checkpoint after each batch; resumes
    from the checkpoint and its progress marker."""
    model = UISRNN(model_cfg, device=device)
    progress_path = checkpoint_path + ".progress"
    start = 0
    if resume and os.path.exists(checkpoint_path) and os.path.exists(progress_path):
        model.load(checkpoint_path)
        with open(progress_path) as f:
            start = int(f.read().strip())
        print(f"[uisrnn] resuming from batch {start}")

    batches = [
        feature_files[i : i + files_per_batch]
        for i in range(0, len(feature_files), files_per_batch)
    ]
    for bi in range(start, len(batches)):
        seqs, ids = [], []
        for path in batches[bi]:
            s, c = load_feature_file(path)
            if isinstance(s, list):
                seqs.extend(np.asarray(x, float) for x in s)
                ids.extend(list(map(str, x)) for x in c)
            else:
                seqs.append(np.asarray(s, float))
                ids.append(list(map(str, c)))
        model.fit(seqs, ids, train_cfg)
        model.save(checkpoint_path)
        with open(progress_path, "w") as f:
            f.write(str(bi + 1))
    return model
