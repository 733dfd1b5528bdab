"""Diarization evaluation (counterpart of tal_asrd_tpu/diarization/evals.py):
the best-matching accuracy between predicted and true label sequences under
the optimal label permutation; DER = 1 - accuracy."""
from __future__ import annotations

from typing import Sequence

from tal_asrd_tpu_torch.eval.wder import compute_sequence_match


def evaluate_result(true_labels: Sequence, predicted_labels: Sequence) -> float:
    """Best-matching accuracy under the optimal label permutation."""
    _, _, accuracy = compute_sequence_match(list(true_labels), list(predicted_labels))
    return accuracy


def diarization_error_rate(true_labels: Sequence, predicted_labels: Sequence) -> float:
    return 1.0 - evaluate_result(true_labels, predicted_labels)
