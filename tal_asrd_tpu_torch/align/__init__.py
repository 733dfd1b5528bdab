"""Alignment (counterpart of tal_asrd_tpu/align): DTW on the device, MFCCs
through the frontend, and the model-based word aligner."""
from tal_asrd_tpu_torch.align.dtw import dtw_cost_matrix, dtw_path, monotonic_segmentation
from tal_asrd_tpu_torch.align.mfcc import mfcc, dct_matrix
from tal_asrd_tpu_torch.align.forced import (
    align_episode,
    align_utterance,
    full_force_align,
    token_word_groups,
)

__all__ = [
    "dtw_cost_matrix",
    "dtw_path",
    "monotonic_segmentation",
    "mfcc",
    "dct_matrix",
    "align_episode",
    "align_utterance",
    "full_force_align",
    "token_word_groups",
]
