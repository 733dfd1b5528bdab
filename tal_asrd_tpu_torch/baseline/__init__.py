"""The separate baselines' speaker half (counterpart of
tal_asrd_tpu/baseline): the SD model's training system and the
reconciliation of a separate ASR system with its frame tracks."""
from tal_asrd_tpu_torch.baseline.sd_system import SDSystem
from tal_asrd_tpu_torch.baseline.reconcile import (
    dump_episode_features,
    frame_gold_speakers,
    merge_asr_sd,
    utterance_frame_span,
)

__all__ = [
    "SDSystem",
    "dump_episode_features",
    "frame_gold_speakers",
    "merge_asr_sd",
    "utterance_frame_span",
]
