"""Voice activity detection (counterpart of tal_asrd_tpu/vad without the
neural SAD, `sad.py` and `pyannet.py`, ROADMAP A18)."""
from tal_asrd_tpu_torch.vad.core import (
    VadConfig,
    collector_mask,
    get_speech_frames,
    speech_bounds,
    speech_decisions,
    speech_probabilities,
    vad_collector,
)
from tal_asrd_tpu_torch.vad.eval import VadScores, evaluate_vad, rasterize
from tal_asrd_tpu_torch.vad.pipeline import run_vad_directory, run_vad_file

__all__ = [
    "VadConfig",
    "collector_mask",
    "get_speech_frames",
    "speech_bounds",
    "speech_decisions",
    "speech_probabilities",
    "vad_collector",
    "VadScores",
    "evaluate_vad",
    "rasterize",
    "run_vad_directory",
    "run_vad_file",
]
