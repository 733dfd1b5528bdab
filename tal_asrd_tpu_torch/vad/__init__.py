"""Voice activity detection (counterpart of tal_asrd_tpu/vad): the energy
and WebRTC-style detectors, their evaluation, and the neural SAD (PyanNet,
`pyannet.py`, with the RTTM / UEM export and binarization of `sad.py`)."""
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
from tal_asrd_tpu_torch.vad.pyannet import (
    FRAME_HOP,
    PyanNet,
    SincConv,
    frame_labels,
    n_frames,
    score_episode,
)
from tal_asrd_tpu_torch.vad.sad import binarize, export_corpus, to_rttm, to_uem

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
    "FRAME_HOP",
    "PyanNet",
    "SincConv",
    "frame_labels",
    "n_frames",
    "score_episode",
    "binarize",
    "export_corpus",
    "to_rttm",
    "to_uem",
]
