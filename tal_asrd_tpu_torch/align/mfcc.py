"""MFCC features (log-mel -> DCT-II), for audio-to-audio DTW alignment.

Counterpart of tal_asrd_tpu/align/mfcc.py: the frontend's log-mel without
the mean subtracted (`log_mel_spectrogram`: the mel projection and the log
in the K2 kernel on the card) times an orthonormal DCT-II basis over the
mel axis.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tal_asrd_tpu_torch.core.config import FrontendConfig
from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram


@functools.lru_cache(maxsize=4)
def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mels, n_mfcc]."""
    k = np.arange(n_mfcc)[None, :]
    n = np.arange(n_mels)[:, None]
    basis = np.cos(np.pi / n_mels * (n + 0.5) * k)
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] = 1.0 / np.sqrt(n_mels)
    return basis.astype(np.float32)


def mfcc(audio: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
         n_mfcc: int = 13) -> torch.Tensor:
    """[B, T] audio -> [B, frames, n_mfcc], on the audio's device."""
    mel = log_mel_spectrogram(audio, cfg, mean_subtract=False)
    basis = torch.from_numpy(dct_matrix(cfg.n_mels, n_mfcc)).to(mel.device)
    return mel @ basis
