"""Log-mel spectrogram frontend.

Counterpart of tal_asrd_tpu/ops/logmel.py, with the same parity target: 16 kHz
audio, 80 mels, n_fft = win_length = 400 (25 ms periodic Hann), hop 160,
power 2, center=True with reflect padding, HTK mel scale, no filterbank
normalization, log(mel + 1e-6), then subtraction of the global mean.

The spectrum is `torch.fft.rfft` in float32 (the reference's windowed-DFT
lowering is a TPU choice and is not ported). The mel projection and the log
go through `fused_logmel_project` (ops/cuda_kernels.py): the hand-written
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor.

Audio and output stay float32; the model casts downstream.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tal_asrd_tpu_torch.core.config import FrontendConfig
from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Triangular HTK-mel filterbank, [n_freqs, n_mels], float32, built in
    float64. FFT bin centers are linspace(0, sr/2, n_freqs); mel points are
    linspace in HTK-mel space; no normalization."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]                    # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]       # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]               # rising edge
    up = slopes[:, 2:] / f_diff[1:]                    # falling edge
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    """Output frame count. center=True gives 1 + n_samples // hop."""
    if cfg.center:
        return 1 + n_samples // cfg.hop_length
    return 1 + (n_samples - cfg.n_fft) // cfg.hop_length


def _hann_periodic(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def frame_signal(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, T] -> [B, n_frames, win_length] with center reflect padding.
    The result is a strided view of the padded signal (no copy)."""
    if cfg.center:
        pad = cfg.n_fft // 2
        audio = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return audio.unfold(-1, cfg.win_length, cfg.hop_length)


def power_spectrogram(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_fft//2 + 1] power spectrum (|rfft|^2), f32."""
    frames = frame_signal(audio.to(torch.float32), cfg)
    window = torch.from_numpy(_hann_periodic(cfg.win_length)).to(audio.device)
    spec = torch.fft.rfft(frames * window, n=cfg.n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def log_mel_spectrogram(
    audio: torch.Tensor,
    cfg: FrontendConfig = FrontendConfig(),
    mean_subtract: Optional[bool] = None,
    audio_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw waveform [B, T] (float32 in [-1, 1]) -> log-mel [B, n_frames, n_mels].

    The mean that is subtracted is one scalar over the whole batch. With
    `audio_lens=None` it includes padding frames (the reference's behaviour
    on right-padded batches); with `audio_lens` it is taken over real frames
    only, which keeps features independent of how much padding a batch holds.
    """
    if audio.dim() == 1:
        audio = audio[None]
    spec = power_spectrogram(audio, cfg)  # [B, F, n_freqs]
    fb = torch.from_numpy(mel_filterbank(
        cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max, cfg.n_mels,
        cfg.sample_rate)).to(spec.device)
    b, f, nf = spec.shape
    mel = fused_logmel_project(
        spec.reshape(b * f, nf).contiguous(), fb, eps=cfg.log_eps
    ).reshape(b, f, cfg.n_mels)
    do_mean = cfg.mean_subtract if mean_subtract is None else mean_subtract
    return mel - batch_mean(mel, audio_lens, cfg) if do_mean else mel


def batch_mean(mel: torch.Tensor, audio_lens: Optional[torch.Tensor] = None,
               cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """The one mean over the whole batch of a log-mel [B, F, n_mels], a
    scalar tensor: over the real frames with `audio_lens`, else over every
    frame."""
    if audio_lens is None:
        return mel.mean()
    total, count = batch_sum_count(mel, audio_lens, cfg)
    return total / count.clamp(min=mel.shape[-1])     # at least one frame


def batch_sum_count(mel: torch.Tensor, audio_lens: torch.Tensor,
                    cfg: FrontendConfig = FrontendConfig()):
    """(sum, count) of a log-mel's values over the real frames: `batch_mean`
    is their ratio; a data-parallel batch adds both up over its processes."""
    # Real frames of item i: centers at k*hop for k <= len_i // hop
    # (center=True reflect pad keeps frame k anchored at sample k*hop).
    frame_idx = torch.arange(mel.shape[1], device=mel.device)[None, :]
    real = frame_idx <= (audio_lens.to(mel.device)[:, None] // cfg.hop_length)
    return (mel * real[..., None]).sum(dtype=torch.float32), real.sum() * mel.shape[-1]
