"""Voice activity detection: per-frame speech decisions and the reference's
trigger state machine.

Counterpart of tal_asrd_tpu/vad/core.py. The reference uses the webrtcvad
GMM VAD with a 30 ms frame ring-buffer trigger/detrigger collector: enter
TRIGGERED when more than prop_voice_start of the 300 ms ring buffer is
voiced (retroactively including the buffered frames), leave when more than
prop_unvoice_end is unvoiced.

  * the per-frame decision is the `energy` detector (the default): frame
    log-energy against an adaptive floor (20th / 95th percentiles, linear
    interpolation) plus a high-band energy ratio, computed for all frames at
    once in float32 on `device`; or the native GMM (`detector="gmm"`,
    vad/webrtc_gmm.py), on the host;
  * the trigger state machine is a loop over the 30 ms frames on the host
    (JAX runs it as a lax.scan): the same ring buffer, the retroactive
    inclusion of its frames at a trigger, and the buffer cleared at both
    transitions;
  * `vad_collector` yields segments like the reference's API.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class VadConfig:
    sample_rate: int = 16000
    frame_duration_ms: int = 30
    padding_duration_ms: int = 300
    vad_level: int = 3           # 0..3, higher = more aggressive (webrtc knob)
    prop_voice_start: float = 0.9
    prop_unvoice_end: float = 0.9
    # 'energy' = the vectorized detector (the default); 'gmm' = the native
    # webrtc-style GMM (native/webrtc_vad.cpp)
    detector: str = "energy"

    @property
    def frame_len(self) -> int:
        return int(self.sample_rate * self.frame_duration_ms / 1000)

    @property
    def num_padding_frames(self) -> int:
        return int(self.padding_duration_ms / self.frame_duration_ms)


def frame_audio(audio: torch.Tensor, cfg: VadConfig) -> torch.Tensor:
    """[T] -> [n_frames, frame_len]; the trailing partial frame is dropped,
    and so is a last full frame (n_frames = (T - 1) // frame_len, as the
    reference)."""
    n = cfg.frame_len
    n_frames = max((audio.shape[-1] - 1) // n, 0)
    return audio[: n_frames * n].reshape(n_frames, n)


def speech_probabilities(audio, cfg: VadConfig = VadConfig(),
                         device: Optional[str] = None) -> torch.Tensor:
    """Per-frame speech probability in [0, 1] (float32, on `device`, by
    default the audio's): 0.75 x the log-energy score between the 20th and
    95th percentile of the episode's frames + 0.25 x the first-difference
    (high-band) energy ratio."""
    x = torch.as_tensor(np.asarray(audio) if not torch.is_tensor(audio) else audio)
    frames = frame_audio(x.to(device=device or x.device, dtype=torch.float32), cfg)
    energy = _row_mean(frames * frames)
    log_e = torch.log(energy + 1e-10)

    floor, ceil = _percentile(log_e, 20.0), _percentile(log_e, 95.0)
    span = torch.clamp(ceil - floor, min=1e-3)
    e_score = torch.clamp((log_e - floor) / span, 0.0, 1.0)

    diff = frames[:, 1:] - frames[:, :-1]
    hf = _row_mean(diff * diff)
    hf_score = torch.clamp(hf / (energy + 1e-10) / 2.0, 0.0, 1.0)
    return 0.75 * e_score + 0.25 * hf_score


def _row_mean(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Mean over the last axis of [N, M] float32 in the reference's
    summation order: sums of consecutive windows of 32 values, each added
    left to right, then the window sums left to right, times f32(1 / M)
    (how XLA on the CPU lowers jnp.mean over a row). The frames' energies
    are thresholded, so the order is part of the result: summed in another
    order they differ in the last bits, and a frame's probability by more
    than 1e-6 where the episode's log-energy span is small. (The log that
    follows is correctly rounded here and within an ulp in XLA.)"""
    n, m = x.shape
    k = -(-m // window)
    blocks = torch.nn.functional.pad(x, (0, k * window - m)).reshape(n, k, window)
    part = torch.zeros((n, k), dtype=x.dtype, device=x.device)
    for i in range(window):
        part = part + blocks[..., i]
    total = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for j in range(k):
        total = total + part[:, j]
    return total * torch.tensor(1.0 / m, dtype=torch.float32, device=x.device)


def _percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """Linear-interpolation percentile of a 1-D float32 tensor, in the
    reference's arithmetic (jnp.percentile): rank p / 100 * (n - 1) in f32,
    low * (1 - w) + high * w."""
    xs = torch.sort(x).values
    n = xs.shape[0]
    rank = torch.tensor(p, dtype=torch.float32) / 100 * (n - 1)
    low = torch.floor(rank)
    w = rank - low
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(torch.ceil(rank).item(), 0), n - 1))
    return xs[lo] * (1 - w.to(xs.device)) + xs[hi] * w.to(xs.device)


def speech_decisions(audio, cfg: VadConfig = VadConfig(),
                     device: Optional[str] = None) -> np.ndarray:
    """Boolean per-frame decisions (host); vad_level tightens the energy
    detector's threshold (0.3 .. 0.6)."""
    if cfg.detector == "gmm":
        from tal_asrd_tpu_torch.vad.webrtc_gmm import decisions as gmm_decisions

        a = audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio)
        return gmm_decisions(a, cfg.sample_rate, cfg.frame_duration_ms, mode=cfg.vad_level)
    probs = speech_probabilities(audio, cfg, device)
    return (probs > 0.3 + 0.1 * cfg.vad_level).cpu().numpy()


def collector_mask(decisions, cfg: VadConfig = VadConfig()) -> np.ndarray:
    """The trigger state machine over per-frame decisions -> per-frame
    speech mask (bool numpy)."""
    n_pad = cfg.num_padding_frames
    start_thresh = cfg.prop_voice_start * n_pad
    end_thresh = cfg.prop_unvoice_end * n_pad
    decisions = np.asarray(decisions, bool)
    n = len(decisions)
    speech = np.zeros(n, bool)
    trigger = np.zeros(n, bool)
    ring: deque = deque(maxlen=n_pad)
    triggered = False
    for t, is_speech in enumerate(decisions):
        ring.append(bool(is_speech))
        voiced = sum(ring)
        fire_on = not triggered and voiced > start_thresh
        fire_off = triggered and len(ring) - voiced > end_thresh
        speech[t] = triggered or fire_on
        trigger[t] = fire_on
        triggered = (triggered or fire_on) and not fire_off
        if fire_on or fire_off:          # the buffer clears at both transitions
            ring.clear()
    # a trigger at t includes the ring buffer's frames [t - n_pad + 1, t]:
    # frame i joins if a trigger fires in [i, i + n_pad)
    fired = np.concatenate([[0], np.cumsum(trigger)])
    hi = np.minimum(np.arange(n) + n_pad, n)
    return speech | (fired[hi] - fired[:n] > 0)


def _mask(audio, cfg: VadConfig, device: Optional[str]) -> np.ndarray:
    return collector_mask(speech_decisions(audio, cfg, device), cfg)


def get_speech_frames(audio: np.ndarray, cfg: VadConfig = VadConfig(),
                      log: bool = False, device: Optional[str] = None) -> np.ndarray:
    """Concatenated speech-only samples."""
    mask = _mask(audio, cfg, device)
    n = cfg.frame_len
    frames = np.asarray(audio[: len(mask) * n]).reshape(len(mask), n)
    speech = frames[mask].reshape(-1)
    if log and len(audio):
        print(f"{len(speech):,} of {len(audio):,} samples kept "
              f"({100 * len(speech) / len(audio):.2f}%)")
    return speech


def speech_bounds(audio: np.ndarray, cfg: VadConfig = VadConfig(),
                  device: Optional[str] = None) -> List[Tuple[float, float]]:
    """(start_s, end_s) speech segments."""
    mask = _mask(audio, cfg, device)
    bounds = []
    frame_s = cfg.frame_duration_ms / 1000.0
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            bounds.append((start * frame_s, i * frame_s))
            start = None
    if start is not None:
        bounds.append((start * frame_s, len(mask) * frame_s))
    return bounds


def vad_collector(audio: np.ndarray, cfg: VadConfig = VadConfig(),
                  device: Optional[str] = None) -> Iterator[np.ndarray]:
    """Segment generator mirroring the reference vad_collector API."""
    for s, e in speech_bounds(audio, cfg, device):
        yield np.asarray(audio[int(s * cfg.sample_rate): int(e * cfg.sample_rate)])
