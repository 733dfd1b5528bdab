"""Host-side audio IO: wav probing, seek-loading, resampling, writing.

Counterpart of tal_asrd_tpu/data/audio_io.py: stdlib `wave` + numpy, and
scipy's polyphase resampling when a file's rate differs from the target.
PCM wav only; `convert_audio` turns other containers into wav with ffmpeg.
"""
from __future__ import annotations

import shutil
import subprocess
import wave
from dataclasses import dataclass
from typing import Optional

import numpy as np

DEFAULT_SR = 16000


@dataclass
class AudioInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    sample_width: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def get_audio_info(path: str) -> AudioInfo:
    """Probe a wav header."""
    with wave.open(path, "rb") as w:
        return AudioInfo(
            sample_rate=w.getframerate(),
            num_frames=w.getnframes(),
            num_channels=w.getnchannels(),
            sample_width=w.getsampwidth(),
        )


def get_duration(path: str) -> float:
    return get_audio_info(path).duration


def _pcm_to_float(raw: bytes, sample_width: int, num_channels: int) -> np.ndarray:
    if sample_width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sample_width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sample_width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sample_width}")
    if num_channels > 1:
        x = x.reshape(-1, num_channels).mean(axis=1)
    return x


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    if orig_sr == new_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(x, new_sr // g, orig_sr // g).astype(np.float32)


def load_audio_segment(
    path: str,
    start_s: float = 0.0,
    end_s: Optional[float] = None,
    target_sr: int = DEFAULT_SR,
) -> np.ndarray:
    """Seek-load [start_s, end_s) of a wav, mono float32 at target_sr,
    values in [-1, 1]."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        start = int(start_s * sr)
        end = total if end_s is None else min(int(end_s * sr), total)
        start = min(start, total)
        w.setpos(start)
        raw = w.readframes(max(end - start, 0))
    x = _pcm_to_float(raw, width, nch)
    return resample(x, sr, target_sr)


def write_wav(path: str, x: np.ndarray, sr: int = DEFAULT_SR) -> None:
    x16 = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())


def convert_audio(src: str, dst: str, sr: int = DEFAULT_SR) -> str:
    """Any container -> mono 16-bit wav at `sr`: a wav is read and written
    here, anything else goes through ffmpeg (an error names it if it is not
    installed)."""
    if src.lower().endswith(".wav"):
        write_wav(dst, load_audio_segment(src, 0.0, None, sr), sr)
        return dst
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"ffmpeg not available to convert {src}")
    subprocess.run([ffmpeg, "-y", "-i", src, "-ac", "1", "-ar", str(sr),
                    "-acodec", "pcm_s16le", dst], check=True, capture_output=True)
    return dst
