"""The native GMM voice activity detector (native/webrtc_vad.cpp), on the host.

Counterpart of tal_asrd_tpu/vad/webrtc_gmm.py: the reference's per-frame
decision comes from the webrtcvad C++ package; this wrapper gives the
repository's native GMM detector webrtcvad's interface

    vad = WebRtcGmmVad(mode=3)
    vad.is_speech(frame_bytes, sample_rate)   # 10/20/30 ms int16 PCM frames

and `decisions(audio_f32, ...)`, the `gmm` detector of vad/core.py. The
library is built with g++ by utils/native.py into the port's
tal_asrd_tpu_torch/_build/, like the other host libraries. It has no Python
twin: without the library (no g++, or TAL_ASRD_NO_NATIVE set) the detector
raises and the `energy` detector remains.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from tal_asrd_tpu_torch.utils.native import load_host_library


def _load() -> Optional[ctypes.CDLL]:
    lib = load_host_library("webrtc_vad")
    if lib is not None:
        lib.vad_create.restype = ctypes.c_void_p
        lib.vad_free.argtypes = [ctypes.c_void_p]
        lib.vad_set_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vad_set_mode.restype = ctypes.c_int
        lib.vad_process.restype = ctypes.c_int
        lib.vad_process.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t]
    return lib


def available() -> bool:
    return _load() is not None


class WebRtcGmmVad:
    """webrtcvad.Vad-compatible stateful detector."""

    def __init__(self, mode: int = 3):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native webrtc_vad library is unavailable (no g++?)")
        self._lib = lib
        self._inst = lib.vad_create()
        if lib.vad_set_mode(self._inst, mode) != 0:
            raise ValueError(f"bad mode {mode}")

    def __del__(self):
        inst, self._inst = getattr(self, "_inst", None), None
        if inst:
            self._lib.vad_free(inst)

    def set_mode(self, mode: int) -> None:
        if self._lib.vad_set_mode(self._inst, mode) != 0:
            raise ValueError(f"bad mode {mode}")

    def is_speech(self, frame: bytes, sample_rate: int) -> bool:
        """frame: int16 little-endian PCM of 10/20/30 ms."""
        buf = np.frombuffer(frame, np.int16)
        r = self._lib.vad_process(self._inst, sample_rate,
                                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(buf))
        if r < 0:
            raise ValueError(f"invalid frame (len {len(buf)} @ {sample_rate})")
        return bool(r)


def decisions(audio: np.ndarray, sample_rate: int = 16000,
              frame_duration_ms: int = 30, mode: int = 3) -> np.ndarray:
    """float32 [-1, 1] audio -> bool per-frame decisions of consecutive
    full frames."""
    vad = WebRtcGmmVad(mode)
    n = int(sample_rate * frame_duration_ms / 1000)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    return np.asarray([vad.is_speech(pcm[i:i + n].tobytes(), sample_rate)
                       for i in range(0, len(pcm) - n + 1, n)], bool)
