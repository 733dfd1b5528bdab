"""VAD-gated decode windows for long-form transcription.

Counterpart of tal_asrd_tpu/vad/windows.py. It turns an episode waveform
into decode windows that start at speech onsets, so every window presents
the model with a window-initial utterance, the distribution it decodes
best. EvalRunner.test_step_unaligned_vad buckets the windows to a fixed set
of lengths and decodes them in fixed-shape batches.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tal_asrd_tpu_torch.vad.core import VadConfig, speech_bounds


def vad_decode_windows(
    audio: np.ndarray,
    sample_rate: int = 16000,
    vad_cfg: Optional[VadConfig] = None,
    pad_s: float = 0.05,
    max_window_s: float = 20.0,
    min_window_s: float = 0.25,
    merge_gap_s: float = 0.02,
    device: Optional[str] = None,
) -> List[Tuple[int, int]]:
    """(start_sample, end_sample) decode windows covering the speech regions.

    * speech regions come from vad/core.speech_bounds (the detector on
      `device`); the default knobs here (level 2, trigger/detrigger 0.7)
      segment at utterance gaps rather than word gaps;
    * each region is padded by `pad_s` on both sides, clipped at the
      midpoint of the gap to each neighbour, so padding never fuses two
      regions (a fused window's beam stops at its first EOS);
    * regions separated by less than `merge_gap_s` before padding merge
      (VAD flicker);
    * regions longer than `max_window_s` split at their quietest interior
      10 ms frame inside the middle half, recursively.
    """
    if vad_cfg is None:
        vad_cfg = VadConfig(sample_rate=sample_rate, vad_level=2,
                            prop_voice_start=0.7, prop_unvoice_end=0.7)
    bounds = speech_bounds(audio, vad_cfg, device)

    merged: List[List[float]] = []
    total_s = len(audio) / sample_rate
    raw_prev_end = 0.0
    for i, (s, e) in enumerate(bounds):
        next_start = bounds[i + 1][0] if i + 1 < len(bounds) else total_s
        # the merge test reads the RAW previous end: padding would shrink
        # every gap by up to 2 pad_s and merge ordinary utterance gaps
        if merged and s - raw_prev_end < merge_gap_s:
            merged[-1][1] = min(e + min(pad_s, (next_start - e) / 2), total_s)
        else:
            s2 = max(0.0, s - min(pad_s, (s - raw_prev_end) / 2))
            e2 = min(total_s, e + min(pad_s, (next_start - e) / 2))
            merged.append([s2, e2])
        raw_prev_end = e

    def split(s: float, e: float, out: List[Tuple[float, float]]):
        if e - s <= max_window_s:
            out.append((s, e))
            return
        lo = int((s + (e - s) * 0.25) * sample_rate)
        hi = int((s + (e - s) * 0.75) * sample_rate)
        fr = sample_rate // 100  # 10 ms
        seg = audio[lo: hi // fr * fr]
        n = (len(seg) // fr) * fr
        energy = (seg[:n].reshape(-1, fr) ** 2).mean(axis=1)
        cut = lo + int(np.argmin(energy)) * fr + fr // 2
        split(s, cut / sample_rate, out)
        split(cut / sample_rate, e, out)

    windows: List[Tuple[float, float]] = []
    for s, e in merged:
        if e - s >= min_window_s:
            split(s, e, windows)

    return [(int(s * sample_rate), int(e * sample_rate)) for s, e in windows]
