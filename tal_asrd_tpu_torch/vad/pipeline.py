"""VAD over a directory of wavs.

Counterpart of tal_asrd_tpu/vad/pipeline.py: for each wav, compute its
speech bounds, write a bounds pickle and (optionally) the concatenated
speech-only wav; a file whose outputs exist is read back instead
(incremental resume). Files fan out over a thread pool (the reference fans
out over processes); each file's result is the same either way.
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from tal_asrd_tpu_torch.data.audio_io import load_audio_segment, write_wav
from tal_asrd_tpu_torch.vad.core import VadConfig, get_speech_frames, speech_bounds


def run_vad_file(
    audio_path: str,
    out_dir: str,
    cfg: VadConfig = VadConfig(),
    write_speech_wav: bool = True,
    device: Optional[str] = None,
) -> List[Tuple[float, float]]:
    stub = os.path.splitext(os.path.basename(audio_path))[0]
    bounds_path = os.path.join(out_dir, f"{stub}.bounds.pkl")
    speech_path = os.path.join(out_dir, f"{stub}.speech.wav")
    if os.path.exists(bounds_path) and (not write_speech_wav or os.path.exists(speech_path)):
        with open(bounds_path, "rb") as f:  # incremental resume
            return pickle.load(f)

    audio = load_audio_segment(audio_path, 0.0, None, cfg.sample_rate)
    bounds = speech_bounds(audio, cfg, device)
    os.makedirs(out_dir, exist_ok=True)
    with open(bounds_path, "wb") as f:
        pickle.dump(bounds, f)
    if write_speech_wav:
        write_wav(speech_path, get_speech_frames(audio, cfg, device=device), cfg.sample_rate)
    return bounds


def run_vad_directory(
    data_dir: str,
    out_dir: str,
    cfg: VadConfig = VadConfig(),
    ext: str = ".wav",
    workers: int = 4,
    write_speech_wav: bool = True,
    device: Optional[str] = None,
) -> Dict[str, List[Tuple[float, float]]]:
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir) if f.endswith(ext))

    def one(path):
        return run_vad_file(path, out_dir, cfg, write_speech_wav, device)

    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return dict(zip(files, pool.map(one, files)))
    return {f: one(f) for f in files}
