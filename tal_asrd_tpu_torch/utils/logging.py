"""Metrics sink of training: a JSONL stream plus stdout.

Counterpart of tal_asrd_tpu/utils/logging.py for one process and without
the optional wandb backend: `log_metrics` appends one JSON record per call
to `<out_dir>/<name>.metrics.jsonl` and prints it; `log_generation` appends
a spot-check record ({"type": "generation", "ref", "hyp", "step"}) and
prints GOLD and GENERATED; `update_config` writes the run's configuration
to `<out_dir>/<name>.config.json`. `project`, the reference's wandb
project, is taken and not used.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str = "out", name: str = "run", project: str = "asr",
                 config: Optional[dict] = None):
        self.out_dir = out_dir
        self.name = name
        self._t0 = time.time()
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.metrics.jsonl")
        self._f = open(self.path, "a")
        if config:
            self.update_config(config)

    def update_config(self, config: Dict[str, Any]) -> None:
        with open(os.path.join(self.out_dir, f"{self.name}.config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def _write(self, rec: Dict[str, Any]) -> str:
        line = json.dumps(rec)
        self._f.write(line + "\n")
        self._f.flush()
        return line

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec: Dict[str, Any] = {"_time": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        print(f"[{self.name}] {self._write(rec)}", flush=True)

    def log_generation(self, audio, ref_text: Optional[str], hyp_text: Optional[str],
                       step: Optional[int] = None) -> None:
        """The validation-time generation spot check. `audio` is the
        sample's waveform, which the reference's wandb backend uploads; the
        file keeps the texts only."""
        rec: Dict[str, Any] = {"type": "generation", "ref": ref_text, "hyp": hyp_text}
        if step is not None:
            rec["step"] = int(step)
        self._write(rec)
        print("\n=== CANDIDATE GENERATION ===")
        if ref_text is not None:
            print(f"GOLD:\n{ref_text}\n")
        if hyp_text is not None:
            print(f"GENERATED:\n{hyp_text}\n", flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
