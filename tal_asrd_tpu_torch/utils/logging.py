"""Metrics sink of training: a JSONL stream plus stdout.

Counterpart of tal_asrd_tpu/utils/logging.py for one process and without
the optional wandb backend: `log_metrics` appends one JSON record per call
to `<out_dir>/<name>.metrics.jsonl` and prints it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, out_dir: str = "out", name: str = "run"):
        self.name = name
        self._t0 = time.time()
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.metrics.jsonl")
        self._f = open(self.path, "a")

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec: Dict[str, Any] = {"_time": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        line = json.dumps(rec)
        self._f.write(line + "\n")
        self._f.flush()
        print(f"[{self.name}] {line}", flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
