"""What a per-layer metric's reader reads: the cell's configuration and mix,
the window's counts (`stats`) and host spans (`spans`, seconds by name,
recorded by the benchmark around its calls into the program), and the
profiled stretch after it (`profile`, benchmark/trace.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from benchmark import counts
from benchmark.trace import Profile


@dataclass
class Reading:
    config: dict
    mix: dict
    stats: dict
    spans: Optional[Dict[str, List[float]]]
    profile: Optional[Profile]

    @property
    def shape(self) -> counts.Shape:
        return counts.Shape.of(self.config)

    def traced(self) -> bool:
        """Whether the profiled stretch saw device work."""
        return self.profile is not None and self.profile.busy_s > 0
