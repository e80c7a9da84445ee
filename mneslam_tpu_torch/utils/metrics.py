"""Per-stage wall-clock timers and a JSONL metric log.

The port's own copy of `StageTimers` from `mneslam_tpu/utils/metrics.py`,
without `report()` and with `close()`.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class StageTimers:
    """Accumulating named wall-clock timers with JSONL export."""

    def __init__(self, log_path: Optional[str] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.log_path = log_path
        self._fh = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a")

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    kind: str = "metric"):
        if self._fh is not None:
            self._fh.write(json.dumps(
                {"step": step, "kind": kind,
                 **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._fh.flush()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 3),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name]
                                 / max(self.counts[name], 1), 2),
            }
            for name in self.totals
        }

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
