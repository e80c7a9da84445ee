"""Per-stage wall-clock timers and a JSONL metric log.

The port's own copy of `StageTimers` from `mneslam_tpu/utils/metrics.py`,
without `report()` and with `close()`, and of its trace hook
`maybe_profile` (a torch.profiler trace). As in the JAX package, nothing
on the main path calls the hook.
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


@contextmanager
def maybe_profile(tag: str):
    """A torch.profiler trace of the block (CPU activity, and CUDA
    activity where a GPU is present) written to $MNESLAM_TRACE_DIR/<tag>
    when MNESLAM_TRACE_DIR is set; otherwise nothing."""
    trace_dir = os.environ.get("MNESLAM_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=
                 tensorboard_trace_handler(os.path.join(trace_dir, tag))):
        yield
