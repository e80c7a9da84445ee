"""Spans and the device trace of a `--trace 1` run.

A span is the benchmark's own, recorded around its calls into a layer of
the program: in a traced run it synchronises the device at both ends, so
the host-clock interval covers the device work launched inside it. In an
untraced run a span costs nothing and records nothing.

The profiler records the device's activity only (kernels, copies, fills):
recording every host-side operator as well slowed a mapping iteration
from about 20 to about 50 ms. The host's spans are placed on the trace's
clock by a marker kernel launched when the window opens; a second marker
closes it.

`View` is what the per-layer readers (`metrics/*.py`) read: the spans, the
device operations of the traced window, the window's length, the work done
in it and the counts the driver kept.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


class Spans:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.host: List[Tuple[str, float, float]] = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
        self.host.append((name, t0, time.perf_counter()))

    def total_s(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.host if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.host if n == name)


@dataclass
class View:
    spans: Spans
    window_s: float                          # the traced window, host clock
    work: int                                # work units in the window
    steps: int                               # whole steps in the window
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    annotations: List[Tuple[str, float, float]] = field(default_factory=list)
    window_us: Optional[Tuple[float, float]] = None   # profiler clock
    extra: Dict = field(default_factory=dict)         # the driver's counts

    def busy_us(self, lo: float, hi: float) -> float:
        """Union of the device operations' intervals clipped to [lo, hi]."""
        total, end = 0.0, lo
        for _, s, e in self.device_ops:
            s, e = max(s, end), min(e, hi)
            if e > s:
                total += e - s
                end = e
        return total

    def busy_in(self, name: str) -> float:
        """Device-busy microseconds inside the spans named `name`."""
        return sum(self.busy_us(s, e) for n, s, e in self.annotations
                   if n == PREFIX + name)

    def ops_in_window(self) -> List[Tuple[str, float, float]]:
        lo, hi = self.window_us
        return [op for op in self.device_ops if lo <= op[1] < hi]


def idle_percent(view: View) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in percent (None without a device trace)."""
    if view.window_us is None:
        return None
    lo, hi = view.window_us
    busy = view.busy_us(lo, hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))


def mfu_percent(view: View) -> Optional[float]:
    """The whole step's share of the H100's peak: the operations of the
    window's work, counted from shapes (`extra["flops_per_work"]`, by
    precision), each against the peak of its precision, over the traced
    window, in percent (None without a device trace or a count)."""
    from .roofline import peaks

    per = view.extra.get("flops_per_work")
    if view.window_us is None or not per or not view.work:
        return None
    lo, hi = view.window_us
    if view.busy_us(lo, hi) <= 0:
        return None
    ideal_s = sum(view.work * f / peaks.FLOPS[p] for p, f in per.items())
    return 100.0 * ideal_s / ((hi - lo) * 1e-6)


def collect(prof, spans: Spans, t_mark: float, window_s: float
            ) -> Tuple[list, list, Optional[Tuple[float, float]]]:
    """-> (device operations [(name, start_us, end_us)] sorted by start,
    the spans on the trace's clock [(PREFIX + name, start_us, end_us)],
    the window's interval) from a finished `torch.profiler.profile` whose
    window opened at host time `t_mark` with a marker kernel and closed
    with another, both on the stream of the window's work: the interval
    runs from the first marker's start to the second's, on the device's
    clock (the host's `window_s` long where the second is missing).
    Annotations that the profiler mirrors onto the device timeline are
    not operations."""
    ops = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        ops.append((ev.name, ev.time_range.start, ev.time_range.end))
    ops.sort(key=lambda op: op[1])
    marks = [op for op in ops if MARKER in op[0]]
    if not marks:
        return [], [], None
    start = marks[0][1]
    end = marks[-1][1] if len(marks) > 1 else start + window_s * 1e6
    ops = [op for op in ops if MARKER not in op[0]]

    def at(t):
        return start + (t - t_mark) * 1e6

    notes = [(PREFIX + n, at(t0), at(t1)) for n, t0, t1 in spans.host
             if t0 >= t_mark]
    window = (start, end)
    return ops, [(WINDOW, *window)] + notes, window


def breakdown(view: View, top: int = 10) -> Dict:
    """The device operations that took most time in the window, and its
    longest idle gaps named by the innermost benchmark span open on the
    host when the gap began."""
    totals: Dict[str, float] = {}
    ops = view.ops_in_window()
    for name, s, e in ops:
        totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    lo, hi = view.window_us
    end = lo
    for _, s, e in ops + [("", hi, hi)]:
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    gaps.sort(key=lambda g: -g[1])
    named = []
    for start, length in gaps[:top]:
        inside = [(e - s, n) for n, s, e in view.annotations
                  if s <= start < e and n != WINDOW]
        name = min(inside)[1][len(PREFIX):] if inside else "window"
        named.append([name, length * 1e-6])
    return {"device_ops": [[n[:96], v] for n, v in device_ops],
            "idle_gaps": named}
