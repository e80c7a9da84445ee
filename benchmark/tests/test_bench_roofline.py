"""The roofline and FLOP counts on hand-worked shapes, and the readers on a
hand-made trace."""

import math
import types

import pytest
import torch

from benchmark import harness, trace
from benchmark.roofline import counts, peaks

CFG = harness.find_cell(harness.load_benchmark(),
                        "room0.mapping")["config_file"]["config"]


def test_scatter_rows_bytes():
    # 10 updates of 4 floats with int64 indices into 3 touched rows:
    # 10 * (16 + 8) read, 3 * 16 written
    assert counts.scatter_rows_bytes(10, 4, 4, 8, 3) == 240 + 48


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 495e12, "tf32") == pytest.approx(2.0)


def test_decoder_dims_at_replica_widths():
    sdf, col = counts.decoder_dims(CFG)
    assert sdf == [112, 32, 16] and col == [63, 32, 3]


def test_query_flops_by_hand():
    # per point: 6 planes x (8 + 8 x 32), 2 levels x 2 x 32 sums,
    # 48 bins x 6; the decoders 2 (112 x 32 + 32 x 16 + 63 x 32 + 32 x 3)
    per = 6 * (8 + 256) + 128 + 288 + 2 * (3584 + 512 + 2016 + 96)
    assert counts.query_flops(CFG, 10) == 10 * per


def test_mapping_iteration_flops_by_hand():
    n = 2148 * 43
    fwd = counts.query_flops(CFG, n) + 20 * n
    bwd = 2 * 2 * n * (3584 + 512 + 2016 + 96) + n * 6 * 8 * 32 + 40 * n
    got = counts.mapping_iteration_flops(CFG, 1000)["fp32"]
    assert got == fwd + bwd + 12 * 1000


def test_alignment_flops_by_hand():
    n = 2048 * 256
    render = counts.query_flops(CFG, n) + 20 * n
    back = n * (3584 + 512 + 2016 + 96) * 2 + n * 6 * 12 * 32 + 40 * n
    assert counts.alignment_flops(CFG, 2048, 100)["fp32"] == \
        render + 100 * (render + back)


def _view(ops, notes=(), work=10, extra=None):
    spans = trace.Spans(False, harness.torch.device("cpu"))
    return trace.View(spans=spans, window_s=1.0, work=work, steps=1,
                      device_ops=sorted(ops, key=lambda o: o[1]),
                      annotations=[(trace.WINDOW, 0.0, 1e6)] + list(notes),
                      window_us=(0.0, 1e6), extra=extra or {})


def test_idle_reads_the_union_of_intervals():
    view = _view([("a", 0.0, 2e5), ("b", 1e5, 3e5), ("c", 5e5, 6e5)])
    assert harness.reader("device_idle.mapping")(view) == \
        pytest.approx(60.0)


@pytest.mark.parametrize("calls,mean_bytes", [
    ([1_000_000, 2_000_000], 1.5e6),               # every launch traced
    ([1_000_000, 2_000_000, 3_000_000], 2e6),      # one launch's record lost
])
def test_k1_roofline_reads_bound_over_kernel_time(calls, mean_bytes):
    ops = [("void scatter_add_rows_kernel<long, float>", 0.0, 10.0),
           ("void scatter_add_rows_kernel<long, float>", 20.0, 30.0),
           ("elementwise", 40.0, 50.0)]
    view = _view(ops, extra={"k1_bytes": calls})
    bound = mean_bytes / peaks.HBM_BYTES_PER_S
    assert harness.reader("k1_roofline.mapping")(view) == \
        pytest.approx(100 * bound / 10e-6)


class _Event:
    def __init__(self, name, start, end):
        self.name = name
        self.device_type = torch.autograd.DeviceType.CUDA
        self.time_range = types.SimpleNamespace(start=start, end=end)


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("end_marker,window", [(True, (100.0, 1000.0)),
                                               (False, (100.0, 600.0))])
def test_window_runs_between_the_markers(end_marker, window):
    events = [_Event(trace.MARKER, 100.0, 101.0), _Event("k", 150.0, 160.0),
              _Event("k", 900.0, 950.0), _Event("k", 1100.0, 1200.0)]
    if end_marker:
        events.append(_Event(trace.MARKER, 1000.0, 1001.0))
    spans = trace.Spans(False, torch.device("cpu"))
    ops, _, got = trace.collect(_Profile(events), spans, 0.0, 5e-4)
    assert got == window and all(trace.MARKER not in o[0] for o in ops)


def test_readers_find_nothing_on_an_empty_trace():
    view = _view([], extra={"k1_bytes": []})
    for name in ("k1_roofline.mapping", "device_idle.closure",
                 "mfu.mapping", "map_launches_per_iter.mapping"):
        assert harness.reader(name)(view) is None, name


def test_mfu_reads_counted_work_over_window():
    view = _view([("k", 0.0, 1e5)], work=4,
                 extra={"flops_per_work": {"fp32": 67e9}})
    # 4 x 67e9 operations at 67e12 / s is 4 ms of a 1 s window
    assert harness.reader("mfu.mapping")(view) == pytest.approx(0.4)


def test_launches_and_device_ms_per_iteration():
    ops = [("k", float(i), float(i) + 0.5) for i in range(0, 100, 10)]
    notes = [(trace.PREFIX + "step", 0.0, 1e6),
             (trace.PREFIX + "teacher", 0.0, 25.0)]
    view = _view(ops, notes, work=1, extra={"iterations_per_step": 5})
    assert harness.reader("align_launches_per_iter.closure")(view) == 2.0
    # 10 ops of 0.5 us, 3 of them inside the teacher span
    assert harness.reader("align_device_ms_per_iter.closure")(view) == \
        pytest.approx(1e-3 * 3.5 / 5)


def test_breakdown_names_gaps_by_the_open_span():
    notes = [(trace.PREFIX + "step", 0.0, 1e6),
             (trace.PREFIX + "optimize", 1e5, 5.5e5)]
    view = _view([("k", 0.0, 2e5), ("k", 5e5, 6e5)], notes)
    b = trace.breakdown(view)
    assert b["device_ops"][0][0] == "k"
    assert b["device_ops"][0][1] == pytest.approx(0.3)
    assert b["idle_gaps"][0] == ["step", pytest.approx(0.4)]
    assert b["idle_gaps"][1] == ["optimize", pytest.approx(0.3)]
    assert all(math.isfinite(g[1]) for g in b["idle_gaps"])
