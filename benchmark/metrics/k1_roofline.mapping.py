"""Kernel 1 (`kernels/scatter_add_rows`) against its bound: the least time
of a call (each update's index and values read once, each touched row
written once, at the H100's memory rate), averaged over the traced calls,
over the device time of a kernel-1 launch, averaged over the launches in
the trace, in percent. With every launch in the trace this is the bound
summed over the calls over the device time summed over the launches; a
trace that lost some launches' records still reads the same ratio."""

from benchmark.roofline import peaks

NAME = "scatter_add_rows"


def read(view):
    if view.window_us is None:
        return None
    kernels = [op for op in view.ops_in_window() if NAME in op[0]]
    calls = view.extra.get("k1_bytes", [])
    if not kernels or not calls:
        return None
    device_s = sum(e - s for _, s, e in kernels) * 1e-6 / len(kernels)
    bound = sum(peaks.bound_s(b) for b in calls) / len(calls)
    return 100.0 * bound / device_s
