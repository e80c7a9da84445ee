"""Kernel times on the card and the least time the card could take.

Times come from CUDA events around a run of calls after a warm-up, on a
GPU; on the CPU (`--device cpu` runs of the probes) from the host clock,
which times PyTorch's CPU kernels and is no device figure. Bounds are the
larger of the bytes a function must move (each input read once, each output
written once) over the H100's memory rate and its operations over the peak
rate of the unit it uses.
"""

from __future__ import annotations

import statistics
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s,
# TF32 tensor-core FLOP/s (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `reps` calls of fn() between two CUDA events,
    after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, device: torch.device, reps: int, walls: int = 5,
              warmup: int = 2) -> float:
    """The median over `walls` runs of the mean ms per call of `reps`
    calls: CUDA events on a GPU, the host clock on the CPU."""
    if device.type == "cuda":
        times = [cuda_ms(fn, reps, warmup if k == 0 else 0)
                 for k in range(walls)]
    else:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(walls):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, walls: int = 5):
    """Device time per call without the host: `reps` calls of fn() captured
    in one CUDA graph, the median over `walls` replays between two CUDA
    events, per call. fn must not synchronise (no host reads of device
    values)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers' cudaFuncSetAttribute is no stream work
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(walls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float = 0.0,
             flops_per_s: float = FP32_FLOPS):
    """-> (ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def corr_bound_ms(f1, levels, ii, jj, xs, mask, flops_per_s=FP32_FLOPS):
    """The least time for the real edges' work of a correlation-window
    call: bytes (f1 rows of the distinct source frames, the padded levels
    of the distinct target frames, the slab starts, the output, each once)
    over the HBM rate, and the useful operations (2 C per output) over the
    rate of the unit the kernel uses (fp32 CUDA cores, or TF32 tensor cores
    for kernel 2b); -> (ms, "bytes" or "operations", bytes, flops)."""
    real = mask != 0
    E_real = int(real.sum())
    HW, C = f1.shape[1], f1.shape[2]
    L = len(levels)
    n_i = int(ii[real].unique().numel())
    n_j = int(jj[real].unique().numel())
    nbytes = (n_i * HW * C * 4 + n_j * sum(lv.shape[1] for lv in levels) * C
              * 4 + E_real * HW * L * 4 + E_real * HW * L * 64 * 4)
    flops = 2 * C * 64 * L * HW * E_real
    ms, by = bound_ms(nbytes, flops, flops_per_s)
    return ms, by, nbytes, flops
