#!/usr/bin/env python3
"""Run one cell of the benchmark of `mneslam_tpu_torch` once.

    python3 benchmark/run.py --workload room0.mapping --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. Prints the compared numbers, each beside its limit, as the last
lines of standard error, and one JSON object as the last line of standard
output: the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics (and the trace's breakdown) with `--trace 1`. Prints no result
and exits with 2 without the devices or with JAX or the JAX package
loaded, and with the import's error without the program beside the
benchmark.

Build and kernel caches stay inside the checkout at fixed paths: the
program's CUDA libraries in `mneslam_tpu_torch/kernels/_build/`, Triton's
and PyTorch's extension caches under `benchmark/.cache/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import torch
        torch.set_num_threads(2)
        from benchmark import harness
    except ImportError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    args.t_start = T_START
    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
