"""H100 ablation of the row scatters' cluster design: where its time goes.

    python3 chip_smoke.py        # writes output/chip_smoke/real_stream.pt
    python -m mneslam_tpu_torch.tools.scatter_ablation [--stream PATH]

Builds the cluster kernels of `kernels/csrc/scatter_rows_blocked.cu` and
`scatter_rows_bucketed.cu` again, into a temporary directory, with one
part changed at a time (VARIANTS):

  base      as the port builds them
  t1024     1024 threads a block (16 warps more per block)
  ahead8    8 rows of vals loaded before they are added (4 in base)
  noadd     the adds into shared memory skipped: results wrong, time only
  noload    the rows of vals replaced by a constant: results wrong
  nowalk    the bucketed kernel walks no update (zero, sync, store only):
            results wrong

and times each with CUDA graphs (K calls in one graph, the median of 5
replays) on the mapping path's real index stream: the six calls of one
mapping iteration that `chip_smoke.py` phase 11 saves (indices and table
sizes; the values are normal at width 128, made from a seed, as the
smoke's are). The blocked kernel gets the updates in their order, the
bucketed kernel sorted (with its permutation, and presorted). A base
result that disagrees with `index_add_` fails the run. It also counts, in
the SASS of the base build (`cuobjdump`), the compare-and-swap loops that
the fp32 adds into shared memory compile to. Each line gives the sum over
the six calls; the last line is a JSON dict with every call's times. Needs
a GPU and nvcc; raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, Sequence

import torch

from ..kernels import build
from ..kernels.scatter_add_rows import scatter_add_rows_plain
from .measure import graph_ms

WIDTH = 128
SOURCES = ("scatter_rows_blocked", "scatter_rows_bucketed")
CONFIGS = ((224, 4), (224, 16))     # T, CL
# (file, text, replacement) of each variant; every text must be found
VARIANTS = {
    "base": (),
    "t1024": (("scatter_cluster.cuh", "kThreads = 512", "kThreads = 1024"),),
    "ahead8": (("scatter_cluster.cuh", "kAhead = 4", "kAhead = 8"),),
    "noadd": (("scatter_cluster.cuh", "if (c < width) atomicAdd(",
               "if (c < width && acc[k] == 12345.f) atomicAdd("),),
    "noload": (("scatter_cluster.cuh",
                "? to_float(vals[src[u] * width + c])",
                "? (float)(src[u] & 7)"),),
    "nowalk": (("scatter_rows_bucketed.cu",
                "const int64_t n = off[bucket + 1] - lo;",
                "const int64_t n = 0 * (off[bucket + 1] - lo);"),),
}
K = 20
STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "output", "chip_smoke", "real_stream.pt")


def _build(tmp: str) -> Dict:
    """Every variant of both sources, compiled in parallel ->
    {(variant, source): loaded library}."""
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(build.CSRC, d)
        for fname, text, repl in subs:
            path = os.path.join(d, fname)
            src = open(path).read()
            if text not in src:
                raise RuntimeError(f"variant {name}: {text!r} not in {fname}")
            with open(path, "w") as f:
                f.write(src.replace(text, repl))
        for source in SOURCES:
            out = os.path.join(d, f"lib{source}.so")
            procs[name, source] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out,
                 os.path.join(d, f"{source}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(out)
    return libs


def cas_loops(lib_path: str) -> int:
    """The compare-and-swap loops (CAST.SPIN) in a library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    return sass.count("CAST.SPIN")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def run(stream: str = STREAM, log=print) -> Dict:
    """Build, check and time every variant on the saved real stream ->
    {"device", "cas_loops": {source: loops}, "T<T>C<CL>/<variant>":
    {kernel: ms summed over the calls}, "<tag>/T<T>C<CL>/<variant>":
    {kernel: ms}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation needs a GPU: "
                           "torch.cuda.is_available() is False")
    saved = torch.load(stream)
    v, i = ctypes.c_void_p, ctypes.c_int64
    results: Dict = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(tmp)
        results["cas_loops"] = {
            s: cas_loops(os.path.join(tmp, "base", f"lib{s}.so"))
            for s in SOURCES}
        log(f"compare-and-swap loops in the base SASS: "
            f"{results['cas_loops']}")
        for seed, (tag, idx, n_rows) in enumerate(saved):
            idx = idx.cuda()
            nu, is64 = idx.shape[0], int(idx.dtype == torch.int64)
            g = torch.Generator(device="cuda").manual_seed(seed)
            vals = torch.randn((nu, WIDTH), generator=g, device="cuda")
            ref = scatter_add_rows_plain(idx, vals, n_rows)
            tol = 5e-5 * scatter_add_rows_plain(idx, vals.abs(),
                                                n_rows) + 1e-6
            idx_s, perm = torch.sort(idx, stable=True)
            vals_s = vals[perm].contiguous()
            out = torch.empty((n_rows, WIDTH), device="cuda")
            log(f"{tag}: {nu} updates into {n_rows} rows")
            for t, cl in CONFIGS:
                nb = -(-n_rows // (t * cl))
                off = torch.searchsorted(idx_s, torch.arange(
                    nb + 1, dtype=idx_s.dtype, device="cuda") * (t * cl))
                for name in VARIANTS:
                    fb = libs[name, SOURCES[0]].scatter_rows_blocked_cluster
                    fb.argtypes = [v] * 3 + [i] * 7 + [v]
                    fk = libs[name, SOURCES[1]].scatter_rows_bucketed_cluster
                    fk.argtypes = [v] * 5 + [i] * 6 + [v]

                    calls = {
                        "blocked": lambda: fb(
                            idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                            nu, WIDTH, n_rows, t, cl, 0, is64, stream_ptr()),
                        "bucketed": lambda: fk(
                            off.data_ptr(), idx_s.data_ptr(),
                            perm.data_ptr(), vals.data_ptr(), out.data_ptr(),
                            WIDTH, n_rows, t, cl, 0, is64, stream_ptr()),
                        "presorted": lambda: fk(
                            off.data_ptr(), idx_s.data_ptr(), None,
                            vals_s.data_ptr(), out.data_ptr(), WIDTH,
                            n_rows, t, cl, 0, is64, stream_ptr())}
                    times = {}
                    for kernel, fn in calls.items():
                        if name == "nowalk" and kernel == "blocked":
                            continue
                        err = fn()
                        torch.cuda.synchronize()
                        if err != 0:
                            raise RuntimeError(f"{name} {kernel} T{t}C{cl}: "
                                               f"cudaError {err}")
                        if name == "base" and not bool(
                                ((out - ref).abs() <= tol).all()):
                            raise RuntimeError(f"base {kernel} T{t}C{cl} "
                                               f"disagrees on {tag}")
                        times[kernel] = graph_ms(fn, K)
                    results[f"{tag}/T{t}C{cl}/{name}"] = times
                    total = results.setdefault(f"T{t}C{cl}/{name}", {})
                    for kernel, ms in times.items():
                        total[kernel] = total.get(kernel, 0.0) + ms
    for key, total in results.items():
        if key.count("/") == 1:
            log(f"sum of {len(saved)} calls {key:14s} " + "  ".join(
                f"{k} {ms:.4f} ms" for k, ms in total.items()))
    return results


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", default=STREAM,
                    help="the real index stream that chip_smoke.py saves "
                         "(default: output/chip_smoke/real_stream.pt)")
    print(json.dumps(run(ap.parse_args(argv).stream)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
