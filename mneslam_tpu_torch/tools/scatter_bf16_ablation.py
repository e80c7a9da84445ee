"""H100 ablation of kernel 1's bf16 route: where its time goes.

    python3 chip_smoke.py    # writes output/chip_smoke/real_stream_bf16.pt
    python -m mneslam_tpu_torch.tools.scatter_bf16_ablation [--stream PATH]

Builds `kernels/csrc/scatter_add_rows.cu` again, into a temporary
directory, with one part changed at a time (VARIANTS):

  base          as the port builds it
  plain_stores  launch A writes the bf16 zeros with plain stores, not
                evict-first ones (`__stcs`)
  scalar_acc    launch A accumulates with kernel 1's scalar body at every
                width (no float4 atomics)
  acc_only      launch B left out: results wrong, time only
  zero_only     launch A's accumulate blocks left out (launch B then finds
                no flag): results wrong, time only

and times each variant's `scatter_add_rows_bf16_once` with CUDA graphs (K
calls in one graph, the median of 5 replays) on the bf16 mapping path's
real index stream: the six calls of one bf16 iteration that
`chip_smoke.py` phase 13c saves (indices and table sizes; the values are
normal at width 128 in bf16, made from a seed). Beside them: the staged
route of the first port (`scatter_add_rows_bf16_staged`) the same way, and
the base build's time by launch from torch.profiler. A base result that
disagrees with the plain version, or leaves the workspace non-zero, fails
the run. Each line gives the sum over the six calls; the last line is a
JSON dict with every call's times. Needs a GPU and nvcc; raises without
them.
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
from ..kernels.scatter_add_rows import (scatter_add_rows_bf16_staged,
                                        scatter_add_rows_plain)
from .measure import graph_ms

WIDTH = 128
SOURCE = "scatter_add_rows"
# (text, replacement) of each variant in SOURCE; every text must be found
VARIANTS = {
    "base": (),
    "plain_stores": (("__stcs(o + i, make_uint4(0u, 0u, 0u, 0u));",
                      "o[i] = make_uint4(0u, 0u, 0u, 0u);"),),
    "scalar_acc": (("if (width % 4 == 0 && reinterpret_cast<uintptr_t>"
                    "(vals) % 8 == 0)", "if (false)"),),
    "acc_only": (("if (err != 0 || nu == 0) return err;", "return err;"),),
    "zero_only": (("nu > 0 ? accumulate_blocks<kProductionRowsPerWarp>"
                   "(nu) : 0;", "0;"),),
}
WRONG = ("acc_only", "zero_only")     # time only
K = 10
STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "output", "chip_smoke",
    "real_stream_bf16.pt")


def _build(tmp: str) -> Dict[str, ctypes.CDLL]:
    """Every variant, compiled in parallel -> {variant: loaded library}."""
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(build.CSRC, d)
        path = os.path.join(d, f"{SOURCE}.cu")
        src = open(path).read()
        for text, repl in subs:
            if text not in src:
                raise RuntimeError(f"variant {name}: {text!r} not in "
                                   f"{SOURCE}.cu")
            src = src.replace(text, repl)
        with open(path, "w") as f:
            f.write(src)
        out = os.path.join(d, f"lib{SOURCE}.so")
        procs[name] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(out)
        v, i = ctypes.c_void_p, ctypes.c_int64
        lib.scatter_add_rows_bf16_once.argtypes = [v, i] + [v] * 4 \
            + [i] * 3 + [v]
        libs[name] = lib
    return libs


def by_launch(fn, reps: int = K) -> Dict[str, float]:
    """Device ms per call of fn() by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "")
            .replace("void ", "", 1).split("(")[0]:
            1e-3 * e.self_device_time_total / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def run(stream: str = STREAM, log=print) -> Dict:
    """Build, check and time every variant on the saved stream ->
    {"device", "<variant>" / "staged": ms summed over the calls,
    "base_by_launch": {kernel: ms summed}, "<tag>/<variant>": ms}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation needs a GPU: "
                           "torch.cuda.is_available() is False")
    saved = torch.load(stream)
    max_rows = max(n_rows for _, _, n_rows in saved)
    ws = torch.zeros(max_rows * WIDTH, device="cuda")
    flags = torch.zeros(max_rows, dtype=torch.int32, device="cuda")
    results: Dict = {"device": torch.cuda.get_device_name(0),
                     "base_by_launch": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(tmp)
        for seed, (tag, idx, n_rows) in enumerate(saved):
            idx = idx.cuda()
            nu, is64 = idx.shape[0], int(idx.dtype == torch.int64)
            g = torch.Generator(device="cuda").manual_seed(seed)
            vals = torch.randn((nu, WIDTH), generator=g,
                               device="cuda").to(torch.bfloat16)
            ref = scatter_add_rows_plain(idx, vals, n_rows).float()
            tol = (5e-5 * scatter_add_rows_plain(idx, vals.float().abs(),
                                                 n_rows) + 1e-6
                   + 2.0 ** -7 * ref.abs())
            out = torch.empty((n_rows, WIDTH), dtype=torch.bfloat16,
                              device="cuda")
            log(f"{tag}: {nu} updates into {n_rows} rows")
            for name, lib in libs.items():
                def fn(lib=lib):
                    return lib.scatter_add_rows_bf16_once(
                        idx.data_ptr(), is64, vals.data_ptr(), ws.data_ptr(),
                        flags.data_ptr(), out.data_ptr(), nu, WIDTH, n_rows,
                        torch.cuda.current_stream().cuda_stream)

                err = fn()
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
                if name == "base" and not (
                        bool(((out.float() - ref).abs() <= tol).all())
                        and not ws.any() and not flags.any()):
                    raise RuntimeError(f"base disagrees on {tag} or leaves "
                                       f"the workspace non-zero")
                ms = graph_ms(fn, K)
                if name in WRONG:            # back to a zero workspace
                    ws.zero_()
                    flags.zero_()
                results[f"{tag}/{name}"] = ms
                results[name] = results.get(name, 0.0) + ms
                if name == "base":
                    for kernel, t in by_launch(fn).items():
                        total = results["base_by_launch"]
                        total[kernel] = total.get(kernel, 0.0) + t
            ms = graph_ms(lambda: scatter_add_rows_bf16_staged(
                idx, vals, n_rows), K)
            results[f"{tag}/staged"] = ms
            results["staged"] = results.get("staged", 0.0) + ms
    for name in [*VARIANTS, "staged"]:
        log(f"sum of {len(saved)} calls {name:13s} {results[name]:.4f} ms"
            + (" (results wrong: time only)" if name in WRONG else ""))
    log("base by launch (profiler, summed): " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in results["base_by_launch"].items()))
    return results


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream", default=STREAM,
                    help="the bf16 path's index stream that chip_smoke.py "
                         "saves (default: "
                         "output/chip_smoke/real_stream_bf16.pt)")
    print(json.dumps(run(ap.parse_args(argv).stream)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
