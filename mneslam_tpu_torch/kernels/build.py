"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `_build/lib<name>-<hash>.so`
(a plain C interface; no PyTorch headers, so a build takes seconds), where
the hash covers the source text and the flags, so an edited source never
loads a stale library. `build_all()` starts one nvcc per source at once and
waits for all of them. Nothing is built at import time: a wrapper calls
`load(name)` the first time it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

KERNEL_SOURCES = ("scatter_add_rows", "corr_window", "corr_window_mma",
                  "scatter_rows_blocked", "scatter_rows_bucketed")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (process or None, tmp path, final path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel; -> {name: library path}.
    Raises RuntimeError with nvcc's output if any build fails."""
    started = {n: _start_build(n) for n in names}
    errors = []
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out for n, (_, _, out) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
