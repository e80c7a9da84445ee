"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `_build/lib<name>-<hash>.so`
(a plain C interface; no PyTorch headers, so a build takes seconds), where
the hash covers the source text, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header never loads a stale library.
`build_all()` starts one nvcc per source at once and waits for all of
them. Nothing is built at import time: a wrapper calls
`load(name)` the first time it launches on a CUDA tensor.

Host libraries (`csrc/<name>.cpp`, today the marching-tetrahedra
polygoniser) build the same way with g++ into the same directory
(`load_host(name)`); they run on the CPU on every device.
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
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_SOURCES = ("mc_native",)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str, host: bool = False) -> str:
    """The library's path; its hash covers the source (`<name>.cu`, or
    `<name>.cpp` for a host library), every shared header in csrc/
    (`*.cuh`) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cpp" if host else f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(GXX_FLAGS if host else NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str, host: bool = False):
    """Start nvcc (g++ for a host library) for `name` unless its library
    exists; returns (process or None, tmp path, final path)."""
    out = library_path(name, host)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if host:
        cmd = [gxx_path(), *GXX_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cpp")]
    else:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = KERNEL_SOURCES,
              host: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every named source (CUDA `names`, host `host`) in parallel;
    -> {name: library path}. Raises RuntimeError with the compiler's
    output if any build fails."""
    started = {n: _start_build(n) for n in names}
    started.update({n: _start_build(n, host=True) for n in host})
    errors = []
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{proc.args[0]} failed for {proc.args[-1]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out for n, (_, _, out) in started.items()}


def gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: a C++ compiler is needed to "
                           "build the port's host libraries")
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `csrc/<name>.cpp`, built with g++ on first
    use; raises RuntimeError when it cannot be built."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is None:
        path = build_all([], host=[name])[name]
        lib = ctypes.CDLL(path)
        _loaded[key] = lib
    return lib
