"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into `build/lib<name>.so` next to this file, at first use,
then loaded with ctypes.  A library is rebuilt when its source is newer.
Nothing here runs at import time: the CPU tests import every module of the
port on a machine without `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNEL_SOURCES = ("segment_pool",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with nvcc on a machine with the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(SRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(source_path(name)))


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every stale library, one nvcc process per source, all started
    together.  Returns {name: compiler output} for the sources it compiled
    (ptxas prints registers, shared memory and spills per kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if stale."""
    if _stale(name):
        build([name])
    return ctypes.CDLL(library_path(name))
