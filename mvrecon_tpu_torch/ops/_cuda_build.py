"""Builds the port's hand-written CUDA kernels at first use and loads them.

Each source under ``mvrecon_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, in
``build/kernels/`` at the repository root, and loaded with ``ctypes``. The
library's file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header is rebuilt
and a current one is reused. The kernels take ``cuTensorMapEncodeTiled``
through ``cudaGetDriverEntryPointByVersion``, so nothing links
``-lcuda``. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# kernel name -> source file under csrc/
SOURCES = {"syrk_acc": "syrk_acc.cu", "syrk_lower": "syrk_lower.cu"}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> float:
    """Compile the named kernels (all of them by default) unless they are
    already built, one ``nvcc`` per source, all started together. Returns
    the seconds taken; raises with the compiler's output if a build
    fails."""
    start = time.perf_counter()
    jobs = []
    for name in names or tuple(SOURCES):
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"kernel build of {name} failed: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
