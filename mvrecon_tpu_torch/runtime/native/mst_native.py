"""ctypes binding of the native Kruskal walk (``mst.cpp``).

The library is compiled by ``g++ -O3 -shared -fPIC -std=c++17`` at first
use into ``build/native/`` at the repository root; its file name carries a
hash of the source and the flags, so an edited source is rebuilt and a
current one reused. Nothing is built when this module is imported. If the
build or the load fails, :func:`available` is False, :func:`build_error`
says why, and ``minimum_spanning_tree`` walks the edges in NumPy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mst.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_error: str | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmvrecon_mst-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native MST build failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native MST build failed: g++ exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _error, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    lib.mvrecon_kruskal.restype = ctypes.c_int64
    lib.mvrecon_kruskal.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native library is built and loaded: the MST then
    takes the native route."""
    return _load() is not None


def build_error() -> str | None:
    """Why the native route is unavailable (None when it is available or
    has not been tried)."""
    return _error


def kruskal(edges_i: np.ndarray, edges_j: np.ndarray, n_nodes: int) -> np.ndarray:
    """Kruskal over weight-sorted edges; returns the (n_edges,) uint8 mask
    of the edges in the tree. Raises ``RuntimeError`` without the native
    library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native MST library is unavailable: {_error}")
    ei = np.ascontiguousarray(edges_i, dtype=np.int64)
    ej = np.ascontiguousarray(edges_j, dtype=np.int64)
    if len(ei) != len(ej):
        raise ValueError("edges_i and edges_j must have equal length")
    # the C++ walk indexes its arrays by endpoint unchecked: validate here
    if len(ei) and (min(ei.min(), ej.min()) < 0 or max(ei.max(), ej.max()) >= n_nodes):
        raise ValueError(
            f"edge endpoints must lie in [0, {n_nodes}); got range "
            f"[{min(ei.min(), ej.min())}, {max(ei.max(), ej.max())}]")
    keep = np.zeros(len(ei), dtype=np.uint8)
    lib.mvrecon_kruskal(ei, ej, len(ei), int(n_nodes), keep)
    return keep
