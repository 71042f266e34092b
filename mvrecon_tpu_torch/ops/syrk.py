"""Packed lower-triangle SYRK S = YᵀY (kernel K1, hand-written for Hopper).

Counterpart of ``mvrecon_tpu/ops/pallas_syrk.py``. The reduced camera
system of a point chunk is ``Σ_p F_pᵀ E_p⁻¹ F_p = YᵀY`` with Y = L⁻¹F of
shape (3C, 9F). The product is symmetric, so ``syrk_lower`` computes only
the 512-tiles on and below the diagonal and ``mirror_lower`` completes
the square.

On a CUDA tensor ``syrk_lower`` launches the kernel in
``csrc/syrk_lower.cu`` (3xTF32 on the tensor cores, float32-accurate) or
raises; on a CPU tensor it runs the plain version
``syrk_lower_reference``.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 512
ROW_ALIGN = 32  # floats: rows of Y that start on 128-byte lines load fastest

# launches of each kernel of this module since the last reset
launch_counts = {"syrk_lower": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def padded_dim(n: int) -> int:
    """N rounded up to the 512-tile."""
    return -(-n // TILE) * TILE


def row_stride(n: int) -> int:
    """Row stride, in floats, at which K1 reads an (K, n) Y fastest: n
    rounded up to 128 bytes (PERF.md, Findings). A caller that builds Y
    itself lays it out so and hands ``syrk_lower`` the (K, n) view."""
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def lower_tile_mask(n: int, device=None) -> torch.Tensor:
    """(n, n) bool: True where the 512-tile row index is >= the tile column
    index, the part of the square that the SYRK kernels write."""
    tile = torch.arange(n, device=device) // TILE
    return tile[:, None] >= tile[None, :]


def syrk_lower_reference(y: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the lower 512-tiles of YᵀY, one 512-column band
    at a time, summed in float64 and rounded once (float64 for float64 Y,
    else float32). Returns (n_pad, n_pad) with zeros in the upper tiles."""
    k_rows, n = y.shape
    n_pad = padded_dim(n)
    out_dt = torch.float64 if y.dtype == torch.float64 else torch.float32
    y64 = torch.nn.functional.pad(y.to(torch.float64), (0, n_pad - n))
    out = torch.zeros((n_pad, n_pad), dtype=out_dt, device=y.device)
    for i in range(0, n_pad, TILE):
        out[i:i + TILE, :i + TILE] = (y64[:, i:i + TILE].T @ y64[:, :i + TILE]).to(out_dt)
    return out


def _syrk_lower_lib():
    from ._cuda_build import load

    fn = load("syrk_lower").syrk_lower_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def syrk_lower(y: torch.Tensor) -> torch.Tensor:
    """Y (K, N) -> a fresh (n_pad, n_pad) tensor whose lower 512-tiles hold
    YᵀY; n_pad is N rounded up to 512, and the columns past N count as
    zero. On the card the upper tiles are never written and hold whatever
    the allocation held; Y must be float32 with unit column stride, and
    the kernel reads it in place at its row stride, which must be a
    multiple of 4 floats (a contiguous Y whose N is not is copied first);
    it runs on the current stream. On the CPU the plain version runs."""
    if y.dim() != 2:
        raise ValueError(f"need Y (K, N), got shape {tuple(y.shape)}")
    if y.device.type == "cpu":
        return syrk_lower_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"Y on {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 Y, got {y.dtype}")
    k_rows, n = y.shape
    if n % 4 and y.is_contiguous():
        # the kernel moves Y's rows in 16-byte vectors
        y = torch.nn.functional.pad(y, (0, -n % 4))[:, :n]
    ld = y.stride(0)
    if y.stride(1) != 1 or ld < n or ld % 4 or y.data_ptr() % 16:
        raise ValueError(f"Y needs unit column stride, a row stride >= N that is a multiple "
                         f"of 4 and 16-byte alignment; got strides {y.stride()}")
    n_pad = padded_dim(n)
    out = torch.empty((n_pad, n_pad), dtype=torch.float32, device=y.device)
    fn = _syrk_lower_lib()
    err = fn(out.data_ptr(), y.data_ptr(), k_rows, n, ld,
             torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"syrk_lower kernel launch failed: cudaError {err}")
    launch_counts["syrk_lower"] += 1
    return out


def mirror_lower(lower: torch.Tensor, n: int) -> torch.Tensor:
    """Complete a ``syrk_lower`` result, cut to (n, n), from its element-wise
    lower triangle: the upper tiles are never read, and the result is
    exactly symmetric even where the kernel's rounding of a diagonal tile
    is not (the 3xTF32 route sums an entry's two cross products in the
    other order than its mirror's). For symmetric diagonal tiles this is
    the JAX package's tile mirror, bit for bit."""
    lo = lower[:n, :n]
    return torch.tril(lo) + torch.tril(lo, -1).T


def syrk(y: torch.Tensor) -> torch.Tensor:
    """S = YᵀY (N, N): the lower tiles by ``syrk_lower``, mirrored."""
    return mirror_lower(syrk_lower(y), y.shape[1])
