"""Packed lower-triangle SYRK S = YᵀY (kernel K1, hand-written for Hopper).

Counterpart of ``mvrecon_tpu/ops/pallas_syrk.py``. The reduced camera
system of a point chunk is ``Σ_p F_pᵀ E_p⁻¹ F_p = YᵀY`` with Y = L⁻¹F of
shape (3C, 9F). The product is symmetric, so ``syrk_lower`` computes only
the 512-tiles on and below the diagonal and ``mirror_lower`` completes
the square. The chunked core's non-fused build sums the fresh lower-tile
outputs of its chunks into one accumulator and mirrors once at the end
(``syrk_lower_accumulate``, ``finish_syrk_accumulator``).

On a CUDA tensor ``syrk_lower`` launches the kernel in
``csrc/syrk_lower.cu`` (3xTF32 on ``wgmma``, float32-accurate) or raises;
on a CPU tensor it runs the plain version ``syrk_lower_reference``. The
kernel reads Y K-major: each column of Y contiguous, the layout of a
transposed row-major (N, ld) buffer, which is how the streamed path
writes it.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 512
ROW_ALIGN = 32  # floats: lines that start on 128-byte boundaries load fastest

# launches of each kernel of this module since the last reset
launch_counts = {"syrk_lower": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def padded_dim(n: int) -> int:
    """N rounded up to the 512-tile."""
    return -(-n // TILE) * TILE


def row_stride(n: int) -> int:
    """Stride, in floats, at which to lay out runs of n floats so that each
    starts on a 128-byte line: n rounded up to 32. The streamed path
    writes Yᵀ (N, K) in rows of ``row_stride(K)`` floats and hands
    ``syrk_lower`` its transpose, the K-major (K, N) view."""
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def _column_stride(y: torch.Tensor) -> int:
    """Floats between Y's columns as K1 is told them; a single column has
    none of its own, so it is given the stride the wrapper would lay out."""
    k_rows, n = y.shape
    return y.stride(1) if n > 1 else row_stride(k_rows)


def k_major(y: torch.Tensor) -> bool:
    """True if Y (K, N) lies as K1 reads it in place: each column
    contiguous, columns a multiple of 4 floats (16 bytes) apart and at
    least K apart. The kernel's TMA also needs a 16-byte-aligned start."""
    ld = _column_stride(y)
    return (y.stride(0) == 1 or y.shape[0] <= 1) and ld >= y.shape[0] and ld % 4 == 0


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
    zero. Y needs a unit stride along K or along N (else ValueError).

    On the card the upper tiles are never written and hold whatever the
    allocation held; Y must be float32. The kernel reads a K-major Y
    (``k_major``) in place, at its 16-byte-aligned start; any other Y is
    first copied into a K-major buffer with columns ``row_stride(K)``
    floats apart. It runs on the current stream. On the CPU the plain
    version runs."""
    if y.dim() != 2:
        raise ValueError(f"need Y (K, N), got shape {tuple(y.shape)}")
    k_rows, n = y.shape
    if not (y.stride(0) == 1 or k_rows <= 1 or y.stride(1) == 1 or n <= 1):
        raise ValueError(f"Y needs a unit stride along K or along N; got strides {y.stride()}")
    if y.device.type == "cpu":
        return syrk_lower_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"Y on {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 Y, got {y.dtype}")
    n_pad = padded_dim(n)
    if k_rows == 0:
        return torch.zeros((n_pad, n_pad), dtype=torch.float32, device=y.device)
    if not k_major(y) or y.data_ptr() % 16:
        cols = torch.empty((n, row_stride(k_rows)), dtype=y.dtype, device=y.device)
        cols[:, :k_rows].copy_(y.T)
        y = cols[:, :k_rows].T
    ld = _column_stride(y)
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
    is not (3xTF32 sums an entry's two cross products in the other order
    than its mirror's). For symmetric diagonal tiles this is
    the JAX package's tile mirror, bit for bit."""
    lo = lower[:n, :n]
    return torch.tril(lo) + torch.tril(lo, -1).T


def syrk(y: torch.Tensor) -> torch.Tensor:
    """S = YᵀY (N, N): the lower tiles by ``syrk_lower``, mirrored."""
    return mirror_lower(syrk_lower(y), y.shape[1])


def syrk_accumulator_dim(n: int) -> int:
    """Side of the accumulator that sums ``syrk_lower`` results of Y (K, n)
    over chunks: n rounded up to the 512-tile, on either device."""
    return padded_dim(n)


def syrk_lower_accumulate(acc: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """acc += the ``syrk_lower`` result of Y, in place: the deferred-mirror
    sum over point chunks. Only the element-wise lower triangle of acc is
    meaningful (the upper tiles sum whatever the kernel's fresh outputs
    held there); :func:`finish_syrk_accumulator` reads nothing else."""
    return acc.add_(syrk_lower(y))


def finish_syrk_accumulator(acc: torch.Tensor, n: int) -> torch.Tensor:
    """The full symmetric (n, n) sum from an accumulator of
    ``syrk_lower`` results: mirrored once, after all chunks."""
    return mirror_lower(acc, n)
