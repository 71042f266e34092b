"""Parity of the port's packed lower-triangle SYRK (``ops/syrk.py``, kernel
K1) with the JAX package's (``ops/pallas_syrk.py``, its Pallas kernel run
in interpret mode), on the same numpy inputs on the CPU, where the port's
``syrk_lower`` runs its plain version."""

import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.ops import pallas_syrk as jsy
from mvrecon_tpu_torch.ops import syrk as tsy

# the three cases of tests/test_pallas_syrk.py: (shape, JAX tiles, bf16 input)
CASES = {
    "aligned": ((384, 640), dict(tile_n=256, tile_k=128), False),
    "unaligned": ((100, 300), dict(tile_n=128, tile_k=64), False),
    "bf16": ((256, 384), dict(tile_n=128, tile_k=128), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_syrk_matches_jax_interpreted_kernel(case):
    """Both sides sum exact products (float32 products of bf16 inputs are
    exact too), in float32 there and in float64 here, so they differ by
    float32 rounding of sums of a few hundred terms: rtol 2e-5 / atol 1e-4,
    the JAX test's float32 tolerance. The bf16 case is also held against
    the float32 product of the unrounded Y at the bf16 tolerance of that
    test. The mirrored result is exactly symmetric by construction."""
    shape, tiles, bf16 = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    y = rng.normal(size=shape).astype(np.float32)
    y_j = jnp.asarray(y).astype(jnp.bfloat16) if bf16 else jnp.asarray(y)
    want = np.asarray(jsy.syrk(y_j, interpret=True, **tiles))
    y_t = torch.from_numpy(y)
    got = tsy.syrk(y_t.to(torch.bfloat16) if bf16 else y_t).numpy()
    assert got.dtype == np.float32 and got.shape == (shape[1], shape[1])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(got, got.T)
    if bf16:
        np.testing.assert_allclose(got, y.T @ y, rtol=5e-2, atol=5e-1)


def test_syrk_lower_cpu_pads_keeps_upper_zero_and_counts_no_launch():
    """(K, N) = (70, 600) -> (1024, 1024): lower tiles equal the float64
    product rounded once to float32 (to one float32 rounding: the float64
    sums run in another order), upper tiles stay zero, no kernel launch."""
    rng = np.random.default_rng(4)
    y = rng.normal(size=(70, 600))
    tsy.reset_launch_counts()
    got = tsy.syrk_lower(torch.from_numpy(y.astype(np.float32)))
    assert got.shape == (1024, 1024) and got.dtype == torch.float32
    y_pad = np.pad(y.astype(np.float32).astype(np.float64), ((0, 0), (0, 424)))
    want = (y_pad.T @ y_pad).astype(np.float32)
    lower = tsy.lower_tile_mask(1024).numpy()
    np.testing.assert_allclose(got.numpy()[lower], want[lower], rtol=1.2e-7, atol=1e-6)
    assert not got.numpy()[~lower].any()
    assert tsy.launch_counts["syrk_lower"] == 0
    with pytest.raises(ValueError):
        tsy.syrk_lower(torch.zeros(8))


def test_syrk_lower_float64_stays_float64():
    y = np.random.default_rng(5).normal(size=(30, 40))
    got = tsy.syrk(torch.from_numpy(y)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, y.T @ y, rtol=1e-14, atol=1e-12)


@pytest.mark.parametrize("n", [512, 700, 1536])
def test_mirror_lower_matches_jax_exactly(n):
    n_pad = tsy.padded_dim(n)
    a = np.random.default_rng(n).normal(size=(n_pad, n_pad)).astype(np.float32)
    lower = a + a.T  # symmetric diagonal tiles, as a SYRK leaves them
    lower[~tsy.lower_tile_mask(n_pad).numpy()] = np.nan  # never read
    want = np.asarray(jsy.mirror_lower(jnp.asarray(lower), n))
    got = tsy.mirror_lower(torch.from_numpy(lower), n).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got.T)


def test_mirror_lower_is_symmetric_for_unsymmetric_diagonal_tiles():
    """A kernel's diagonal tiles may differ from their transpose in the
    last bit; the completed matrix is still exactly symmetric, taken from
    the element-wise lower triangle."""
    n = 700
    a = np.random.default_rng(0).normal(size=(1024, 1024)).astype(np.float32)
    a[~tsy.lower_tile_mask(1024).numpy()] = np.nan
    got = tsy.mirror_lower(torch.from_numpy(a), n).numpy()
    lo = np.tril(a[:n, :n])
    np.testing.assert_array_equal(got, lo + np.tril(lo, -1).T)
    np.testing.assert_array_equal(got, got.T)


def test_chip_smoke_bound_counts_the_used_triangle():
    """The bound of K1 that the chip check reports counts the work of the
    element-wise lower triangle over the real columns, the part of YᵀY that
    ``mirror_lower`` reads, not the padded 512-tiles the kernel covers."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    k_rows, n = 7, 700
    entries = np.tril(np.ones((n, n))).sum()
    flops, nbytes = chip_smoke.syrk_lower_work(k_rows, n)
    assert flops == 2 * k_rows * entries
    assert nbytes == 4 * (k_rows * n + entries)
    flops, _ = chip_smoke.syrk_lower_work(3 * 16384, 9 * 500)
    assert flops == 4500 * 4501 * 49152
    assert flops < 2 * 49152 * 512**2 * 45  # the padded tile pairs' work


def test_syrk_lower_of_a_row_strided_view_reads_only_its_columns():
    """A row-major (K, N) view of rows ``row_stride(N)`` floats apart
    (128-byte multiples), which the card copies into K1's K-major layout:
    the columns between N and the stride hold whatever the allocation held
    and must not reach the result."""
    n = 999
    assert tsy.row_stride(n) == 1024 and tsy.row_stride(4500) == 4512
    assert tsy.row_stride(4512) == 4512
    rows = np.random.default_rng(6).normal(size=(70, tsy.row_stride(n))).astype(np.float32)
    view = torch.from_numpy(rows)[:, :n]
    got = tsy.syrk(view).numpy()
    want = tsy.syrk(torch.from_numpy(np.ascontiguousarray(rows[:, :n]))).numpy()
    np.testing.assert_array_equal(got, want)


def _k_major(k_rows, n, seed):
    """Y (k_rows, n) as the streamed path lays it out: the transpose of an
    (n, row_stride(k_rows)) buffer, whose other columns hold noise."""
    buf = np.random.default_rng(seed).normal(size=(n, tsy.row_stride(k_rows)))
    return torch.from_numpy(buf.astype(np.float32))[:, :k_rows].T


@pytest.mark.parametrize("shape", [(300, 999), (333, 640), (1, 5), (7, 1)])
def test_syrk_lower_of_a_k_major_view_matches_contiguous(shape):
    """K1 reads Y K-major; on the CPU such a view gives the same bits as a
    contiguous copy, and only its own rows reach the result."""
    y = _k_major(*shape, seed=sum(shape))
    assert y.stride(0) == 1 or shape[0] == 1
    assert tsy.k_major(y)
    got = tsy.syrk(y).numpy()
    want = tsy.syrk(y.contiguous()).numpy()
    np.testing.assert_array_equal(got, want)


def test_k_major_layout_rule():
    """In place on the card: unit stride along K, columns at least K and a
    multiple of 4 floats apart; anything else with a unit stride is copied
    into that layout by the wrapper."""
    assert tsy.k_major(_k_major(300, 999, 0))
    assert tsy.k_major(torch.zeros(999, 300).T)            # columns 300 apart
    assert not tsy.k_major(torch.zeros(999, 301).T)        # 301 is no multiple of 4
    assert not tsy.k_major(torch.zeros(300, 999))          # row-major
    assert tsy.k_major(torch.zeros(999, 304)[:, :300].T[:200])  # fewer rows, same columns
    assert not tsy.k_major(torch.zeros(64).as_strided((8, 4), (1, 4)))  # columns overlap


@pytest.mark.parametrize("view", ["every other row and column", "column slice of a transpose"])
def test_syrk_lower_rejects_views_without_a_unit_stride(view):
    base = torch.zeros(64, 64)
    y = base[::2, ::2] if view.startswith("every") else base.T[::2, ::3]
    assert 1 not in y.stride()
    tsy.reset_launch_counts()
    with pytest.raises(ValueError, match="unit stride"):
        tsy.syrk_lower(y)
    with pytest.raises(ValueError, match="unit stride"):
        tsy.syrk(y)
    assert tsy.launch_counts["syrk_lower"] == 0


def _trunc_tf32(a):
    """What the tensor cores read of a float32: its top 19 bits."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _rna_tf32(a):
    """cvt.rna.tf32.f32: to the nearest TF32, ties away from zero."""
    u = a.view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("shape", [(300, 1000), (384, 999)])
def test_3xtf32_split_of_k1_keeps_float32_accuracy(shape):
    """A plain model of K1's arithmetic: big = the top 19 bits of each
    float (what wgmma reads), small = the TF32-rounded remainder (what the
    consumers write), and the products small*big, big*small, big*big
    (exact in float32) summed in float64. Against the float64 product it
    stays under 1e-6 of the largest entry of the lower tiles."""
    rng = np.random.default_rng(shape[1])
    y = rng.normal(size=shape).astype(np.float32)
    big = _trunc_tf32(y)
    small = _rna_tf32(y - big)
    assert np.all(_trunc_tf32(small) == small)
    assert np.all(np.abs(y - big - small) <= np.abs(y) * 2.0**-20)
    b64, s64 = big.astype(np.float64), small.astype(np.float64)
    model = s64.T @ b64 + b64.T @ s64 + b64.T @ b64
    want = tsy.syrk_lower_reference(torch.from_numpy(y)).numpy()
    n = shape[1]
    lower = tsy.lower_tile_mask(want.shape[0]).numpy()[:n, :n]
    scale = np.abs(want[:n, :n][lower]).max()
    err = np.abs(model - want[:n, :n])[lower].max()
    assert err < 1e-6 * scale
    # one TF32 product alone is ~1e3 times further off
    one = (b64.T @ b64 - want[:n, :n])[lower]
    assert np.abs(one).max() > 100 * err
