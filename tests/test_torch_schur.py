"""Parity of the port's fused Schur build (``ops/fused_schur.py``) with the
JAX package's (``ops/pallas_schur.py``, its Pallas kernel run in interpret
mode), on the same numpy inputs on the CPU, where the port's ``syrk_acc``
runs its plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment import BAState as JState
from mvrecon_tpu.models.bundle_adjustment import gauge_mask as j_gauge_mask
from mvrecon_tpu.models.bundle_adjustment import normalize_gauge as j_normalize_gauge
from mvrecon_tpu.ops import pallas_schur as jps
from mvrecon_tpu_torch.interop import ba_state_from_numpy
from mvrecon_tpu_torch.ops import fused_schur as tps
from mvrecon_tpu_torch.ops.syrk import lower_tile_mask


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jps, "_MODE", "interpret")


def _bf16_y(k_rows, n, seed):
    """A (k_rows, n) bf16 matrix as numpy float32 holding bf16 values."""
    y = np.random.default_rng(seed).standard_normal((k_rows, n)).astype(np.float32)
    return np.array(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))


def test_syrk_acc_reference_matches_jax_kernel(interpret):
    """The device-test shape: nf = 96 -> n_acc = 4608, Y (384, 4608) bf16,
    two accumulations; lower tiles to 1e-6 of the largest entry (bf16
    products are exact in float32, only the summation order differs)."""
    _, n_acc = jps.schur_acc_dim(96)
    y = _bf16_y(384, n_acc, seed=0)
    acc_j = jnp.zeros((n_acc, n_acc), jnp.float32)
    y_j = jnp.asarray(y, jnp.bfloat16)
    acc_j = jps.syrk_acc(jps.syrk_acc(acc_j, y_j), y_j)
    acc_t = torch.zeros((n_acc, n_acc), dtype=torch.float32)
    y_t = torch.from_numpy(y).to(torch.bfloat16)
    tps.syrk_acc(tps.syrk_acc(acc_t, y_t), y_t)

    lower = lower_tile_mask(n_acc).numpy()
    want = np.asarray(acc_j)[lower]
    got = acc_t.numpy()[lower]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_syrk_acc_cpu_keeps_upper_tiles_and_counts_no_launch():
    n = 2 * tps.TILE
    rng = np.random.default_rng(3)
    acc0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    y = torch.from_numpy(_bf16_y(40, n, seed=4)).to(torch.bfloat16)
    tps.reset_launch_counts()
    acc = tps.syrk_acc(acc0.clone(), y)
    upper = ~lower_tile_mask(n)
    assert torch.equal(acc[upper], acc0[upper])
    y32 = y.float()
    lower = ~upper
    torch.testing.assert_close(acc[lower], (acc0 + y32.T @ y32)[lower], rtol=1e-6, atol=1e-4)
    assert tps.launch_counts["syrk_acc"] == 0
    with pytest.raises(ValueError):
        tps.syrk_acc(torch.zeros((n + 8, n + 8)), torch.zeros((4, n + 8)))


@pytest.mark.parametrize("k_rows", [1, 63, 300])
def test_syrk_acc_rows_off_the_stage_match_jax(interpret, k_rows):
    """K2 streams Y in 64-row stages and reads rows past k_rows as zero;
    the wrapper's contract has no row multiple. At k_rows that are none
    the port's CPU path and the JAX kernel (interpreted) agree on the lower
    tiles, and the port leaves the upper ones untouched."""
    n = 2 * tps.TILE
    rng = np.random.default_rng(k_rows)
    acc0 = rng.standard_normal((n, n)).astype(np.float32)
    y = _bf16_y(k_rows, n, seed=k_rows + 1)
    want = np.asarray(jps.syrk_acc(jnp.asarray(acc0), jnp.asarray(y, jnp.bfloat16)))
    got = tps.syrk_acc(torch.from_numpy(acc0.copy()), torch.from_numpy(y).to(torch.bfloat16))
    lower = lower_tile_mask(n).numpy()
    scale = np.abs(want[lower]).max()
    np.testing.assert_allclose(got.numpy()[lower], want[lower], rtol=0, atol=2e-6 * scale)
    np.testing.assert_array_equal(got.numpy()[~lower], acc0[~lower])


def _chunk_problem(n_pts=64, nf=6, visibility=False):
    """One chunk of a synthetic scene in the normalized gauge, as numpy
    float32: camera fields, points, observations, visibility."""
    scene = make_synthetic_scene(
        jax.random.key(1), n_images=nf, n_slices=-(-n_pts // 20), n_angles=20,
        dtype=jnp.float32, noise=0.003,
    )
    X0, R0, t0, _ = j_normalize_gauge(scene.X, scene.R, scene.t, "x-up_z-forward")
    rng = np.random.default_rng(5)
    X_c = np.asarray(X0[:n_pts]) + 0.01 * rng.standard_normal((n_pts, 3)).astype(np.float32)
    vis = (rng.uniform(size=(n_pts, nf)) > 0.2 if visibility
           else np.ones((n_pts, nf))).astype(np.float32)
    return {
        "f": np.asarray(scene.K[:, 0, 0]), "u": np.asarray(scene.K[:, :2, 2]),
        "t": np.asarray(t0), "R": np.asarray(R0), "X": X_c.astype(np.float32),
        "x": np.asarray(scene.x.transpose(1, 0, 2)[:n_pts]), "vis": vis, "nf": nf,
    }


def _cams(pb):
    jcam = JState(X=jnp.zeros((0, 3), jnp.float32), f=jnp.asarray(pb["f"]),
                  u=jnp.asarray(pb["u"]), t=jnp.asarray(pb["t"]), R=jnp.asarray(pb["R"]))
    tcam = ba_state_from_numpy(np.zeros((0, 3)), pb["f"], pb["u"], pb["t"], pb["R"],
                               "cpu", torch.float32)
    return jcam, tcam


@pytest.mark.parametrize("visibility", [False, True], ids=["full", "masked"])
def test_fused_chunk_update_matches_jax(interpret, visibility):
    """f32: the accumulated system to 2e-3 of its largest entry (Y is
    rounded to bf16 on both sides, and a 1-ulp float32 difference in Y can
    flip a bf16 rounding); d_F, matG, b_p and the chunk error to float32
    rounding of their sums."""
    pb = _chunk_problem(visibility=visibility)
    nf = pb["nf"]
    jcam, tcam = _cams(pb)
    c = 1e-3
    f_pad, n_acc = jps.schur_acc_dim(nf)
    acc_j, dF_j, G_j, e_j, bp_j = jps.fused_chunk_update(
        jnp.zeros((n_acc, n_acc), jnp.float32), jcam, jnp.asarray(pb["X"]),
        jnp.asarray(pb["x"]), jnp.asarray(pb["vis"]), 1.0, jnp.float32(c),
    )
    acc_t, dF_t, G_t, e_t, bp_t = tps.fused_chunk_update(
        torch.zeros((n_acc, n_acc)), tcam, torch.from_numpy(pb["X"]),
        torch.from_numpy(pb["x"]), torch.from_numpy(pb["vis"]), 1.0,
        torch.tensor(c, dtype=torch.float32),
    )
    a_j = np.asarray(jps.finish_schur(acc_j, nf))
    a_t = tps.finish_schur(acc_t).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=2e-3 * np.abs(a_j).max())

    def close(g, w, rel=1e-4):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rel, atol=rel * np.abs(w).max())

    close(dF_t, dF_j)
    close(G_t, G_j)
    close(bp_t, bp_j)
    close(e_t, e_j, rel=1e-5)


def test_fused_backsub_chunk_matches_jax():
    """f32, no bf16 on this path: the point update, trial error and the
    gain-ratio terms to float32 rounding."""
    pb = _chunk_problem(visibility=True)
    nf = pb["nf"]
    jcam, tcam = _cams(pb)
    rng = np.random.default_rng(9)
    dxi = (1e-3 * rng.standard_normal(9 * nf)).astype(np.float32)
    dxi *= np.asarray(j_gauge_mask(nf, "x-up_z-forward", jnp.float32))
    from mvrecon_tpu.models.bundle_adjustment import _apply_update as j_apply
    from mvrecon_tpu_torch.models.bundle_adjustment import _apply_update as t_apply

    jtrial = j_apply(jcam, jnp.asarray(dxi), jnp.zeros((0, 3), jnp.float32))
    ttrial = t_apply(tcam, torch.from_numpy(dxi), torch.zeros((0, 3)))
    want = jps.fused_backsub_chunk(
        jcam, jtrial, jnp.asarray(pb["X"]), jnp.asarray(pb["x"]), jnp.asarray(pb["vis"]),
        1.0, jnp.float32(2e-3), jnp.asarray(dxi),
    )
    got = tps.fused_backsub_chunk(
        tcam, ttrial, torch.from_numpy(pb["X"]), torch.from_numpy(pb["x"]),
        torch.from_numpy(pb["vis"]), 1.0, torch.tensor(2e-3, dtype=torch.float32),
        torch.from_numpy(dxi),
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_assemble_type_major_matches_jax_exactly():
    nf = 5
    f_pad, n_acc = jps.schur_acc_dim(nf)
    rng = np.random.default_rng(11)
    schur = rng.standard_normal((n_acc, n_acc))
    schur = schur + schur.T
    b_p = rng.standard_normal(n_acc)
    g = rng.standard_normal((nf, 9, 9))
    d_f = rng.standard_normal(9 * nf)
    free = np.asarray(j_gauge_mask(nf, "x-up_z-forward", jnp.float64))
    c = 3e-3
    want = jps.assemble_type_major(jnp.asarray(schur), jnp.asarray(b_p), jnp.asarray(g),
                                   jnp.asarray(d_f), jnp.asarray(free), c, nf, f_pad)
    got = tps.assemble_type_major(*(torch.from_numpy(a) for a in (schur, b_p, g, d_f, free)),
                                  c, nf, f_pad)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tps.finish_schur(torch.from_numpy(schur)).numpy(),
                                  np.asarray(jps.finish_schur(jnp.asarray(schur), nf)))


@pytest.mark.parametrize("nf", [1, 6, 513])
def test_type_major_round_trips_match_jax_exactly(nf):
    f_pad, _ = jps.schur_acc_dim(nf)
    free = j_gauge_mask(max(nf, 2), "x-up_z-forward", jnp.float64)[: 9 * nf]
    v = np.arange(9 * nf, dtype=np.float64)
    vt = torch.from_numpy(v)
    cm_tm = tps.camera_major_to_type_major(vt, nf, f_pad)
    np.testing.assert_array_equal(
        cm_tm.numpy(), np.asarray(jps.camera_major_to_type_major(jnp.asarray(v), nf, f_pad)))
    np.testing.assert_array_equal(tps.type_major_to_camera_major(cm_tm, nf, f_pad).numpy(), v)
    np.testing.assert_array_equal(
        tps.type_major_free(torch.from_numpy(np.asarray(free)), nf, f_pad).numpy(),
        np.asarray(jps.type_major_free(free, nf, f_pad)))
