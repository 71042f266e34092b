"""Parity of the port's perspective self-calibration with the JAX package,
in float64 on the CPU, on the same numpy observations.

The metric upgrade is not sign-equivariant and the two packages' eigen-
solvers pick eigenvector signs independently, so the reconstruction is
compared through sign-invariant quantities: status, depth iterations,
depth error (rel 1e-8), the projections K [R^T | -R^T t] X (rel 1e-6)
and K up to scale."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mvrecon_tpu.models.perspective as jpersp
import mvrecon_tpu_torch.models.perspective as tpersp
from mvrecon_tpu.geometry.scenes import make_synthetic_scene


def _observations(n_images, n_slices, seed=0):
    sc = make_synthetic_scene(jax.random.key(seed), n_images=n_images, n_slices=n_slices,
                              n_angles=20, dtype=jnp.float64)
    return np.asarray(sc.x)  # (F, P, 2)


def _project(X, K, R, t):
    rt = np.swapaxes(R, -1, -2)
    P = K @ np.concatenate([rt, -(rt @ t[..., None])], axis=-1)
    ph = np.einsum("fij,pj->fpi", P, np.concatenate([X, np.ones((X.shape[0], 1))], axis=-1))
    return ph[..., :2] / ph[..., 2:]


def _compare(x, **kw):
    want = jpersp.perspective_self_calibration(jnp.asarray(x), f0=1.0, **kw)
    got = tpersp.perspective_self_calibration(x, f0=1.0, device="cpu", **kw)
    assert got.status == int(want.status)
    assert got.depth_iters == int(want.depth_iters)
    np.testing.assert_allclose(float(got.depth_error), float(want.depth_error), rtol=1e-8)
    w = [np.asarray(a) for a in (want.X, want.K, want.R, want.t)]
    g = [a.numpy() for a in (got.X, got.K, got.R, got.t)]
    np.testing.assert_allclose(_project(*g), _project(*w), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(g[1] / g[1][:, 2:, 2:], w[1] / w[1][:, 2:, 2:], rtol=1e-6)
    return got, want


# tolerances between the first and the converged depth error of this
# scene, so each case runs several depth iterations and ends with status 0;
# "power" is the older name of "lowrank" in the depth loop, while the
# factorization after it stays the SVD
@pytest.mark.parametrize("method,tol", [("primary", 0.0094), ("dual", 0.0064)])
@pytest.mark.parametrize("eig_method", ["eigh", "lowrank", "power"])
def test_self_calibration_matches_jax(method, tol, eig_method):
    got, _ = _compare(_observations(10, 10), tol=tol, method=method, eig_method=eig_method)
    assert got.status == tpersp.STATUS_OK
    assert got.depth_iters > 1


def test_chunked_khatri_rao_branch_matches_jax(monkeypatch):
    """Lower the Khatri–Rao budget on both sides so the dual low-rank step
    accumulates its 12x12 Grams over point chunks (128, 128, 4). The
    shape (11 images, 260 points) is used by no other test, so the JAX
    jit cache holds no trace from before the patch. max_iter ends the
    depth loop (status 1) after four chunked steps."""
    nf, npts = 11, 260
    budget = 128 * nf * 12 * 8
    monkeypatch.setattr(jpersp, "_KR_CHUNK_BYTES", budget)
    monkeypatch.setattr(tpersp, "_KR_CHUNK_BYTES", budget)
    assert tpersp._kr_chunk(npts, nf, 8) == 128 < npts
    got, _ = _compare(_observations(nf, 13, seed=4), tol=1e-9, method="dual",
                      eig_method="lowrank", max_iter=4)
    assert got.status == tpersp.STATUS_MAX_ITER and got.depth_iters == 4
