"""Parity of the port's small-matrix primitives with the JAX package, in
float64 on the CPU, on the same numpy inputs: rotations, 3x3 and
lower-triangular linear algebra, fourth moments and their packings, the
rank-r factorization and the camera model. Tolerance 1e-12 (same
formulas, float64 rounding; eigen- and singular vectors are compared
through sign-invariant products). Also: the batched ``eigh`` and ``svd``
give NaN for a non-finite matrix and leave the others of its batch as
they would be alone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.geometry import camera as jcam
from mvrecon_tpu.ops import factorization as jfac
from mvrecon_tpu.ops import linalg as jlin
from mvrecon_tpu.ops import moments as jmom
from mvrecon_tpu.ops import rotations as jrot
from mvrecon_tpu_torch.geometry import camera as tcam
from mvrecon_tpu_torch.ops import factorization as tfac
from mvrecon_tpu_torch.ops import linalg as tlin
from mvrecon_tpu_torch.ops import moments as tmom
from mvrecon_tpu_torch.ops import rotations as trot

TOL = 1e-12


def _rng():
    return np.random.default_rng(7)


def _spd3(n):
    a = _rng().normal(size=(n, 3, 3))
    return a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3)


def _lower3(n):
    return np.linalg.cholesky(_spd3(n))


def _spd9(n):
    a = _rng().normal(size=(n, 9, 9))
    return a @ a.transpose(0, 2, 1) + 0.5 * np.eye(9)


def _near_rot(n):
    q, _ = np.linalg.qr(_rng().normal(size=(n, 3, 3)))
    q = q * np.sign(np.linalg.det(q))[:, None, None]
    return q + 0.05 * _rng().normal(size=(n, 3, 3))


def _omegas(n):
    w = _rng().normal(size=(n, 3))
    w[0] = 0.0
    w[1] = 1e-9
    return w


def _sym4x4_flat():
    v = _rng().normal(size=(5, 4, 16))
    c = np.broadcast_to(np.eye(4), (5, 4, 4)).copy()
    return v, c


# (name, JAX function, port function, inputs)
CASES = [
    ("unit_vec", jrot.unit_vec, trot.unit_vec, lambda: (_rng().normal(size=(6, 3)),)),
    ("rodrigues", jrot.rodrigues, trot.rodrigues, lambda: (_omegas(8),)),
    ("inv3x3", jlin.inv3x3, tlin.inv3x3, lambda: (_spd3(10),)),
    ("det3x3", jlin.det3x3, tlin.det3x3, lambda: (_rng().normal(size=(10, 3, 3)),)),
    ("chol3x3", jlin.chol3x3, tlin.chol3x3, lambda: (_spd3(10),)),
    ("inv_lower3", jlin.inv_lower3, tlin.inv_lower3, lambda: (_lower3(10),)),
    ("chol9_blocks", jlin.chol9_blocks, tlin.chol9_blocks, lambda: (_spd9(10),)),
    ("inv9_spd", jlin.inv9_spd, tlin.inv9_spd, lambda: (_spd9(10),)),
    ("polar_orthogonal3", jlin.polar_orthogonal3, tlin.polar_orthogonal3,
     lambda: (_near_rot(10),)),
    ("fourth_moment_matrix", jmom.fourth_moment_matrix, tmom.fourth_moment_matrix,
     _sym4x4_flat),
    ("sym_reduce_3", lambda b: jmom.sym_reduce(b, 3), lambda b: tmom.sym_reduce(b, 3),
     lambda: (_rng().normal(size=(9, 9)),)),
    ("sym_reduce_4", lambda b: jmom.sym_reduce(b, 4), lambda b: tmom.sym_reduce(b, 4),
     lambda: (_rng().normal(size=(16, 16)),)),
    ("sym_expand_3", lambda t: jmom.sym_expand(t, 3), lambda t: tmom.sym_expand(t, 3),
     lambda: (_rng().normal(size=(6,)),)),
    ("sym_expand_4", lambda t: jmom.sym_expand(t, 4), lambda t: tmom.sym_expand(t, 4),
     lambda: (_rng().normal(size=(10,)),)),
    ("intrinsics", lambda f, u: jcam.intrinsics(f, 1.5, u),
     lambda f, u: tcam.intrinsics(f, 1.5, u),
     lambda: (_rng().uniform(0.5, 2.0, size=(4,)), _rng().normal(size=(4, 2)))),
    ("camera_matrix", jcam.camera_matrix, tcam.camera_matrix,
     lambda: (_spd3(4), _near_rot(4), _rng().normal(size=(4, 3)))),
    ("look_at", jcam.look_at, tcam.look_at,
     lambda: (_rng().normal(size=(5, 3)) * 5, _rng().normal(size=(5, 3)))),
    ("project_points", jcam.project_points, tcam.project_points,
     lambda: (_rng().normal(size=(30, 3)),
              np.broadcast_to(np.diag([1.2, 1.2, 1.0]), (4, 3, 3)).copy(),
              np.broadcast_to(np.eye(3), (4, 3, 3)).copy(),
              np.array([[0.0, 0.0, -6.0 - i] for i in range(4)]))),
]


@pytest.mark.parametrize("name,jfn,tfn,make", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(name, jfn, tfn, make):
    args = make()
    want = jfn(*[jnp.asarray(a) for a in args])
    got = tfn(*[torch.from_numpy(np.asarray(a)) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_min_eigvec_sym_matches_jax():
    a = _rng().normal(size=(6, 10, 10))
    a = a + a.transpose(0, 2, 1)
    w_j, v_j = jlin.min_eigvec_sym(jnp.asarray(a))
    w_t, v_t = tlin.min_eigvec_sym(torch.from_numpy(a))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=TOL, atol=TOL)
    # eigenvectors up to sign: compare the projectors v v^T
    pj = np.einsum("bi,bj->bij", np.asarray(v_j), np.asarray(v_j))
    pt = np.einsum("bi,bj->bij", v_t.numpy(), v_t.numpy())
    np.testing.assert_allclose(pt, pj, atol=1e-10)


def test_eigh_in_slices_equals_one_call(monkeypatch):
    """``eigh`` runs a large batch in slices of ``EIGH_BATCH`` matrices (the
    card's batched eigensolver refuses large batches); the result is the
    one call's, leading batch dimensions included."""
    a = _rng().normal(size=(3, 50, 4, 4))
    a = torch.from_numpy(a + a.transpose(0, 1, 3, 2))
    want = torch.linalg.eigh(a)
    monkeypatch.setattr(tlin, "EIGH_BATCH", 7)
    got = tlin.eigh(a)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_polar_orthogonal3_rank_deficient_is_orthogonal():
    """Rank-2 input takes the completion branch; its null direction's sign
    is the eigensolver's choice in both packages, so only the contract is
    compared: an orthogonal matrix that agrees with the JAX one on the
    healthy (row space) directions."""
    a = _near_rot(6)
    a[:, :, 0] = 0.0  # one zero singular value
    got = tlin.polar_orthogonal3(torch.from_numpy(a)).numpy()
    want = np.asarray(jlin.polar_orthogonal3(jnp.asarray(a)))
    np.testing.assert_allclose(got.transpose(0, 2, 1) @ got,
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-12)
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], atol=1e-10)


def test_factorization_matches_jax():
    w = _rng().normal(size=(30, 4)) @ _rng().normal(size=(4, 50))
    w = w + 1e-3 * _rng().normal(size=w.shape)
    m_j, s_j = jfac.factorization_method(jnp.asarray(w), n_rank=4)
    m_t, s_t = tfac.factorization_method(torch.from_numpy(w), n_rank=4)
    # the rank-4 truncation M S is basis-invariant
    np.testing.assert_allclose(m_t.numpy() @ s_t.numpy(), np.asarray(m_j @ s_j), atol=1e-12)
    np.testing.assert_allclose(np.abs(m_t.numpy()), np.abs(np.asarray(m_j)), atol=1e-10)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _sym_batch_with_nan():
    a = _rng().normal(size=(3, 4, 4))
    a = a + a.transpose(0, 2, 1)
    a[1, 0, 0] = np.nan
    return torch.from_numpy(a)


@pytest.mark.parametrize("eigh_batch", [16384, 2], ids=["one-call", "sliced"])
def test_eigh_isolates_non_finite_matrices(eigh_batch, monkeypatch):
    """One NaN matrix in a batch: its eigenpairs are all NaN, the others
    equal an eigh of each alone (torch.linalg.eigh raises for the batch)."""
    monkeypatch.setattr(tlin, "EIGH_BATCH", eigh_batch)
    a = _sym_batch_with_nan()
    with pytest.raises(RuntimeError):
        torch.linalg.eigh(a)
    w, v = tlin.eigh(a)
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    for i in (0, 2):
        wi, vi = torch.linalg.eigh(a[i])
        np.testing.assert_allclose(w[i].numpy(), wi.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(v[i].numpy(), vi.numpy(), rtol=0, atol=TOL)


def test_svd_isolates_non_finite_matrices():
    a = _rng().normal(size=(3, 5, 4))
    a[1, 2, 3] = np.inf
    a = torch.from_numpy(a)
    u, s, vh = tlin.svd(a)
    assert all(torch.isnan(m[1]).all() for m in (u, s, vh))
    for i in (0, 2):
        ui, si, vhi = torch.linalg.svd(a[i], full_matrices=False)
        for got, want in ((u[i], ui), (s[i], si), (vh[i], vhi)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_pinv_and_orthonormalize_match_jax():
    p = _rng().normal(size=(5, 3, 2))
    p[0, :, 1] = 0.0  # rank-deficient: the cutoff drops the zero singular value
    _close(tlin.pinv(torch.from_numpy(p)), jnp.linalg.pinv(jnp.asarray(p)))
    r = _near_rot(6)
    _close(tlin.orthonormalize(torch.from_numpy(r)), jlin.orthonormalize(jnp.asarray(r)))


def test_project_points_orthographic_matches_jax():
    X = _rng().normal(size=(20, 3))
    R, t = _near_rot(4), _rng().normal(size=(4, 3))
    want = jcam.project_points_orthographic(*(jnp.asarray(a) for a in (X, R, t)))
    got = tcam.project_points_orthographic(*(torch.from_numpy(a) for a in (X, R, t)))
    _close(got, want)
