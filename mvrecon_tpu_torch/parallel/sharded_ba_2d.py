"""2D (points x cameras) mesh bundle adjustment.

Counterpart of ``mvrecon_tpu/parallel/sharded_ba_2d.py``, for one scene
with a huge F. The 1D point-sharded BA (``sharded_ba.py``) solves the
whole reduced camera system A (9F, 9F) on every rank: 1.3 GB in float32 at
F = 2,000 and 32 GB at F = 10k. Here the cameras get a mesh axis of their
own:

- the Schur system is built row-sharded: the rank at cameras coordinate d
  computes only its (9F/Dc, 9F) row block ``fmat[:, rows_d]^T Einv fmat``
  from its point block, all-reduced over the ``points`` axis, so no rank
  ever holds the whole of A;
- the Cholesky solve becomes a Jacobi-preconditioned conjugate-gradient
  solve whose matvec is the row-block product plus a cameras-axis
  collective each iteration (``matvec_mode``, below);
- everything else (derivative generation, the point back-substitution,
  the error, the LM protocol) is the dense core's: the solver plugs into
  ``lm_optimize``'s ``solver`` hook through the 1D core's
  ``bundle_adjust_block``.

Each cameras-rank regenerates its point block's derivatives; the O(P
(9F)^2 / Dc) Schur product and the O((9F)^2 / Dc) system memory are what
divide.

The CG loop reads its stop test on the host before every iteration, as
JAX's ``while_loop`` tests it. The test reads a value that every rank of
the cameras axis holds alike (replicated by the gather, or all-reduced),
so all ranks run the same iterations and their collectives match.
"""

from __future__ import annotations

import torch

from ..config import LMConfig, resolve_device
from ..models.bundle_adjustment import BAResult, _damp, _psum
from ..ops.linalg import inv3x3
from ..runtime.distributed import all_gather_axis, pmax_axis, ppermute_axis
from .mesh import axis_index, axis_size, mesh_shape
from .sharded_ba import _gathered, _local_blocks, bundle_adjust_block

CAMERAS_AXIS = "cameras"
MATVEC_MODES = ("all_gather", "ring")


def _gather_matvec(a_rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v with v replicated: this rank's rows of the product, gathered
    over the cameras axis."""
    return all_gather_axis(a_rows @ v, CAMERAS_AXIS)


def _ring_matvec(a_rows: torch.Tensor, p_l: torch.Tensor) -> torch.Tensor:
    """This rank's rows of A p with p sharded over the cameras axis: the
    column block of the local shard first, then n_shards - 1 times the
    shard of the previous rank on the ring (``ppermute_axis``) against its
    column block."""
    n_rows, n_shards, dc = p_l.shape[0], axis_size(CAMERAS_AXIS), axis_index(CAMERAS_AXIS)
    acc = a_rows[:, dc * n_rows:(dc + 1) * n_rows] @ p_l
    v = p_l
    for k in range(1, n_shards):
        v = ppermute_axis(v, CAMERAS_AXIS)
        src = (dc - k) % n_shards  # the owner of v
        acc = acc + a_rows[:, src * n_rows:(src + 1) * n_rows] @ v
    return acc


def _cg_replicated(a_rows, b, diag_local, cg_tol: float, cg_max_iter: int) -> torch.Tensor:
    """``"all_gather"``: PCG with the state replicated on every
    cameras-rank, one gathered (9F,) product an iteration."""
    inv_diag = 1.0 / all_gather_axis(diag_local, CAMERAS_AXIS)
    x, r = torch.zeros_like(b), b
    z = inv_diag * r
    p = z
    rz = torch.dot(r, z)
    tol2 = (cg_tol * torch.linalg.vector_norm(b)) ** 2
    for _ in range(cg_max_iter):
        if not bool(torch.dot(r, r) > tol2):
            break
        ap = _gather_matvec(a_rows, p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def _psum_points(v: torch.Tensor, axis_name: str | None) -> torch.Tensor:
    """``_psum`` over the points axis; on a one-rank axis the sum is ``v``
    itself, so nothing is sent (XLA elides such a psum too)."""
    if axis_name is None or axis_size(axis_name) == 1:
        return v
    return _psum(v, axis_name)


def _pdots(*pairs) -> torch.Tensor:
    """The dot products of the sharded vector pairs, summed over the
    cameras axis in one all-reduce."""
    return _psum(torch.stack([torch.dot(u, v) for u, v in pairs]), CAMERAS_AXIS)


def _cg_sharded(a_rows, b, diag_local, row0: int, cg_tol: float,
                cg_max_iter: int) -> torch.Tensor:
    """``"ring"``: PCG with every state vector this rank's (n_rows,)
    shard, the dot products all-reduced over the cameras axis and the
    matvec walking the ring (:func:`_ring_matvec`); the solution gathered
    at the end."""
    n_rows = diag_local.shape[0]
    b_l = b[row0:row0 + n_rows]
    inv_diag_l = 1.0 / diag_local
    x, r = torch.zeros_like(b_l), b_l
    z = inv_diag_l * r
    p = z
    rz, rr, bb = _pdots((r, z), (r, r), (b_l, b_l))
    tol2 = cg_tol**2 * bb
    for _ in range(cg_max_iter):
        if not bool(rr > tol2):
            break
        ap = _ring_matvec(a_rows, p)
        alpha = rz / _pdots((p, ap))[0]
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag_l * r
        rz_new, rr = _pdots((r, z), (r, r))
        p = z + (rz_new / rz) * p
        rz = rz_new
    return all_gather_axis(x, CAMERAS_AXIS)


def _row_sharded_cg_solver(cg_tol: float = 1e-10, cg_max_iter: int = 200,
                           matvec_mode: str = "all_gather"):
    """A ``lm_optimize(solver=...)`` hook: the cameras-row-sharded Schur
    assembly and a preconditioned CG solve. It runs with both the
    ``points`` axis (``axis_name``) and the ``cameras`` axis bound
    (``parallel.mesh.bind_axes``); an unbound ``cameras`` raises
    ``ValueError``, as does a ``matvec_mode`` other than these two:

    - ``"all_gather"``: each rank computes its row block's product and the
      (9F,) result is gathered over the cameras axis; the CG state is
      replicated.
    - ``"ring"``: the CG state stays sharded (n_rows a rank); the matvec
      rotates the vector shards around the cameras axis by point-to-point
      sends (``ppermute_axis``, n_shards - 1 a matvec), multiplying the
      matching (n_rows, n_rows) column block of the local rows at each
      step, and the dot products are all-reduced over the axis. No rank
      holds the whole vector until the solution is gathered."""
    if matvec_mode not in MATVEC_MODES:
        raise ValueError(f"unknown matvec_mode {matvec_mode!r} (use one of {MATVEC_MODES})")

    def solve(derivs, c, free, axis_name):
        npts, nf9 = derivs.matE.shape[0], derivs.matF.shape[-1]
        n_shards = axis_size(CAMERAS_AXIS)
        if (nf9 // 9) % n_shards:
            raise ValueError(f"F={nf9 // 9} must be divisible by the cameras-axis size "
                             f"{n_shards}")
        n_rows = nf9 // n_shards
        row0 = axis_index(CAMERAS_AXIS) * n_rows
        rows = slice(row0, row0 + n_rows)
        matGc = _damp(derivs.matG, c)
        einv = inv3x3(_damp(derivs.matE, c))  # (P, 3, 3)
        einv_f = torch.einsum("pxy,pym->pxm", einv, derivs.matF)  # (P, 3, 9F)
        fmat = derivs.matF.view(npts * 3, nf9)

        # the row block of -F^T Einv F, all-reduced over the points axis
        a_rows = _psum_points(
            torch.matmul(fmat[:, rows].T, einv_f.view(npts * 3, nf9)).neg_(), axis_name)
        b = _psum_points(torch.einsum("pxm,px->m", einv_f, derivs.d_P), axis_name)
        del einv_f
        # blockdiag(Gc) on the block: local camera i is global camera
        # f_0 + i, whose columns sit at 9 (f_0 + i) .. 9 (f_0 + i) + 9
        f_loc, f_0 = n_rows // 9, row0 // 9
        blocks = a_rows.view(f_loc, 9, nf9 // 9, 9)[:, :, f_0:f_0 + f_loc]
        torch.diagonal(blocks, dim1=0, dim2=2).add_(matGc[f_0:f_0 + f_loc].movedim(0, -1))
        # gauge projection: masked rows and columns become identity rows,
        # so CG leaves the fixed parameters at exactly zero
        free_rows = free[rows]
        a_rows.mul_(free_rows[:, None]).mul_(free)
        torch.diagonal(a_rows[:, rows]).add_(1.0 - free_rows)
        diag_local = torch.diagonal(a_rows[:, rows]).clone()  # the Jacobi preconditioner
        b = (b - derivs.d_F) * free + 0.0  # rhs zero on the fixed parameters

        if matvec_mode == "ring":
            delta_xi = _cg_sharded(a_rows, b, diag_local, row0, cg_tol, cg_max_iter)
        else:
            delta_xi = _cg_replicated(a_rows, b, diag_local, cg_tol, cg_max_iter)
        del a_rows
        delta_xi = delta_xi * free
        rhs = torch.einsum("pxm,m->px", derivs.matF, delta_xi) + derivs.d_P
        delta_x = -torch.einsum("pxy,py->px", einv, rhs)
        # every cameras-rank computed the same values; the max over equal
        # values is exact, and keeps the ranks in step as JAX's pmax does
        return pmax_axis(delta_xi, CAMERAS_AXIS), pmax_axis(delta_x, CAMERAS_AXIS)

    return solve


def sharded_bundle_adjust_2d(
    mesh,
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-10,
    cg_max_iter: int = 200,
    matvec_mode: str = "all_gather",
    distortion=None,
    device=None,
) -> BAResult:
    """Bundle adjustment over a 2D (``points``, ``cameras``) mesh: P split
    over ``points`` (padded to a multiple of that axis's size), the
    reduced camera system row-sharded over ``cameras`` with a CG solve
    (:func:`_row_sharded_cg_solver`; ``matvec_mode="ring"`` keeps the CG
    state sharded). F must be divisible by the cameras-axis size
    (``ValueError`` otherwise).

    ``distortion`` / ``config.distortion_rounds``: the refit-first
    alternation of the other cores; the refit's normal terms are
    all-reduced over the points axis only, its inputs being replicated
    over the cameras axis. ``log`` is None and X is gathered over the
    points axis, as in :func:`sharded_ba.sharded_bundle_adjust`. Runs on
    the card unless ``device`` says otherwise; the working dtype is x's."""
    n_shards = mesh_shape(mesh).get(CAMERAS_AXIS)
    if n_shards is None:
        raise ValueError(f"the mesh has no {CAMERAS_AXIS!r} axis: {mesh_shape(mesh)}")
    nf = x.shape[1]
    if nf % n_shards:
        raise ValueError(f"F={nf} must be divisible by the cameras-axis size {n_shards}")
    solver = _row_sharded_cg_solver(cg_tol=cg_tol, cg_max_iter=cg_max_iter,
                                    matvec_mode=matvec_mode)
    dev = resolve_device(device)
    x_l, X_l, vis_l, npts = _local_blocks(mesh, x, init_X, visibility, dev)
    res = bundle_adjust_block(mesh, x_l, X_l, vis_l, init_K, init_R, init_t, f0=f0, axis=axis,
                              config=config, distortion=distortion, solver=solver)
    return _gathered(mesh, res, npts)
