"""Scene-batched reconstruction: S independent scenes of one shape.

Counterpart of ``mvrecon_tpu/parallel/batched.py``. There ``vmap`` turns
each per-scene pipeline into its batched form; here the pipelines take a
leading scene axis directly and run the scenes as lanes: every
decomposition, product and solve is one batched call over the scenes, and
each loop (the depth iteration, the metric upgrade, the LM iterations and
retries) keeps a finished scene's values by ``torch.where`` while the
others go on (``ops/lanes.py``). ``scene_chunk`` runs blocks of that many
scenes one after another, as ``lax.map(batch_size=...)`` does, so the
device memory stays that of one block.

Scene sharding over ranks (``shard_scenes``): each rank takes its block
of the scenes axis and runs the batched pipelines on it with no
collective, JAX's pure data parallelism.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..models.bundle_adjustment import bundle_adjust
from ..models.pipelines import (
    ReconstructionResult,
    affine_reconstruction,
    euclidean_reconstruction,
)
from ..runtime.distributed import distribute_array
from ..runtime.profiling import StageTimer, stage

SCENES_AXIS = "scenes"


def _merge_logs(logs: list[dict]) -> dict:
    """Per-block BA logs -> one: per-scene tensors concatenated, retry
    counts added."""
    out = {}
    for key in logs[0]:
        vals = [lg[key] for lg in logs]
        out[key] = torch.cat(vals) if torch.is_tensor(vals[0]) else sum(vals)
    return out


def _in_blocks(fn, arrays: tuple, scene_chunk: int | None) -> ReconstructionResult:
    """fn over all scenes at once, or over blocks of ``scene_chunk``
    scenes in turn with the results concatenated."""
    n = arrays[0].shape[0]
    if scene_chunk is None or scene_chunk >= n:
        return fn(*arrays)
    parts = [fn(*(a[i:i + scene_chunk] for a in arrays)) for i in range(0, n, scene_chunk)]
    fields = {}
    for name in ReconstructionResult._fields:
        vals = [getattr(p, name) for p in parts]
        fields[name] = _merge_logs(vals) if name == "ba_log" else torch.cat(vals)
    return ReconstructionResult(**fields)


def batched_affine_reconstruction(
    x,
    f,
    model: str = "paraperspective",
    f0: float = 1.0,
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    scene_chunk: int | None = None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """The affine pipeline over a leading scenes axis: x (S, F, P, 2),
    f (S, F). ``scene_chunk``: see :func:`batched_euclidean_reconstruction`.
    Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))
    f = as_tensor(f, dev, x.dtype)

    def fn(x_b, f_b):
        return affine_reconstruction(x_b, f_b, model=model, f0=f0, config=config, device=dev,
                                     timer=timer)

    return _in_blocks(fn, (x, f), scene_chunk)


def batched_euclidean_reconstruction(
    x,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    eig_method: str = "eigh",
    scene_chunk: int | None = None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """The perspective pipeline over a leading scenes axis: x (S, F, P, 2).

    ``scene_chunk`` runs the batch in blocks of that many scenes, one
    after another, at the device memory of one block; unset, all scenes
    form one block. The result holds every scene, with ``error``,
    ``n_iter`` and ``status`` as (S,) tensors. Runs on the card unless
    ``device`` says otherwise; ``timer`` adds up each stage's wall over
    the blocks."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))

    def fn(x_b):
        return euclidean_reconstruction(x_b, f0=f0, tol=tol, method=method, config=config,
                                        eig_method=eig_method, device=dev, timer=timer)

    return _in_blocks(fn, (x,), scene_chunk)


def _bucket(n: int) -> int:
    """Round a compaction subset size up to a power of two (at least 8),
    as the JAX package does to reuse its compiled programs; the padding
    lanes repeat the first unconverged scene."""
    b = 8
    while b < n:
        b *= 2
    return b


def batched_euclidean_to_convergence(
    x,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-3, max_iter=15),
    eig_method: str = "lowrank",
    scene_chunk: int | None = None,
    continuation_budget: int = 25,
    max_phases: int = 8,
    carry_damping: bool = True,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """Run every scene to its own stop (|dE| <= ``config.delta_tol``) by
    scene compaction: after one fixed-budget pipeline pass
    (:func:`batched_euclidean_reconstruction`), the scenes that used the
    whole budget with a finite E are gathered into a smaller batch,
    padded to a power-of-two bucket, and continued with BA-only phases of
    ``continuation_budget`` iterations until every scene stops or
    ``max_phases`` phases have run. Lanes that finish early therefore stop
    paying for the rest.

    ``carry_damping`` resumes each scene's damping (c, nu) across phases,
    so the compacted trajectory is the continuous one; False restarts the
    damping each phase. ``n_iter`` counts all BA iterations of a scene
    across phases, and ``ba_log`` holds the final (c, nu) per scene, the
    retries of all phases and the number of continuation phases run."""
    if config.delta_tol <= 0:
        raise ValueError("to-convergence mode needs config.delta_tol > 0")
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))

    res = batched_euclidean_reconstruction(
        x, f0=f0, tol=tol, method=method, config=config, eig_method=eig_method,
        scene_chunk=scene_chunk, device=dev, timer=timer,
    )
    X, K, R, t = (a.clone() for a in (res.X, res.K, res.R, res.t))
    err, n_iter = res.error.clone(), res.n_iter.clone()
    c, nu = res.ba_log["c"].clone(), res.ba_log["nu"].clone()
    retries = res.ba_log["n_solver_retries"]
    x_pf = x.transpose(-3, -2)  # (S, P, F, 2)
    cont_cfg = dataclasses.replace(config, max_iter=continuation_budget)

    # a pass that stops before its budget has converged (or accepted
    # nothing); one that converges on its last iteration costs at most one
    # short confirmation phase
    active = (n_iter == config.max_iter) & torch.isfinite(err)
    phases = 0
    for _ in range(max_phases):
        idx = torch.nonzero(active).flatten()  # a host read
        k = idx.numel()
        if k == 0:
            break
        idx_b = torch.cat([idx, idx[:1].expand(_bucket(k) - k)])
        with stage(timer, "continuation_ba"):
            r = bundle_adjust(
                x_pf[idx_b], X[idx_b], K[idx_b], R[idx_b], t[idx_b], f0=f0,
                axis="x-up_z-forward", config=cont_cfg,
                init_c=c[idx_b] if carry_damping else None,
                init_nu=nu[idx_b] if carry_damping else None, device=dev,
            )
        X[idx], K[idx], R[idx], t[idx] = r.X[:k], r.K[:k], r.R[:k], r.t[:k]
        err[idx] = r.error[:k]
        n_iter[idx] += r.n_iter[:k]
        c[idx], nu[idx] = r.log["c"][:k], r.log["nu"][:k]
        active[idx] = (r.n_iter[:k] == continuation_budget) & torch.isfinite(r.error[:k])
        retries += r.log["n_solver_retries"]
        phases += 1

    return ReconstructionResult(
        X=X, K=K, R=R, t=t, error=err, n_iter=n_iter, calib_X=res.calib_X,
        status=res.status,
        ba_log={"c": c, "nu": nu, "n_solver_retries": retries, "phases": phases},
    )


def shard_scenes(x, mesh) -> torch.Tensor:
    """This rank's block of the scenes axis of a host (S, ...) batch, on
    its device: the S scenes split in contiguous blocks over the mesh's
    ``scenes`` axis (S must divide by its size), as JAX's
    ``NamedSharding`` of that axis places them. The batched pipelines then
    run on the block with no collective; the caller gathers the results
    it needs (JAX leaves that to XLA), for example with
    ``runtime.distributed.gather_array(mesh, result, ("scenes",))``."""
    return distribute_array(mesh, (SCENES_AXIS,), x)
