"""Meshes of ranks, and the binding of their axis names to process groups.

Counterpart of ``mvrecon_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group (``runtime/distributed.py``: one rank per device), with JAX's axis
names and shape rules:

- ``scenes``: data parallelism over independent reconstructions, no
  collective;
- ``points``: the P dimension of one scene split over the ranks; the
  camera-side sums of the BA cores are all-reduced over it;
- ``cameras``: the rows of the reduced camera system split over the ranks
  (``parallel/sharded_ba_2d.py``).

JAX's ``psum(v, axis_name)`` inside ``shard_map`` finds the axis from the
mesh that ``shard_map`` runs over. Here the sharded call binds its mesh
(``bind_axes``) while it runs, and the cores' ``_psum`` resolves the name
to the process group of that mesh dimension (``axis_group``); JAX's
``axis_index(name)`` and ``psum(1, name)`` are ``axis_index`` and
``axis_size``, and ``axis_ranks`` lists the axis's global ranks in its
coordinate order (the peers of a ``ppermute``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..runtime.distributed import local_device

_BOUND: contextvars.ContextVar[dict] = contextvars.ContextVar("mesh_axes", default={})


def _ranks(devices) -> list[int]:
    return list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]


def make_mesh(axis_sizes: dict[str, int], devices=None) -> DeviceMesh:
    """A named mesh with the given axis sizes, row-major over the ranks
    ``devices`` (default: every rank of the process group), of this rank's
    device type (``local_device``). Every rank calls it, as it creates the
    process groups of the mesh dimensions."""
    ranks = _ranks(devices)
    sizes = list(axis_sizes.values())
    n = int(np.prod(sizes))
    if n > len(ranks):
        raise ValueError(f"mesh needs {n} devices, have {len(ranks)}")
    return DeviceMesh(local_device().type,
                      torch.tensor(ranks[:n], dtype=torch.int64).reshape(sizes),
                      mesh_dim_names=tuple(axis_sizes))


def hybrid_scene_point_mesh(n_slices: int, devices=None,
                            axes: tuple[str, str] = ("scenes", "points")) -> DeviceMesh:
    """(scenes, points) mesh of ``n_slices`` rows: the outer axis spans the
    slow links (hosts), the inner one stays within each. The scenes axis
    carries no collective, so the per-retry all-reduces of the points
    axis never cross a slice. Ranks are grouped row-major, which is JAX's
    layout on devices with no slice structure."""
    ranks = _ranks(devices)
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} devices do not split into {n_slices} slices")
    return make_mesh({axes[0]: n_slices, axes[1]: len(ranks) // n_slices}, devices=ranks)


def scene_point_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """2D (scenes, points) mesh over ``n_devices`` ranks: scenes gets the
    largest power-of-two factor <= sqrt(n), points the rest. For 8 ranks
    this is (2 scenes, 4 points)."""
    ranks = _ranks(devices)
    n = n_devices if n_devices is not None else len(ranks)
    scenes = 1
    while scenes * 2 <= n // (scenes * 2) and n % (scenes * 2) == 0:
        scenes *= 2
    return make_mesh({"scenes": scenes, "points": n // scenes}, devices=ranks)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size}, JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class _Axis(NamedTuple):
    """A bound mesh axis, seen from this rank: the process group of the
    mesh dimension, this rank's coordinate on it and the dimension's global
    ranks in coordinate order."""

    group: object
    index: int
    ranks: tuple[int, ...]


@contextlib.contextmanager
def bind_axes(mesh: DeviceMesh):
    """Bind the axis names of ``mesh`` to this rank's process groups of its
    dimensions, its coordinates and the dimensions' ranks while the block
    runs: what ``shard_map`` gives JAX's ``psum`` and ``axis_index``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    axes = {}
    for k, name in enumerate(mesh.mesh_dim_names):
        line = mesh.mesh[tuple(slice(None) if j == k else c for j, c in enumerate(coord))]
        axes[name] = _Axis(mesh.get_group(name), coord[k], tuple(line.tolist()))
    token = _BOUND.set({**_BOUND.get(), **axes})
    try:
        yield
    finally:
        _BOUND.reset(token)


def _bound(axis_name: str) -> _Axis:
    axis = _BOUND.get().get(axis_name)
    if axis is None:
        raise ValueError(f"axis name {axis_name!r} is not bound: call the core inside a "
                         "sharded function or under parallel.mesh.bind_axes(mesh)")
    return axis


def axis_group(axis_name: str):
    """The process group bound to ``axis_name`` (``bind_axes``); a name no
    running sharded call binds raises ``ValueError``, as do ``axis_index``,
    ``axis_size`` and ``axis_ranks``."""
    return _bound(axis_name).group


def axis_index(axis_name: str) -> int:
    """This rank's coordinate on the bound axis (JAX's ``axis_index``)."""
    return _bound(axis_name).index


def axis_size(axis_name: str) -> int:
    """The number of ranks on the bound axis (JAX's ``psum(1, name)``)."""
    return len(_bound(axis_name).ranks)


def axis_ranks(axis_name: str) -> tuple[int, ...]:
    """The global ranks of the bound axis through this rank, in coordinate
    order: entry i is the rank at coordinate i."""
    return _bound(axis_name).ranks
