"""Multi-process execution: the process group, global meshes, shard feeding.

Counterpart of ``mvrecon_tpu/runtime/distributed.py`` on
``torch.distributed``. The port runs one process per device, a rank: where
a JAX process drives all of its host's devices, here each rank drives one
card (or the CPU), and the ranks of all hosts form one process group.
JAX's ``local_device_count`` (devices per process) becomes ranks per host.

- ``initialize``: join the process group. A CUDA device takes NCCL and the
  CPU takes gloo; ``backend="gloo"`` names gloo for CUDA tensors, which
  only a host whose ranks share one card needs (NCCL takes one rank per
  card);
- ``process_scene_point_mesh``: a global (scenes, points) mesh whose outer
  axis spans hosts and whose inner axis spans a host's ranks, so the
  per-retry all-reduces of the points axis stay inside a host;
- ``points_mesh``: one ``points`` axis over every rank;
- ``distribute_array`` / ``replicate_array``: each rank moves only its own
  block of a host array to its device;
- ``gather_array``: the global array back on every rank, by an all-reduce
  of a zero-filled buffer;
- ``broadcast_array``: one rank's host array on every rank's host, through
  a device buffer of one rank's share, so a command draws its synthetic
  scene on one card only;
- the collectives of a bound mesh axis (``parallel.mesh.bind_axes``) that
  the 2D BA adds: ``all_gather_axis`` (JAX's tiled ``all_gather``, a
  zero-filled all-reduce), ``pmax_axis`` (an all-reduce with MAX) and
  ``ppermute_axis`` (a ring shift by point-to-point sends).

So the collectives are ``all_reduce`` (sum, and max in ``pmax_axis``),
``broadcast`` and, in ``ppermute_axis`` alone, ``batch_isend_irecv``. Gloo
carries the first two for CUDA tensors but no point-to-point send of one:
under gloo ``ppermute_axis`` stages a CUDA tensor through the host, under
NCCL it goes device to device.

Launch N ranks with ``torchrun --nproc-per-node N script.py`` (or
``python -m torch.distributed.run``) and call ``initialize`` in each with
the address, the world size and the rank, or start the processes yourself
as ``tests/test_torch_sharded.py`` does. ``join_ranks`` is how a command
with ``--shard-points N`` joins: the group it is in, torchrun's, or one
rank of its own.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..config import as_tensor, resolve_device

# What ``initialize`` decided for this process: the rank's device and the
# ranks per host. The process group itself is process-global state of
# ``torch.distributed``; this mirrors it and is set once, by ``initialize``.
_LOCAL: dict = {}


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: str | None = None,
    local_device_count: int | None = None,
    backend: str | None = None,
) -> torch.device:
    """Join this process to the process group as rank ``process_id`` of
    ``num_processes``, rendezvousing at ``coordinator_address``
    ("host:port" or a ``tcp://`` URL). Returns the rank's device.

    ``platform``: None (or "gpu"/"cuda") runs the rank on a card, and
    raises without one (``config.resolve_device``); "cpu" on the CPU.
    ``local_device_count``: ranks per host (default: the host's cards, or
    every rank for the CPU). The rank's card is its index on its host,
    modulo the host's cards.

    ``backend``: None takes NCCL for a card, and raises if this build of
    PyTorch has none, and gloo for the CPU. "gloo" names gloo for CUDA
    tensors too; it carries ``all_reduce`` and ``broadcast`` for them
    through the host, and lets several ranks share one card."""
    if platform not in (None, "gpu", "cuda", "cpu"):
        raise ValueError(f"unknown platform: {platform!r} (use None, 'gpu' or 'cpu')")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend: {backend!r} (use None, 'nccl' or 'gloo')")
    dev = torch.device("cpu") if platform == "cpu" else resolve_device(None)
    if dev.type == "cuda":
        per_host = local_device_count or torch.cuda.device_count()
        dev = torch.device("cuda", (process_id % per_host) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend is None:
            if not dist.is_nccl_available():
                raise RuntimeError("a CUDA device takes NCCL, and this PyTorch has none")
            backend = "nccl"
    else:
        per_host = local_device_count or num_processes
        if backend == "nccl":
            raise ValueError("NCCL carries no CPU tensors; the CPU takes gloo")
        backend = "gloo"
    if num_processes % per_host:
        raise ValueError(f"{num_processes} ranks do not split into hosts of {per_host}")
    address = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    _LOCAL.update(device=dev, ranks_per_host=per_host)
    return dev


# what torchrun sets in the environment of every rank it starts
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE")


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_ranks(n: int, platform: str | None = None) -> bool:
    """Make this process one of ``n`` ranks for a sharded command: in the
    process group it is already in, whose size must be ``n``; else in
    torchrun's, from the variables torchrun sets (``TORCHRUN_VARS``);
    else, for ``n == 1``, in a one-rank group of its own on a free
    localhost port. ``platform`` is ``initialize``'s ("cpu" takes gloo, a
    card NCCL). Returns whether this call formed the group, which its
    caller then destroys; ``ValueError`` when ``n`` ranks cannot be had."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"--shard-points {n} in a process group of "
                             f"{dist.get_world_size()} ranks")
        return False
    env = os.environ
    if all(k in env for k in TORCHRUN_VARS):
        if int(env["WORLD_SIZE"]) != n:
            raise ValueError(f"--shard-points {n} under torchrun with {env['WORLD_SIZE']} ranks")
        initialize(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", n, int(env["RANK"]),
                   platform=platform, local_device_count=int(env["LOCAL_WORLD_SIZE"]))
        return True
    if n == 1:
        initialize(f"127.0.0.1:{free_port()}", 1, 0, platform=platform)
        return True
    raise ValueError(f"--shard-points {n} needs {n} ranks, one process each: launch it with "
                     f"torchrun --nproc-per-node {n} -m mvrecon_tpu_torch ...")


def local_device() -> torch.device:
    """This rank's device: the one ``initialize`` chose, else the current
    card under NCCL, else the CPU."""
    if "device" in _LOCAL:
        return _LOCAL["device"]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ranks_per_host() -> int:
    """Ranks on each host: ``initialize``'s ``local_device_count``, else
    the whole world (one host)."""
    return _LOCAL.get("ranks_per_host", dist.get_world_size())


def process_scene_point_mesh(axes: tuple[str, str] = ("scenes", "points"), devices=None):
    """Global (scenes, points) mesh with the outer axis spanning hosts:
    shape (n_hosts, ranks_per_host). The host boundary carries the
    collectives-free scenes axis; every all-reduce of the sharded BA runs
    over the intra-host ``points`` axis. ``devices``: the ranks (default
    every rank), host-major."""
    from ..parallel.mesh import make_mesh

    ranks = list(range(dist.get_world_size())) if devices is None else sorted(devices)
    per_host = ranks_per_host()
    if len(ranks) % per_host:
        raise ValueError(f"uneven ranks per host: {len(ranks)} ranks, {per_host} a host")
    return make_mesh({axes[0]: len(ranks) // per_host, axes[1]: per_host}, devices=ranks)


def points_mesh(devices=None):
    """1D global ``points`` mesh over every rank (host-major order).
    Its all-reduces cross hosts: use it only when one scene must span
    hosts; prefer ``process_scene_point_mesh``."""
    from ..parallel.mesh import make_mesh

    ranks = list(range(dist.get_world_size())) if devices is None else sorted(devices)
    return make_mesh({"points": len(ranks)}, devices=ranks)


def _block(mesh, spec, shape):
    """Per dimension of ``shape``: (start, size) of this rank's block, from
    ``spec``, a tuple with a mesh axis name (the dimension is split over
    that axis in contiguous blocks) or None per leading dimension."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    names = mesh.mesh_dim_names
    out = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append((0, n))
            continue
        k = names.index(axis)
        parts = mesh.size(k)
        if n % parts:
            raise ValueError(f"dimension {d} ({n}) does not split over {parts} '{axis}' ranks")
        out.append((coord[k] * (n // parts), n // parts))
    return out


def distribute_array(mesh, spec, arr, device=None) -> torch.Tensor:
    """This rank's block of the global host array ``arr`` (numpy or a
    tensor), on ``device`` (default: this rank's): ``spec`` is a tuple with
    a mesh axis name or None per leading dimension, as JAX's
    ``PartitionSpec``. Only the block is copied to the device."""
    if not torch.is_tensor(arr):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    for d, (start, size) in enumerate(_block(mesh, tuple(spec), arr.shape)):
        arr = arr.narrow(d, start, size)
    return as_tensor(arr, device or local_device(), arr.dtype)


def replicate_array(mesh, arr, device=None) -> torch.Tensor:
    """The whole array on this rank's device (every rank holds a copy)."""
    return distribute_array(mesh, (), arr, device)


def gather_array(mesh, local: torch.Tensor, spec) -> torch.Tensor:
    """The global array of which ``local`` is this rank's block under
    ``spec`` (``distribute_array``'s), on every rank: per split dimension,
    the block is written into a zero-filled buffer of the global size and
    summed over that axis's ranks by ``all_reduce``, so the blocks land
    exactly (x + 0 = x)."""
    names = mesh.mesh_dim_names
    out = local
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        k = names.index(axis)
        size = out.shape[d]
        shape = list(out.shape)
        shape[d] = size * mesh.size(k)
        buf = out.new_zeros(shape)
        buf.narrow(d, mesh.get_coordinate()[k] * size, size).copy_(out)
        dist.all_reduce(buf, group=mesh.get_group(axis))
        out = buf
    return out


def broadcast_array(arr, shape, dtype: torch.dtype, device=None, src: int = 0) -> torch.Tensor:
    """The host tensor ``arr`` of rank ``src`` (None on the other ranks), of
    the ``shape`` that every rank passes, on the host of every rank of the
    process group, in ``dtype``: its values in blocks of 1/N of them, each
    through one block-sized buffer on this rank's device (default:
    ``local_device``), so no rank but ``src`` holds the whole array on its
    device."""
    dev = device or local_device()
    is_src = dist.get_rank() == src
    shape = tuple(shape)
    numel = int(np.prod(shape))
    flat = (arr.to(dtype).reshape(-1) if is_src
            else torch.empty(numel, dtype=dtype))
    block = max(-(-numel // dist.get_world_size()), 1)
    buf = torch.empty(block, dtype=dtype, device=dev)
    for lo in range(0, numel, block):
        n = min(block, numel - lo)
        if is_src:
            buf[:n].copy_(flat[lo:lo + n])
        dist.broadcast(buf, src)
        if not is_src:
            flat[lo:lo + n].copy_(buf[:n])
    return flat.view(shape)


def all_gather_axis(v: torch.Tensor, axis_name: str) -> torch.Tensor:
    """JAX's ``all_gather(v, axis_name, tiled=True)`` on a bound axis: the
    blocks of every rank of the axis stacked along dimension 0 in the
    axis's coordinate order. One all-reduce of a zero-filled buffer, so
    each block lands exactly (x + 0 = x)."""
    from ..parallel.mesh import axis_group, axis_index, axis_size

    n = v.shape[0]
    buf = v.new_zeros((axis_size(axis_name) * n,) + v.shape[1:])
    buf.narrow(0, axis_index(axis_name) * n, n).copy_(v)
    dist.all_reduce(buf, group=axis_group(axis_name))
    return buf


def pmax_axis(v: torch.Tensor, axis_name: str) -> torch.Tensor:
    """JAX's ``pmax(v, axis_name)`` on a bound axis: the elementwise
    maximum over the axis's ranks, in a new tensor."""
    from ..parallel.mesh import axis_group

    out = v.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis_group(axis_name))
    return out


def ppermute_axis(v: torch.Tensor, axis_name: str, shift: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` over a bound axis with the permutation
    i -> i + shift (mod n): the rank at coordinate i sends ``v`` to the one
    at i + shift and returns what the one at i - shift sent, by one
    ``batch_isend_irecv`` on the axis's group with the peers' global
    ranks. Under gloo a CUDA tensor goes through a host copy (gloo sends
    no CUDA tensor); under NCCL it goes device to device. A one-rank axis
    returns a copy."""
    from ..parallel.mesh import axis_group, axis_index, axis_ranks

    ranks = axis_ranks(axis_name)
    n, i = len(ranks), axis_index(axis_name)
    if n == 1:
        return v.clone()
    group = axis_group(axis_name)
    staged = v.is_cuda and dist.get_backend(group) == "gloo"
    send = v.cpu() if staged else v.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(v.device) if staged else recv
