"""Process meshes for sharded solves over ``torch.distributed``.

Counterpart of :mod:`admmsolver_tpu.parallel.mesh`.  The JAX package puts
the instance batch axis on a 1-D mesh of devices and lets XLA insert the
collectives.  Here a process owns one device, and the mesh is the world of
processes of a ``torch.distributed`` process group: each rank holds its
block of the batch (or of a large operator's rows) on its own device, and
the solvers make the collectives themselves.  They use only ``all_reduce``
and ``broadcast``, the two collectives that both backends offer on CUDA
tensors: gloo has no ``all_gather`` on them, and NCCL refuses two ranks on
one card, so ranks that share a card go through gloo.

A process that formed no process group is a world of one: its mesh has no
group, and a reduction over it is the rank's own value.  Multi-process runs
call :func:`init_distributed` (or ``dist.init_process_group``) first.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "BatchSharding", "ReplicatedSharding", "make_mesh",
           "batch_sharding", "replicated_sharding", "init_distributed",
           "process_allgather"]

#: how long forming a process group, and each of its collectives, may take
#: before the rank fails
TIMEOUT = datetime.timedelta(seconds=300)


def _flat_real(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` that every backend can reduce: complex as real pairs.
    A collective sends a tensor's storage, so ``t`` must be contiguous (a
    transposed tensor would arrive transposed)."""
    if not t.is_contiguous():
        raise ValueError("a collective needs a contiguous tensor")
    return torch.view_as_real(t) if t.is_complex() else t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D world of ranks, one device each.

    ``group`` is the process group its collectives run in (None: a world of
    one process with no group).  ``device`` is this rank's device."""

    rank: int
    world_size: int
    device: torch.device
    axis_names: Tuple[str, ...]
    group: Optional[object] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place and return it."""
        if self.group is not None:
            dist.all_reduce(_flat_real(t), group=self.group)
        return t

    def barrier(self) -> None:
        """Wait for every rank: an ``all_reduce`` of a zero (gloo has no
        barrier for a group of CUDA ranks)."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` in place with rank ``src``'s and return it."""
        if self.group is not None:
            dist.broadcast(_flat_real(t), src=src, group=self.group)
        return t


def process_allgather(t, mesh: Mesh) -> torch.Tensor:
    """``t`` of every rank, concatenated along the first axis in rank order,
    on every rank: the counterpart of
    ``jax.experimental.multihost_utils.process_allgather(t, tiled=True)``.
    Every rank's ``t`` must have the same shape.  Each rank writes its ``t``
    into its block of a buffer of zeros and one ``all_reduce`` sums the
    buffers.  A floating buffer is filled with -0.0, which leaves every value
    as it is when added (+0.0 would turn -0.0 into +0.0), so the gather is
    exact."""
    t = torch.as_tensor(t).to(mesh.device)
    dtype = t.dtype
    if dtype == torch.bool:
        t = t.to(torch.int32)
    buf = t.new_zeros((mesh.world_size,) + tuple(t.shape))
    if buf.is_floating_point() or buf.is_complex():
        _flat_real(buf).fill_(-0.0)
    buf[mesh.rank] = t
    return mesh.all_reduce(buf).to(dtype).reshape((-1,) + tuple(t.shape[1:]))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (instance) axis of a batch in contiguous equal blocks over
    the ranks, everything else replicated.  A batch of B is padded to a
    multiple of the world size: rank r holds lanes ``lanes(B)`` of the
    padded batch, and those at B and beyond are padding."""

    mesh: Mesh
    axis_name: str = "batch"

    @property
    def num_devices(self) -> int:
        return self.mesh.world_size

    def padded(self, B: int) -> int:
        W = self.mesh.world_size
        return -(-int(B) // W) * W

    def lanes(self, B: int) -> range:
        per = self.padded(B) // self.mesh.world_size
        return range(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def gather(self, a: torch.Tensor, B: int) -> torch.Tensor:
        """The (B, ...) batch on every rank from each rank's real lanes ``a``
        (its lanes below B, in order)."""
        per = self.padded(B) // self.mesh.world_size
        if a.shape[0] < per:
            a = torch.cat([a, a.new_zeros((per - a.shape[0],) + tuple(a.shape[1:]))])
        return process_allgather(a, self.mesh)[:B]

    def lane(self, a: torch.Tensor, i: int, B: int) -> torch.Tensor:
        """Lane ``i`` (< B) of the batch on every rank, from each rank's real
        lanes ``a``: one broadcast from the rank that holds it."""
        per = self.padded(B) // self.mesh.world_size
        owner = int(i) // per
        if self.mesh.rank == owner:
            out = a[int(i) - owner * per].clone(memory_format=torch.contiguous_format)
        else:
            out = a.new_empty(tuple(a.shape[1:]))
        return self.mesh.broadcast(out, src=owner)


@dataclasses.dataclass(frozen=True)
class ReplicatedSharding:
    """Every rank holds every lane."""

    mesh: Mesh

    @property
    def num_devices(self) -> int:
        return self.mesh.world_size

    def padded(self, B: int) -> int:
        return int(B)

    def lanes(self, B: int) -> range:
        return range(int(B))

    def gather(self, a: torch.Tensor, B: int) -> torch.Tensor:
        return a

    def lane(self, a: torch.Tensor, i: int, B: int) -> torch.Tensor:
        return a[int(i)]


def _rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default, else the one
    named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass devices='cpu' "
                               "for a mesh of host processes")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % torch.cuda.device_count())
    else:
        device = torch.device(devices)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device} asked for, but there is no CUDA device")
    return device


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "batch",
              devices: Optional[Union[str, torch.device]] = None) -> Mesh:
    """1-D mesh over the world of processes.

    The world is the default process group's (a world of one without one).
    A process owns one device, so ``n_devices``, where given, must be the
    world size.  ``devices``: this rank's device (``"cpu"``, ``"cuda:0"``); by
    default ``cuda:LOCAL_RANK``, and without a card the call raises unless
    the CPU is named.
    """
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices} differs from the world size {world}: a process "
            f"owns one device and there are no virtual devices; start {n_devices} "
            "processes")
    return Mesh(rank, world, _rank_device(devices, rank), (axis_name,), group)


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> BatchSharding:
    """Shard the leading (instance) axis over the mesh; everything else
    replicated."""
    return BatchSharding(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Form the default process group of ``num_processes`` processes
    (no-op for one process or fewer, or when this world is already formed).

    ``coordinator_address`` is ``host:port`` of rank 0's store (TCP);
    ``backend`` is NCCL unless the caller names another (``"gloo"`` for host
    processes, or for ranks that share a card).  :data:`TIMEOUT` bounds the
    forming and every collective."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (this one "
                f"{dist.get_rank()}) already exists")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address and process_id")
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("NCCL needs a CUDA device; name backend='gloo' for host "
                           "processes")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=TIMEOUT)
