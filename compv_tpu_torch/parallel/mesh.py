"""Process-group meshes (mirror of ``compv_tpu/parallel/mesh.py``).

The reference runs one process over an N-device ``jax.sharding.Mesh`` and
``shard_map``s over its axes. The port runs SPMD: one process per rank in a
``torch.distributed`` group, and a ``FrameMesh`` names the group, this
process's rank in it, its size and the device the rank computes on. Axis
conventions are the reference's:

  "frame"  - data parallelism over frames / keyframes / observations
  "tile"   - spatial parallelism over image tiles within a frame

Every function of ``parallel.sharded`` takes the global batch and is called
collectively by all ranks of the mesh; rank r computes rows
[r n / D, (r + 1) n / D) of it (``frame_sharding``) and every rank returns
the same global result. A mesh of size 1 needs no process group: it is the
local path, with the same code.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from compv_tpu_torch.device import require_cuda

__all__ = ["FrameMesh", "make_mesh", "make_mesh_2d", "frame_sharding",
           "replicated", "P"]


@dataclass(frozen=True)
class FrameMesh:
    """One rank's view of a 1-D mesh: the process group (None for a mesh of
    size 1), this process's rank in it, the group's size, the device this
    rank computes on, and the axis name. ``axes`` holds the 1-D sub-meshes
    of a mesh that ``make_mesh_2d`` made, by axis name."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "frame"
    axes: tuple = ()

    def __getitem__(self, axis: str) -> "FrameMesh":
        """The sub-mesh along ``axis`` of a 2-D mesh."""
        for name, sub in self.axes:
            if name == axis:
                return sub
        raise KeyError(f"mesh has no axis {axis!r}")


def _device(device) -> torch.device:
    """The device a rank computes on: the caller's, else the card of this
    process's local rank (ranks share a card when there are fewer cards
    than ranks); raises where there is no card."""
    if device is not None:
        return torch.device(device)
    require_cuda()
    local = int(os.environ.get("LOCAL_RANK", _world()[0]))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world() -> tuple[int, int]:
    """(rank, world size) of the initialised default group, else (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices: int | None = None, axis: str = "frame",
              device=None) -> FrameMesh:
    """A mesh over the initialised process group (``n_devices`` None or the
    world size), or a mesh of size 1 (``n_devices`` 1, or no group): the
    local path, computed by each rank alone. ``device`` is the rank's
    device, the card by default."""
    rank, world = _world()
    n = world if n_devices is None else n_devices
    if n == 1:
        return FrameMesh(None, 0, 1, _device(device), axis)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n} "
                         f"(this one has {world}): call init_distributed")
    return FrameMesh(dist.group.WORLD, rank, world, _device(device), axis)


def make_mesh_2d(n_frame: int, n_tile: int, device=None) -> FrameMesh:
    """A ("frame", "tile") mesh over a group of ``n_frame * n_tile`` ranks:
    rank r sits at (r // n_tile, r % n_tile). ``mesh["frame"]`` is the group
    of the ranks that share r's tile index, ``mesh["tile"]`` that of the
    ranks that share its frame index. Every rank makes every sub-group, in
    one order, as ``torch.distributed.new_group`` requires."""
    rank, world = _world()
    if n_frame * n_tile != world:
        raise ValueError(f"a {n_frame} x {n_tile} mesh needs a process group "
                         f"of {n_frame * n_tile} (this one has {world})")
    dev = _device(device)

    def groups(members):
        mine = None
        for ranks in members:
            g = dist.new_group(ranks) if world > 1 else None
            if rank in ranks:
                mine = (g, ranks.index(rank), len(ranks))
        return mine

    fg = groups([[f * n_tile + t for f in range(n_frame)]
                 for t in range(n_tile)])
    tg = groups([[f * n_tile + t for t in range(n_tile)]
                 for f in range(n_frame)])
    subs = (("frame", FrameMesh(*fg, dev, "frame")),
            ("tile", FrameMesh(*tg, dev, "tile")))
    return FrameMesh(dist.group.WORLD if world > 1 else None, rank, world,
                     dev, "frame", subs)


class RowSharding:
    """Rows [r n / D, (r + 1) n / D) of a global tensor go to rank r."""

    def __init__(self, mesh: FrameMesh):
        self.mesh = mesh

    def bounds(self, n: int) -> tuple[int, int]:
        d = self.mesh.size
        if n % d:
            raise ValueError(f"{n} rows do not split over {d} ranks: pad "
                             f"them to a multiple of {d}")
        per = n // d
        return self.mesh.rank * per, (self.mesh.rank + 1) * per

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds(t.shape[0])
        return t[lo:hi]

    def unshard(self, parts) -> torch.Tensor:
        """The global tensor from every rank's part, in rank order."""
        return torch.cat(list(parts))


class Replicated:
    """Every rank holds the whole tensor."""

    def __init__(self, mesh: FrameMesh):
        self.mesh = mesh

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def unshard(self, parts) -> torch.Tensor:
        return list(parts)[0]


def frame_sharding(mesh: FrameMesh, axis: str = "frame") -> RowSharding:
    return RowSharding(mesh[axis] if mesh.axes else mesh)


def replicated(mesh: FrameMesh) -> Replicated:
    return Replicated(mesh)


class P(tuple):
    """A partition spec, kept as a plain name for parity with the
    reference's ``PartitionSpec``: ``P("frame")`` names the sharded axis,
    ``P()`` a replicated value."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)
