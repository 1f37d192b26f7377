"""The collectives of the port's mesh: the only calls into
``torch.distributed`` outside process-group set-up.

The reference's ``psum`` / ``all_gather`` / ``psum_scatter`` / ``ppermute``
run inside ``shard_map`` over a device mesh. Here each is a collective of
the mesh's process group, called by every rank with tensors of one shape:

  * ``all_gather_cat``: every rank's rows, concatenated in rank order;
  * ``ordered_sum``: the partials gathered, then added in rank order, so
    that every rank holds the same bits and two runs at one world size are
    bit-identical (an ``all_reduce`` adds in the backend's order);
  * ``reduce_scatter_ordered``: ``ordered_sum``, then the rank's rows;
  * ``ring_shift``: send to rank + 1, receive from rank - 1;
  * ``broadcast``: the tensor of one rank on every rank.

On a mesh of size 1 each returns its input (or the whole sum of one part)
and calls nothing. Gloo takes CPU tensors for all of these (its CUDA
support leaves out all_gather, reduce_scatter and send / recv), so on a
gloo group a tensor on the card is copied to host memory, exchanged, and
copied back: every gloo call does so, one code path. ``staged_bytes``
counts the bytes those copies move, both ways.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from compv_tpu_torch.parallel.mesh import FrameMesh, RowSharding

__all__ = ["all_gather_cat", "ordered_sum", "reduce_scatter_ordered",
           "ring_shift", "broadcast"]

# bytes copied between the card and host memory for gloo, since the
# counter was last set to 0
staged_bytes = 0


def _to_wire(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """``t`` flat and contiguous, where the group's backend takes it."""
    global staged_bytes
    t = t.reshape(-1).contiguous()
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        staged_bytes += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    global staged_bytes
    if t.device != device:
        staged_bytes += t.numel() * t.element_size()
        return t.to(device)
    return t


def _gather(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t`` in rank order, on ``t``'s
    device."""
    wire = _to_wire(t, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return _from_wire(torch.stack(parts), t.device).reshape(
        (mesh.size,) + tuple(t.shape))


def all_gather_cat(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), concatenated along dim 0 in
    rank order: the reference's ``all_gather(..., tiled=True)``."""
    if mesh.size == 1:
        return t
    g = _gather(t, mesh)
    return g.reshape((-1,) + tuple(t.shape[1:]))


def ordered_sum(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order on every rank: the
    reference's ``psum``, with one order of additions whatever the
    backend."""
    if mesh.size == 1:
        return t
    parts = _gather(t, mesh)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def reduce_scatter_ordered(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """This rank's rows of ``ordered_sum(t)``: the reference's
    ``psum_scatter(..., tiled=True)``. ``t.shape[0]`` must split evenly."""
    return RowSharding(mesh).shard(ordered_sum(t, mesh))


def _global(mesh: FrameMesh, group_rank: int) -> int:
    return dist.get_global_rank(mesh.group, group_rank)


def ring_shift(t: torch.Tensor, mesh: FrameMesh) -> torch.Tensor:
    """``t`` of rank - 1 (mod D): each rank sends its ``t`` to rank + 1 and
    receives from rank - 1, the reference's ``ppermute`` around the ring."""
    if mesh.size == 1:
        return t
    wire = _to_wire(t, mesh)
    recv = torch.empty_like(wire)
    d, r = mesh.size, mesh.rank
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, _global(mesh, (r + 1) % d), mesh.group),
        dist.P2POp(dist.irecv, recv, _global(mesh, (r - 1) % d), mesh.group),
    ])
    for req in reqs:
        req.wait()
    return _from_wire(recv, t.device).reshape(t.shape)


def broadcast(t: torch.Tensor, mesh: FrameMesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (same shape and dtype on each)."""
    if mesh.size == 1:
        return t
    wire = _to_wire(t, mesh)
    if wire.data_ptr() == t.data_ptr():
        wire = wire.clone()        # the caller's tensor stays as it was
    dist.broadcast(wire, _global(mesh, src), group=mesh.group)
    return _from_wire(wire, t.device).reshape(t.shape)
