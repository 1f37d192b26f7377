"""Multi-process bring-up (mirror of ``compv_tpu/parallel/distributed.py``).

The reference wraps ``jax.distributed.initialize``; here a
``torch.distributed`` process group is made from an explicit address, world
size and rank (``tcp://host:port``), or from the launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), and with
neither it is a single-process run that needs nothing. Nothing here tells a
program of a cluster: the caller gives the address.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from compv_tpu_torch.parallel.mesh import FrameMesh, make_mesh

__all__ = ["init_distributed", "global_frame_mesh", "process_frame_slice",
           "choose_backend"]


def choose_backend(world_size: int, local_size: int | None = None) -> str:
    """``nccl`` when this host has two or more cards and one rank per card
    (``local_size``, the ranks on this host, defaults to the world size),
    ``gloo`` otherwise: ranks that share a card, or run on the CPU, talk
    through gloo, which stages card tensors through host memory
    (``parallel._collectives``)."""
    cards = torch.cuda.device_count()
    local = world_size if local_size is None else local_size
    if cards >= 2 and local == cards and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join (or make) the default process group of ``num_processes`` ranks
    as rank ``process_id``, rendezvousing at ``coordinator_address``
    (``host:port`` or ``tcp://host:port``). A no-op when the group is
    already initialised with that world size; raises when its size
    differs. Without an address, the launcher's environment (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``) is used; without that either, this is a
    single-process run and nothing is done. ``backend`` None chooses with
    ``choose_backend``; ``torch.distributed.get_backend()`` says which ran."""
    if dist.is_initialized():
        if coordinator_address is not None \
                and dist.get_world_size() != (num_processes or 1):
            raise RuntimeError(
                f"the process group has {dist.get_world_size()} ranks, "
                f"not {num_processes or 1}")
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "RANK",
                                             "WORLD_SIZE")):
            return
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = num_processes or 1, process_id or 0
    local = os.environ.get("LOCAL_WORLD_SIZE")
    backend = backend or choose_backend(world, None if local is None
                                        else int(local))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def global_frame_mesh(axis: str = "frame", device=None) -> FrameMesh:
    """1-D mesh over every rank of the default group (size 1 without one).
    ``device`` is this rank's device, the card of its local rank by
    default."""
    return make_mesh(None, axis, device)


def process_frame_slice(n_frames: int) -> tuple[int, int]:
    """[lo, hi): the slice of a global frame list this rank loads, by the
    reference's ceiling split (the last ranks may get fewer, or none)."""
    if dist.is_initialized():
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        p, n = 0, 1
    per = (n_frames + n - 1) // n
    lo = p * per
    return lo, min(lo + per, n_frames)
