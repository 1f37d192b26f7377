"""Run a function on a new process group of ranks spawned on this host.

``spawn(fn, nprocs, args)`` starts ``nprocs`` processes with the ``spawn``
method (a parent that has initialised CUDA cannot ``fork``), joins them
into one group at a free port of ``127.0.0.1`` (``init_distributed``),
calls ``fn(mesh, *args)`` on every rank with its ``global_frame_mesh`` and
returns the ranks' results in rank order, tensors copied to the CPU. A rank
that raises or dies fails the call with its traceback; ranks still running
then, or past ``timeout`` seconds, are killed. ``fn`` must be importable by
its module path (a function at the top level of a module).
"""
from __future__ import annotations

import multiprocessing
import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

from compv_tpu_torch.parallel.distributed import (global_frame_mesh,
                                                  init_distributed)

__all__ = ["spawn", "free_port"]


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_host(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _rank_main(fn, rank: int, nprocs: int, port: int, backend, device, args,
               results) -> None:
    try:
        init_distributed(f"127.0.0.1:{port}", nprocs, rank, backend)
        out = fn(global_frame_mesh(device=device), *args)
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), *, device=None, backend: str | None = None,
          timeout: float = 600.0) -> list:
    """``[fn(mesh, *args) of rank 0, ..., of rank nprocs - 1]`` from
    ``nprocs`` spawned ranks of a new group. ``device``: each rank's device
    (the card of its rank by default; ranks share a card when there are
    fewer); ``backend``: as ``init_distributed`` chooses by default."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                         args=(fn, rank, nprocs, port, backend, device, args,
                               results))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < nprocs:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{dead} exited without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [got[rank] for rank in range(nprocs)]
