"""The mesh of one rank, and a launcher that starts the ranks.

The port's mesh is one-dimensional, named ``"shards"`` like the JAX
package's: a :class:`Mesh` holds the process group, the rank, the number of
ranks, the rank's device and the backend.  :func:`make_mesh` builds it in a
rank that :func:`launch` started (or any process that called
``init_process_group``); ``make_mesh(1)`` also works in-process with no
process group, where every collective is the identity.

No backend is chosen silently: :func:`launch` takes it from the caller,
NCCL with more ranks than visible cards raises, and ranks share one card
only when the caller says ``share_device=True`` (over gloo: NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclass
class Mesh:
    size: int
    rank: int
    device: torch.device
    group: object = None      # a torch.distributed ProcessGroup, or None
    backend: str | None = None
    # (stage, collective) -> [calls, bytes, host bytes] (collectives.py)
    counts: dict = field(default_factory=dict)


def make_mesh(world_size: int | None = None, backend: str | None = None,
              device="cuda") -> Mesh:
    """A 1-D mesh of all of the process group's ranks on this rank's
    ``device``.

    Outside a process group, ``make_mesh(1)`` is the in-process mesh of one
    rank with no group.  Inside one, ``world_size`` and ``backend``, if
    given, must be the group's."""
    device = torch.device(device)
    if not dist.is_initialized():
        if world_size in (None, 1):
            return Mesh(1, 0, device)
        raise RuntimeError(f"make_mesh({world_size}): no process group; "
                           "start the ranks with parallel.launch")
    size = dist.get_world_size()
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"make_mesh: backend {backend!r}, but the process "
                         f"group runs {actual!r}")
    if world_size is not None and world_size != size:
        raise ValueError(f"make_mesh({world_size}) in a group of {size} "
                         "ranks")
    return Mesh(size, dist.get_rank(), device, dist.group.WORLD, actual)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, world_size: int, backend: str, device: str,
                share_device: bool) -> torch.device:
    """The device of ``rank``; raise where the backend or the cards cannot
    give one."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices")
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: cuda or cpu")
    if share_device:
        if backend == "nccl" and world_size > 1:
            raise ValueError("NCCL refuses two ranks on one device; share "
                             "the card over gloo")
        return torch.device("cuda", 0)
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(f"{world_size} ranks on {device} but {cards} visible "
                         "cards; pass share_device=True to share one")
    return torch.device("cuda", rank)


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               share_device: bool, port: int, threads: int, fn, args,
               results) -> None:
    try:
        torch.set_num_threads(threads)
        dev = rank_device(rank, world_size, backend, device, share_device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank)
        try:
            mesh = make_mesh(world_size, backend, dev)
            out = fn(mesh, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world_size: int, backend: str, device: str = "cuda",
           share_device: bool = False, args: tuple = (),
           timeout: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, each a process
    spawned with ``torch.multiprocessing`` that joins a process group of
    ``backend`` on ``tcp://127.0.0.1:<free port>``; returns each rank's
    result, in rank order.

    ``fn`` must be importable by name (a module-level function), and its
    arguments and results picklable (CPU tensors, numpy arrays, bytes).
    Ranks take ``cuda:rank`` unless ``share_device``, which puts them all on
    ``cuda:0``; ``device="cpu"`` runs them on the host (gloo).  Each rank
    takes an equal share of the host's cores for its torch threads.  Raises
    if a rank fails, with its traceback, and stops every rank it started."""
    rank_device(world_size - 1, world_size, backend, device, share_device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    threads = max(1, (os.cpu_count() or 1) // world_size)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world_size, backend, device, share_device, port, threads, fn,
        args, results)) for rank in range(world_size)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    try:
        waited = 0.0
        while len(outs) + len(errors) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1.0
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"a rank exited with {dead[0]} and no "
                                  "result")
                if errors or (timeout is not None and waited > timeout):
                    break
                continue
            if ok:
                outs[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("launch: " + "\n".join(errors))
    if len(outs) < world_size:
        raise TimeoutError(f"launch: {world_size - len(outs)} ranks gave no "
                           f"result within {timeout} s")
    return [outs[r] for r in range(world_size)]
