"""The collectives of the sharded prover: the only functions of the port
that call ``torch.distributed``'s communication.

Each takes the rank's tensor and its :class:`.launch.Mesh`.  On a mesh with
no process group (``make_mesh(1)`` in-process) each is the identity of one
rank and counts nothing.  On a group each counts its calls and its bytes in
``mesh.counts``, under the stage it ran in: the outermost open span of
``utils.profiling.GLOBAL`` (the prover's five spans), or ``"-"``.

Backends, as the caller chose them at ``init_process_group``:

* NCCL: the collective runs on the CUDA tensors.
* gloo: a CUDA tensor is copied to the host and back inside the collective
  (gloo has ``all_reduce`` and ``broadcast`` on CUDA tensors, but no
  ``all_gather`` and no ``all_to_all``); the bytes copied both ways are
  counted as ``host_bytes``.  CPU tensors stay where they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields import vector as V
from ..utils import profiling


def _stage() -> str:
    stack = profiling.GLOBAL.stack
    return stack[1].name if len(stack) > 1 else "-"


def _count(mesh, op: str, nbytes: int, host_bytes: int) -> None:
    row = mesh.counts.setdefault((_stage(), op), [0, 0, 0])
    row[0] += 1
    row[1] += nbytes
    row[2] += host_bytes


def _to_wire(x: torch.Tensor, mesh) -> tuple[torch.Tensor, int]:
    """The tensor a collective sends, and the host bytes copied for it."""
    x = x.contiguous()
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu(), x.numel() * x.element_size()
    if mesh.backend == "nccl" and not x.is_cuda:
        raise ValueError(f"NCCL collective on a {x.device} tensor")
    return x, 0


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> tuple[torch.Tensor,
                                                             int]:
    if y.device == like.device:
        return y, 0
    return y.to(like.device), y.numel() * y.element_size()


def _all_reduce_sum(x: torch.Tensor, mesh, op: str) -> torch.Tensor:
    wire, host = _to_wire(x, mesh)
    if wire is x:
        wire = x.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
    out, back = _from_wire(wire, x)
    _count(mesh, op, wire.numel() * wire.element_size(), host + back)
    return out


def psum_mod(x: torch.Tensor, mesh) -> torch.Tensor:
    """Modular cross-rank sum of (16, *k) canonical partials: an ``int64``
    ``all_reduce`` of the digit planes (each sum < S * 2^16), then
    ``V.reduce_wide`` (the JAX package's ``_psum_mod``)."""
    if mesh.group is None:
        return x
    return V.reduce_wide(_all_reduce_sum(x.to(torch.int64), mesh, "psum_mod"))


def owner_sum(x: torch.Tensor, owned: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank gets the values of their owners: each entry of ``x`` is
    owned (``owned``, broadcast against ``x``) by exactly one rank, the
    others contribute zeros, and an ``all_reduce`` sums them, a bit-exact
    broadcast (the JAX package's ``_prove_replicated``)."""
    if mesh.group is None:
        return x
    masked = torch.where(owned, x, torch.zeros_like(x))
    return _all_reduce_sum(masked, mesh, "owner_sum")


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(S, *x.shape): every rank's ``x``, in rank order."""
    if mesh.group is None:
        return x[None]
    wire, host = _to_wire(x, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    out, back = _from_wire(torch.stack(parts), x)
    _count(mesh, "all_gather", wire.numel() * wire.element_size(),
           host + back)
    return out


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """x (S, ...): block t goes to rank t; returns (S, ...) whose block t
    came from rank t."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all: {tuple(x.shape)} on {mesh.size} ranks")
    if mesh.group is None:
        return x
    wire, host = _to_wire(x, mesh)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=mesh.group)
    out, back = _from_wire(out, x)
    _count(mesh, "all_to_all", wire.numel() * wire.element_size(),
           host + back)
    return out
