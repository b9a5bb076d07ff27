"""The active mesh and the layouts of a rank's shard.

Port of ``provekit_tpu/parallel/context.py``.  The JAX package has one
controller: under an active mesh it reshards the big arrays with
``jax.device_put`` and lets GSPMD and ``shard_map`` insert the collectives.
The port runs SPMD over ``torch.distributed`` instead, one process per
rank (:mod:`.launch`):

* every rank runs the same host-sequenced prover on the same ``r1cs``,
  ``witness`` and seeded ``rng``;
* the Fiat-Shamir sponge stays replicated: it is (16, 2) and every rank
  advances it identically;
* a rank holds its own shard of the arrays that are sharded, and the
  exchanges are explicit collectives (:mod:`.collectives`).

There is no counterpart of the JAX package's ``shard_body``: a kernel of
the port always sees the rank's local tensors, so nothing has to mark a
shard-local trace.

What is sharded under a mesh, as in the JAX package's prover: the Spartan
sumcheck rounds (cyclic layout, psum'd round sums), every WHIR sumcheck's
rounds (contiguous layout, psum'd round sums) and every Merkle tree's
subtrees (contiguous leaf blocks, the S subtree roots all-gathered).  What
stays replicated on every rank: the Reed-Solomon encodings and their NTTs,
the eq tables, the R1CS matvecs, the weighted sums, the OOD evaluations,
STIR and the PoW grind.  The JAX prover calls neither ``ntt_sharded`` nor
``merkle_root_sharded`` (only its tests and its dry run do), and the port
follows it.

Every value is an exact field element, so a sharded prove emits the bytes
of the single-device prove on every rank.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from . import collectives as C

_ACTIVE = None

# Below this many elements a rank, an array stays replicated: a round on a
# shard needs a pair.  (Correctness does not depend on it: sharded and
# replicated paths give the same bytes.)
MIN_PER_SHARD = 2


def active_mesh():
    """The mesh of the enclosing :func:`use_mesh`, or None."""
    return _ACTIVE


@contextmanager
def use_mesh(mesh):
    """Run a prove (or any prover stage) with its big arrays sharded over
    ``mesh`` (a :class:`.launch.Mesh`)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def shardable(n: int, mesh) -> bool:
    """Whether a last axis of ``n`` elements splits over ``mesh`` into
    equal shards of at least :data:`MIN_PER_SHARD` elements."""
    return n % mesh.size == 0 and n // mesh.size >= MIN_PER_SHARD


def sharded_rounds(n: int, count: int, mesh) -> int:
    """How many of ``count`` sumcheck rounds on ``n`` elements run on the
    ranks' shards: rounds while a shard holds a pair, so the last log2 S
    rounds of a sumcheck that reaches one element run replicated."""
    if not shardable(n, mesh):
        return 0
    return min(count, (n // mesh.size).bit_length() - 1)


def block(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's contiguous block of the last axis (a view)."""
    per = x.shape[-1] // mesh.size
    return x[..., mesh.rank * per:(mesh.rank + 1) * per]


def cyclic(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's cyclic shard of the last axis: local index l holds global
    index l * S + rank (a strided view)."""
    return x[..., mesh.rank::mesh.size]


def gather_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's contiguous block, back in natural order."""
    parts = C.all_gather(x, mesh)                # (S, *x.shape)
    return torch.cat(parts.unbind(0), dim=-1)


def gather_cyclic(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's cyclic shard, back in natural order."""
    parts = C.all_gather(x, mesh)                # (S, *x.shape)
    return torch.stack(parts.unbind(0), dim=-1).reshape(
        *x.shape[:-1], x.shape[-1] * mesh.size)
