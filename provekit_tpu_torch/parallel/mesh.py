"""Sharded sumcheck rounds, folds, NTT and Merkle root, one rank at a time.

Port of ``provekit_tpu/parallel/mesh.py``.  The JAX functions take global
arrays sharded over a ``shards`` mesh axis and run ``shard_map`` bodies;
these take the RANK's local shard and call the collectives themselves
(:mod:`.collectives`).  Layouts, as in the JAX package:

* Spartan: cyclic (global index = local * S + rank), so the MSB pairing
  and the fold are local; only the three round sums cross ranks.
* WHIR: contiguous blocks, so the LSB pairing and the fold are local.
* NTT: four-step, n = A x B with A = S: an ``all_to_all``, NTT_A on each
  rank's columns (K3 stages), an ``all_to_all`` back, the twiddle product
  (K1), NTT_B on the rank's row.
* Merkle: each rank hashes its subtree (the leaf fold and K4), the S
  subtree roots are all-gathered, and every rank finishes the top levels.

The prover itself runs the round functions through ``ops.fused`` and the
Merkle subtrees through ``ops.merkle.commit_dev``; it calls neither
:func:`ntt_sharded` nor :func:`merkle_root_sharded`, as the JAX prover does
not.
"""

from __future__ import annotations

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..ops import merkle
from ..ops import ntt as ntt_mod
from ..ops import sumcheck as sc
from . import collectives as C


def spartan_round_sharded(mesh, a, b, c, eq):
    """The three Spartan round sums of (16, L) cyclic shards, psum'd:
    (f0, f-1, f_inf), each (16,) Montgomery."""
    sums = sc.spartan_round_stacked(torch.stack([a, b, c, eq], dim=1))
    return tuple(C.psum_mod(torch.stack(sums, dim=1), mesh).unbind(1))


def fold_msb_sharded(mesh, x, alpha):
    """MSB fold of a (16, L) cyclic shard: local, (16, L/2) cyclic."""
    return sc.fold_stacked_msb(x[:, None], alpha)[:, 0]


def whir_round_sharded(mesh, f, w):
    """The three WHIR round sums of (16, L) contiguous blocks, psum'd."""
    sums = sc.whir_round_stacked(torch.stack([f, w], dim=1))
    return tuple(C.psum_mod(torch.stack(sums, dim=1), mesh).unbind(1))


def fold_lsb_sharded(mesh, x, alpha):
    """LSB fold of a (16, L) contiguous block: local, (16, L/2)."""
    return sc.fold_stacked_lsb(x[:, None], alpha)[:, 0]


def _ntt_columns(x: torch.Tensor, log_m: int, chunk: int) -> torch.Tensor:
    """NTT along the major axis of (16, m * chunk), each of the ``chunk``
    minor columns a transform, on ``ntt_stage`` (K3) whatever the chunk."""
    dev = x.device
    tw = ntt_mod._twiddle_table(log_m, False, dev)
    for s in range(log_m):
        x = ntt_mod.ntt_stage(x, tw, s, chunk)
    rev = ntt_mod._bitrev_index(log_m, dev)
    return x.reshape(16, 1 << log_m, chunk)[:, rev].reshape(16, -1)


def ntt_sharded(mesh, x, log_n: int):
    """Distributed forward NTT of 2^log_n Montgomery coefficients.

    ``x`` (16, B) is the rank's contiguous row j1 = rank of the (A, B)
    matrix c[j1 * B + j2], A = S.  Returns the rank's row k1 = rank of the
    output: (16, B) holding X[k2 * A + k1] at k2, the JAX package's
    (k1, k2) layout.  With n = A * B, k = k2 * A + k1, j = j1 * B + j2:
        X[k] = sum_j2 W_B^(k2 j2) W_n^(k1 j2) sum_j1 W_A^(k1 j1) c[j]."""
    s, me = mesh.size, mesh.rank
    n = 1 << log_n
    b_dim = n // s
    if s & (s - 1) or b_dim % s or x.shape != (16, b_dim):
        raise ValueError(f"ntt_sharded: (16, {b_dim}) rows of 2^{log_n} on "
                         f"{s} ranks, got {tuple(x.shape)}")
    cols = b_dim // s
    # block t (my j1 row's columns j2 in [t*cols, (t+1)*cols)) to rank t
    got = C.all_to_all(x.reshape(16, s, cols).transpose(0, 1), mesh)
    # (16, A = j1, cols): NTT_A over j1 for each of my columns
    step1 = _ntt_columns(got.transpose(0, 1).reshape(16, s * cols),
                         s.bit_length() - 1, cols)
    # row k1 goes to rank k1; it comes back as (source t, cols) = j2 order
    back = C.all_to_all(step1.reshape(16, s, cols).transpose(0, 1), mesh)
    mine = back.transpose(0, 1).reshape(16, b_dim)
    tw = ntt_mod._power_table(pow(F.root_of_unity(log_n), me, F.P), b_dim,
                              x.device)
    mine = V.mont_mul(mine, tw)
    return ntt_mod._ntt_core(mine, b_dim.bit_length() - 1, False)


def merkle_root_sharded(mesh, leaves):
    """Merkle root of (16, leaf, n) canonical leaves from the rank's
    contiguous block (16, leaf, n / S): (16,) canonical, on every rank."""
    tree = merkle.finish_sharded(mesh, merkle.subtree_levels(leaves))
    return tree.levels[-1][:, 0]
