"""Skyscraper Merkle tree: batched device level hashing + host path check.

Port of ``provekit_tpu/ops/merkle.py``: leaf digest = left fold of the 2-to-1
compression over the leaf's field elements, inner node = compress(l, r),
digests are field elements in canonical form.  The leaf digests are one
``compress_fold_v`` launch, every inner level one batched ``compress_v``
launch (the CUDA kernels on the card), all levels on the device.  The
verifier's path check runs in the port's native library
(``native.merkle_verify``); ``verify_path_plain`` is its plain version.

Under an active mesh (``parallel.context``) a tree with at least two leaves
a rank is built as the JAX package's ``_commit_sharded``: each rank hashes
its contiguous leaf block into a subtree, the S subtree roots are
all-gathered, and every rank finishes the top log2 S levels.  The tree then
holds only the rank's block of its lower levels, and the auth paths are
gathered with an owner-masked sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import native
from ..fields import vector as V
from ..hash import skyscraper as S
from ..parallel import collectives as C
from ..parallel import context as pctx


@dataclass
class MerkleTree:
    """levels[0] = leaf digests (16, n), levels[-1] = root (16, 1).

    Built under a mesh, ``levels[:sharded]`` hold only ``mesh.rank``'s
    contiguous block of each level, and the levels above are whole on every
    rank."""
    levels: list
    mesh: object = None
    sharded: int = 0

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def root(self) -> int:
        return V.unpack_scalar(self.levels[-1][:, 0])

    def open(self, indices: list[int]) -> list[list[int]]:
        """Auth path per index: sibling digests bottom-up (host ints)."""
        if not indices or self.depth == 0:
            return [[] for _ in indices]
        dev = self.levels[0].device
        idx = torch.tensor(indices, dtype=torch.int64, device=dev)
        flat = V.unpack(open_gather_dev(self, idx))
        q = len(indices)
        return [[flat[d * q + j] for d in range(self.depth)]
                for j in range(q)]


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """(16, leaf_size, n) -> (16, n) leaf digests (left-fold compress)."""
    if leaves.shape[1] == 1:
        return leaves[:, 0, :]
    return S.compress_fold_v(leaves)


def _up(levels: list) -> list:
    """Compress pairs of the last level until one digest is left."""
    while levels[-1].shape[1] > 1:
        cur = levels[-1]
        levels.append(S.compress_v(cur[:, 0::2], cur[:, 1::2]))
    return levels


def subtree_levels(leaves: torch.Tensor) -> list:
    """Every level of the tree over (16, leaf_size, n) leaves, the leaf
    digests first and the (16, 1) root last."""
    return _up([hash_leaves(leaves)])


def finish_sharded(mesh, local: list) -> MerkleTree:
    """The tree whose rank-``mesh.rank`` subtree has the levels ``local``:
    the S subtree roots all-gathered, the top levels compressed on every
    rank."""
    tops = C.all_gather(local[-1][:, 0], mesh).T     # (16, S)
    return MerkleTree(local[:-1] + _up([tops.contiguous()]), mesh,
                      len(local) - 1)


def commit_dev(leaves: torch.Tensor) -> MerkleTree:
    """Tree over (16, leaf_size, n_leaves) canonical leaves; n_leaves = 2^k.

    Under an active mesh, with at least two leaves a rank, each rank builds
    the subtree of its contiguous leaf block (:func:`finish_sharded`)."""
    mesh = pctx.active_mesh()
    if mesh is not None and pctx.shardable(leaves.shape[2], mesh):
        return finish_sharded(mesh, subtree_levels(pctx.block(leaves, mesh)))
    return MerkleTree(subtree_levels(leaves))


def root_dev(tree: MerkleTree) -> torch.Tensor:
    """Root digest as a (16, 1) canonical device tensor (no sync)."""
    return tree.levels[-1][:, :1]


def open_gather_dev(tree: MerkleTree, indices: torch.Tensor) -> torch.Tensor:
    """Auth paths for (q,) int64 leaf indices as (16, depth*q) digests.

    Sibling digests bottom-up, row-major by level (level d occupies columns
    [d*q, (d+1)*q)).  A sharded level gives the siblings its rank owns and
    zeros elsewhere; one owner-masked sum over all of them fills in the
    rest on every rank."""
    if len(tree.levels) <= 1:
        return V.zeros((0,), tree.levels[0].device)
    gathered, owned = [], []
    cur = indices
    for d, level in enumerate(tree.levels[:-1]):
        sib = cur ^ 1
        if d < tree.sharded:
            per = level.shape[1]
            local = sib - tree.mesh.rank * per
            mine = (local >= 0) & (local < per)
            gathered.append(level[:, local.clamp(0, per - 1)])
            owned.append(mine)
        else:
            gathered.append(level[:, sib])
        cur = cur >> 1
    if owned:
        gathered[:len(owned)] = [C.owner_sum(
            torch.cat(gathered[:len(owned)], dim=1),
            torch.cat(owned)[None, :], tree.mesh)]
    return torch.cat(gathered, dim=1)


def verify_path(root: int, leaf_values: list[int], index: int,
                path: list[int]) -> bool:
    """Host-side path check: hash leaf values, then climb with siblings."""
    return native.merkle_verify(leaf_values, path, index, root)


def verify_path_plain(root: int, leaf_values: list[int], index: int,
                      path: list[int]) -> bool:
    """:func:`verify_path` in Python, over ``hash.skyscraper.compress``."""
    h = leaf_values[0]
    for v in leaf_values[1:]:
        h = S.compress(h, v)
    i = index
    for sib in path:
        h = S.compress(h, sib) if i % 2 == 0 else S.compress(sib, h)
        i >>= 1
    return h == root
