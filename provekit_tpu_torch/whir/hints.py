"""Merkle-opening / claimed-evaluation hints in the reference wire format.

Hints are proof data the verifier checks against absorbed roots but never
absorbs (spongefish ``merlin.hint`` / ``arthur.hint``).  Framing: each hint
in the NARG string is ``[u32 LE length][body]`` — pinned by the Go verifier
(``recursive-verifier/app/circuit/common.go:33-41``).

Bodies are ark-serialize ``CanonicalSerialize`` (uncompressed) of the exact
types the Go side deserializes (``common.go:44-85``, ``types.go:17-22``):

* ``merkle_proof``  -> ``MultiPath<KeccakDigest>`` — struct fields in order:
  ``leaf_siblings_hashes: Vec<Digest>`` (u64 LE count + 32-byte LE digests),
  ``auth_paths_prefix_lengths: Vec<u64>``,
  ``auth_paths_suffixes: Vec<Vec<Digest>>`` (prefix-compressed TOP-DOWN
  internal-node sibling paths; the Go side re-expands with
  ``PrefixDecodePath`` and reverses to climb bottom-up — mt.go:37-50),
  ``leaf_indexes: Vec<u64>``.
* ``stir_answers`` -> ``Vec<Vec<Fp256>>`` — per opened leaf, its field
  elements (32-byte LE each).
* ``deferred_weight_evaluations`` -> ``Vec<Fp256>``.
* ``claimed_evaluations`` -> ``ClaimedEvaluations { f_sums: Vec<Fp256>,
  g_sums: Vec<Fp256> }``.
"""

from __future__ import annotations

from ..fields import bn254 as F


def _vec_header(n: int) -> bytes:
    return n.to_bytes(8, "little")


def _take(data: bytes, pos: int, n: int):
    if pos + n > len(data):
        raise ValueError("hint truncated")
    return data[pos:pos + n], pos + n


def _read_u64(data: bytes, pos: int):
    b, pos = _take(data, pos, 8)
    return int.from_bytes(b, "little"), pos


def _read_scalar(data: bytes, pos: int):
    b, pos = _take(data, pos, 32)
    v = int.from_bytes(b, "little")
    if v >= F.P:
        raise ValueError("non-canonical scalar in hint")
    return v, pos


def _read_vec_len(data: bytes, pos: int, cap: int = 1 << 24):
    n, pos = _read_u64(data, pos)
    if n > cap:
        raise ValueError("absurd vector length in hint")
    return n, pos


# -- MultiPath<KeccakDigest> -------------------------------------------------


def serialize_multipath(leaf_indexes: list[int], leaf_siblings: list[int],
                        auth_paths_topdown: list[list[int]]) -> bytes:
    """ark-canonical MultiPath; paths are top-down internal siblings."""
    out = bytearray()
    out += _vec_header(len(leaf_siblings))
    for d in leaf_siblings:
        out += F.to_bytes_le(d)
    prefix_lengths = []
    suffixes = []
    prev: list[int] = []
    for path in auth_paths_topdown:
        shared = 0
        for a, b in zip(prev, path):
            if a != b:
                break
            shared += 1
        prefix_lengths.append(shared)
        suffixes.append(path[shared:])
        prev = path
    if auth_paths_topdown:
        # the first path is always sent whole
        prefix_lengths[0] = 0
        suffixes[0] = auth_paths_topdown[0]
    out += _vec_header(len(prefix_lengths))
    for l in prefix_lengths:
        out += l.to_bytes(8, "little")
    out += _vec_header(len(suffixes))
    for sfx in suffixes:
        out += _vec_header(len(sfx))
        for d in sfx:
            out += F.to_bytes_le(d)
    out += _vec_header(len(leaf_indexes))
    for i in leaf_indexes:
        out += int(i).to_bytes(8, "little")
    return bytes(out)


def deserialize_multipath(data: bytes):
    """-> (leaf_indexes, leaf_siblings, auth_paths_topdown)."""
    pos = 0
    n, pos = _read_vec_len(data, pos)
    siblings = []
    for _ in range(n):
        v, pos = _read_scalar(data, pos)
        siblings.append(v)
    np_, pos = _read_vec_len(data, pos)
    if np_ != n:
        raise ValueError("MultiPath field length mismatch")
    prefix_lengths = []
    for _ in range(np_):
        v, pos = _read_u64(data, pos)
        prefix_lengths.append(v)
    ns, pos = _read_vec_len(data, pos)
    if ns != n:
        raise ValueError("MultiPath field length mismatch")
    paths = []
    prev: list[int] = []
    for j in range(ns):
        k, pos = _read_vec_len(data, pos)
        sfx = []
        for _ in range(k):
            v, pos = _read_scalar(data, pos)
            sfx.append(v)
        shared = prefix_lengths[j] if j else 0
        if shared > len(prev):
            raise ValueError("MultiPath prefix length out of range")
        path = prev[:shared] + sfx
        paths.append(path)
        prev = path
    ni, pos = _read_vec_len(data, pos)
    if ni != n:
        raise ValueError("MultiPath field length mismatch")
    indexes = []
    for _ in range(ni):
        v, pos = _read_u64(data, pos)
        indexes.append(v)
    if pos != len(data):
        raise ValueError("trailing MultiPath bytes")
    return indexes, siblings, paths


# -- Vec<Vec<Fp256>> / Vec<Fp256> ---------------------------------------------


def serialize_stir_answers(leaf_values: list[list[int]]) -> bytes:
    out = bytearray()
    out += _vec_header(len(leaf_values))
    for vals in leaf_values:
        out += _vec_header(len(vals))
        for v in vals:
            out += F.to_bytes_le(v)
    return bytes(out)


def deserialize_stir_answers(data: bytes) -> list[list[int]]:
    pos = 0
    n, pos = _read_vec_len(data, pos)
    out = []
    for _ in range(n):
        k, pos = _read_vec_len(data, pos)
        vals = []
        for _ in range(k):
            v, pos = _read_scalar(data, pos)
            vals.append(v)
        out.append(vals)
    if pos != len(data):
        raise ValueError("trailing stir_answers bytes")
    return out


def serialize_scalar_vec(values: list[int]) -> bytes:
    out = bytearray(_vec_header(len(values)))
    for v in values:
        out += F.to_bytes_le(v)
    return bytes(out)


def deserialize_scalar_vec(data: bytes) -> list[int]:
    pos = 0
    n, pos = _read_vec_len(data, pos)
    out = []
    for _ in range(n):
        v, pos = _read_scalar(data, pos)
        out.append(v)
    if pos != len(data):
        raise ValueError("trailing scalar-vec bytes")
    return out


def serialize_claimed_evaluations(f_sums: list[int],
                                  g_sums: list[int]) -> bytes:
    return serialize_scalar_vec(f_sums) + serialize_scalar_vec(g_sums)


def deserialize_claimed_evaluations(data: bytes):
    pos = 0
    n, pos = _read_vec_len(data, pos)
    f_sums = []
    for _ in range(n):
        v, pos = _read_scalar(data, pos)
        f_sums.append(v)
    k, pos = _read_vec_len(data, pos)
    g_sums = []
    for _ in range(k):
        v, pos = _read_scalar(data, pos)
        g_sums.append(v)
    if pos != len(data):
        raise ValueError("trailing claimed_evaluations bytes")
    return f_sums, g_sums
