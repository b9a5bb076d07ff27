"""Skyscraper2 hash over BN254-Fr: scalar reference + batched torch/CUDA version.

The permutation is 18 feistel-ish steps over a 2-element state
(reference spec: ``skyscraper/core/src/reference.rs:49-98``; optimized ladder
``skyscraper/core/src/generic.rs:77-102``):

    step k:  (l, r) <- (r + f_k(l) + RC[k],  l)

with ``f_k = square-sigma`` for k in {0..5, 8, 9, 12..17} and ``f_k = bar``
for k in {6, 7, 10, 11}.  ``square-sigma(x) = x^2 * SIGMA_INV`` where
``SIGMA_INV == (2^256)^-1 mod p`` — i.e. exactly a Montgomery square of the
canonical value (one REDC; this is why the reference's optimized ladder uses a
plain Montgomery square).  ``bar`` rotates the canonical little-endian byte
string by 16 bytes and applies an 8-bit S-box to every byte
(``reference.rs:80-98``).

``compress(l, r) = permute(l, r).left + l`` (``reference.rs:41-46``).

The batched implementation keeps a ``(16, n)`` canonical digit-plane tensor
per state element.  The kernels of this module, all in
``csrc/skyscraper.cu``: ``compress_v`` (one compression per pair),
``compress_fold_v`` (a Merkle leaf folded left to right in one launch),
``permute_v`` (one permutation per pair) and ``duplex_v`` (the sponge: a
whole absorb or squeeze in one launch).  On a CUDA tensor each launches its
kernel or raises; on a CPU tensor it runs its ``*_plain`` twin, the same
function in plain torch.  Round constants are protocol constants taken from
``skyscraper/core/src/constants.rs:30-49``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels as K

from ..fields import bn254 as F
from ..fields import vector as V

# Round constants (little-endian u64 limbs, non-Montgomery), protocol constants
# generated by the Skyscraper Sage reference (constants.rs:30-49).
_RC_U64 = [
    (0x0000000000000000, 0x0000000000000000, 0x0000000000000000, 0x0000000000000000),
    (0x903C4324270BD744, 0x873125F708A7D269, 0x081DD27906C83855, 0x276B1823EA6D7667),
    (0x7AC8EDBB4B378D71, 0xE29D79F3D99E2CB7, 0x751417914C1A5A18, 0x0CF02BD758A484A6),
    (0xFA7ADC6769E5BC36, 0x1C3F8E297CCA387D, 0x0EB7730D63481DB0, 0x25B0E03F18EDE544),
    (0x57847E652F03CFB7, 0x33440B9668873404, 0x955A32E849AF80BC, 0x002882FCBE14AE70),
    (0x979231396257D4D7, 0x29989C3E1B37D3C1, 0x12EF02B47F1277BA, 0x039AD8571E2B7A9C),
    (0xB5B48465ABBB7887, 0xA72A6BC5E6BA2D2B, 0x4CD48043712F7B29, 0x1142D5410FC1FC1A),
    (0x7AB2C156059075D3, 0x17CB3594047999B2, 0x44F2C93598F289F7, 0x1D78439F69BC0BEC),
    (0x05D7A965138B8EDB, 0x36EF35A3D55C48B1, 0x8DDFB8A1AC6F1628, 0x258588A508F4FF82),
    (0x1596FB9AFCCB49E9, 0x9A7367D69A09A95B, 0x9BC43F6984E4C157, 0x13087879D2F514FE),
    (0x295CCD233B4109FA, 0xE1D72F89ED868012, 0x2E9E1EEA4BC88A8E, 0x17DADEE898C45232),
    (0x9A8590B4AA1F486F, 0xB75834B430E9130E, 0xB8E90B1034D5DE31, 0x295C6D1546E7F4A6),
    (0x850ADCB74C6EB892, 0x07699EF305B92FC3, 0x4EF96A2BA1720F2D, 0x1288CA0E1D3ED446),
    (0x01960F9349D1B5EE, 0x8CCAD30769371C69, 0xE5C81E8991C98662, 0x17563B4D1AE023F3),
    (0x6BA01E9476B32917, 0xA1CB0A3ADD977BC9, 0x86815A945815F030, 0x2869043BE91A1EEA),
    (0x81776C885511D976, 0x7475D34F47F414E7, 0x5D090056095D96CF, 0x14941F0AFF59E79A),
    (0xBC40B4FD8FC8C034, 0xBB7142C3CCE4FD48, 0x318356758A39005A, 0x1CE337A190F4379F),
    (0x0000000000000000, 0x0000000000000000, 0x0000000000000000, 0x0000000000000000),
]

ROUND_CONSTANTS = [sum(l << (64 * i) for i, l in enumerate(limbs)) for limbs in _RC_U64]
SIGMA_INV = F.RINV  # sigma = 2^256: verified == reference.rs SIGMA_INV constant
BAR_STEPS = frozenset({6, 7, 10, 11})


# ---------------------------------------------------------------------------
# Scalar reference (Python ints, canonical form)


def sbox(v: int) -> int:
    def rotl(b, k):
        return ((b << k) | (b >> (8 - k))) & 0xFF

    return rotl(v ^ (rotl(~v & 0xFF, 1) & rotl(v, 2) & rotl(v, 3)), 1)


def bar(x: int) -> int:
    b = bytearray(F.to_bytes_le(x))
    b = b[16:] + b[:16]
    return int.from_bytes(bytes(sbox(v) for v in b), "little") % F.P


def _step(k: int, l: int, r: int) -> tuple[int, int]:
    f = bar(l) if k in BAR_STEPS else (l * l * SIGMA_INV) % F.P
    return (r + f + ROUND_CONSTANTS[k]) % F.P, l


def permute(l: int, r: int) -> tuple[int, int]:
    for k in range(18):
        l, r = _step(k, l, r)
    return l, r


def compress(l: int, r: int) -> int:
    return (permute(l, r)[0] + l) % F.P


def edge_values(seed: int) -> list[int]:
    """Canonical inputs at the edges of the ladder's arithmetic, to test a
    batched version against :func:`permute`: 0, 1, 2, P - 1, P - 2, 2^253,
    2^253 - 1, 2^256 mod P, P // 2, and four values (drawn from ``seed``)
    whose rotated, S-boxed bytes reach 4P before bar's reduction."""
    vals = [0, 1, 2, F.P - 1, F.P - 2, 1 << 253, (1 << 253) - 1, F.R,
            F.P // 2]
    rng = np.random.default_rng(seed)
    while len(vals) < 13:
        x = int.from_bytes(rng.bytes(32), "little") % F.P
        b = F.to_bytes_le(x)
        if int.from_bytes(bytes(sbox(v) for v in b[16:] + b[:16]),
                          "little") >= 4 * F.P:
            vals.append(x)
    return vals


# ---------------------------------------------------------------------------
# Batched version on (16, n) canonical digit planes

_SBOX_TABLE = np.array([sbox(v) for v in range(256)], dtype=np.uint32)
_RC_LIMBS = np.stack(
    [np.array(F.to_limbs(c), dtype=np.uint32) for c in ROUND_CONSTANTS])


@functools.lru_cache(maxsize=None)
def _sbox_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_SBOX_TABLE.astype(np.int64)).to(device)


def _bar_plain(x: torch.Tensor) -> torch.Tensor:
    # rotate the bytes by 16 == rotate the 16-bit digits by 8, then S-box
    # every byte through the 256-entry table and reduce mod P
    x = torch.roll(x, -8, dims=0).to(torch.int64)
    table = _sbox_table(x.device)
    y = table[x & 0xFF] | (table[x >> 8] << 8)
    return V.reduce_256(y.to(V.I32))


def _step_plain(k: int, l: torch.Tensor, r: torch.Tensor):
    """Step k of the ladder on (16, n) planes: (r + f_k(l) + RC[k], l)."""
    f = _bar_plain(l) if k in BAR_STEPS else V.mont_mul_plain(l, l)
    rc = V.const(ROUND_CONSTANTS[k], l.device)
    return V.add_mod(V.add_mod(r, f), rc), l


def _ladder_plain(l: torch.Tensor, r: torch.Tensor):
    for k in range(18):
        l, r = _step_plain(k, l, r)
    return l, r


def permute_plain(l: torch.Tensor, r: torch.Tensor):
    """Batched permutation in plain torch: l, r (16, n) canonical."""
    l, r = torch.broadcast_tensors(l, r)
    return _ladder_plain(l, r)


def compress_plain(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched 2-to-1 compression in plain torch."""
    l, r = torch.broadcast_tensors(l, r)
    return V.add_mod(_ladder_plain(l, r)[0], l)


def compress_fold_plain(leaves: torch.Tensor) -> torch.Tensor:
    """(16, leaf_size, n) -> (16, n): each leaf's elements folded left to
    right with :func:`compress_plain`."""
    h = leaves[:, 0, :]
    for i in range(1, leaves.shape[1]):
        h = compress_plain(h, leaves[:, i, :])
    return h


def duplex_plain(state: torch.Tensor, arr: torch.Tensor | None,
                 start_pos: int, n: int):
    """The sponge's duplex in plain torch, on a (16, 2) canonical state:
    absorb the columns of (16, k) ``arr`` from absorb position
    ``start_pos`` (rate 1: a full position permutes first), then squeeze
    ``n`` outputs.  Returns (state', (16, n) outputs)."""
    l, r = state[:, :1], state[:, 1:]
    pos = start_pos
    for i in range(0 if arr is None else arr.shape[1]):
        if pos == 1:
            l, r = permute_plain(l, r)
        l = arr[:, i:i + 1]
        pos = 1
    outs = []
    for _ in range(n):
        l, r = permute_plain(l, r)
        outs.append(l)
    return (torch.cat([l, r], dim=1),
            torch.cat(outs, dim=1) if outs else state.new_empty((16, 0)))


def duplex_permutations(k: int, start_pos: int, n: int) -> int:
    """Permutations of one duplex call: one before every absorbed unit that
    finds the position full, one per squeezed output."""
    return n + (k - 1 + start_pos if k else 0)


_PK_COMPRESS = K.Entry("pk_compress")
_PK_COMPRESS_FOLD = K.Entry("pk_compress_fold")
_PK_PERMUTE = K.Entry("pk_permute")
_PK_DUPLEX = K.Entry("pk_duplex")


def _views(name: str, l: torch.Tensor, r: torch.Tensor):
    dev = K.check_cuda_int32(name, l, r)
    shape = torch.broadcast_shapes(l.shape, r.shape)
    if len(shape) != 2:
        raise ValueError(f"{name}: expected (16, n) operands, got {shape}")
    n = shape[1]
    return dev, n, V._plane_view(l, shape, n), V._plane_view(r, shape, n)


def permute_v(l: torch.Tensor, r: torch.Tensor):
    """Skyscraper permutation of (16, n) canonical pairs -> (l', r').

    A CPU operand takes :func:`permute_plain`; a CUDA operand launches
    ``pk_permute`` (counted in ``permute_v.launches``) or raises."""
    if l.device.type == "cpu" and r.device.type == "cpu":
        return permute_plain(l, r)
    dev, n, (lv, l_rs, l_cs), (rv, r_rs, r_cs) = _views("permute", l, r)
    lo = torch.empty((16, n), dtype=V.I32, device=dev)
    ro = torch.empty((16, n), dtype=V.I32, device=dev)
    _PK_PERMUTE(dev, lv.data_ptr(), l_rs, l_cs, rv.data_ptr(), r_rs, r_cs,
                lo.data_ptr(), ro.data_ptr(), n)
    permute_v.launches += 1
    return lo, ro


permute_v.launches = 0


def compress_v(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Skyscraper 2-to-1 compression of (16, n) canonical pairs.

    A CPU operand takes :func:`compress_plain`; a CUDA operand launches
    ``pk_compress`` (counted in ``compress_v.launches``) or raises."""
    if l.device.type == "cpu" and r.device.type == "cpu":
        return compress_plain(l, r)
    dev, n, (lv, l_rs, l_cs), (rv, r_rs, r_cs) = _views("compress", l, r)
    out = torch.empty((16, n), dtype=V.I32, device=dev)
    _PK_COMPRESS(dev, lv.data_ptr(), l_rs, l_cs, rv.data_ptr(), r_rs, r_cs,
                 out.data_ptr(), n)
    compress_v.launches += 1
    return out


compress_v.launches = 0


def compress_fold_v(leaves: torch.Tensor) -> torch.Tensor:
    """(16, leaf_size, n) canonical leaves -> (16, n) digests, each leaf's
    elements folded left to right by the compression.

    A CPU operand takes :func:`compress_fold_plain`; a CUDA operand
    launches ``pk_compress_fold`` once, any strides (counted in
    ``compress_fold_v.launches``), or raises."""
    if leaves.device.type == "cpu":
        return compress_fold_plain(leaves)
    dev = K.check_cuda_int32("compress_fold", leaves)
    if leaves.dim() != 3 or leaves.shape[1] < 1:
        raise ValueError(f"compress_fold: expected (16, leaf_size, n) "
                         f"leaves, got {tuple(leaves.shape)}")
    n = leaves.shape[2]
    out = torch.empty((16, n), dtype=V.I32, device=dev)
    rs, is_, cs = leaves.stride()
    _PK_COMPRESS_FOLD(dev, leaves.data_ptr(), leaves.shape[1], rs, is_, cs,
                      out.data_ptr(), n)
    compress_fold_v.launches += 1
    return out


compress_fold_v.launches = 0


def duplex_v(state: torch.Tensor, arr: torch.Tensor | None, start_pos: int,
             n: int):
    """The sponge's duplex (see :func:`duplex_plain`) in one launch:
    absorb the k columns of ``arr`` (None for none) from ``start_pos``,
    then squeeze ``n``.  Returns (state', (16, n) outputs), two views of one
    (16, 2 + n) block.

    A CPU state takes :func:`duplex_plain`; a CUDA state launches
    ``pk_duplex`` (counted in ``duplex_v.launches``, its permutations in
    ``duplex_v.permutations``) or raises."""
    k = 0 if arr is None else arr.shape[1]
    on_cpu = arr is None or arr.device.type == "cpu"
    if state.device.type == "cpu" and on_cpu:
        return duplex_plain(state, arr, start_pos, n)
    dev = K.check_cuda_int32("duplex", state, *(() if arr is None else (arr,)))
    if tuple(state.shape) != (16, 2) or start_pos not in (0, 1):
        raise ValueError(f"duplex: expected a (16, 2) state and start_pos 0 "
                         f"or 1, got {tuple(state.shape)}, {start_pos}")
    out = torch.empty((16, 2 + n), dtype=V.I32, device=dev)
    a_ptr, a_rs, a_cs = ((0, 0, 0) if arr is None
                         else (arr.data_ptr(), arr.stride(0), arr.stride(1)))
    _PK_DUPLEX(dev, state.data_ptr(), state.stride(0), state.stride(1),
               a_ptr, a_rs, a_cs, k, start_pos, n, out.data_ptr(),
               out.stride(0))
    duplex_v.launches += 1
    duplex_v.permutations += duplex_permutations(k, start_pos, n)
    return out[:, :2], out[:, 2:]


duplex_v.launches = 0
duplex_v.permutations = 0
