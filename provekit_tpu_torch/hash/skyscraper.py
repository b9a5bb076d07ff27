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
per state element.  ``permute`` and ``compress`` are the kernels of this
module (``permute_v``, ``compress_v``): on a CUDA tensor they launch
``csrc/skyscraper.cu``; on a CPU tensor they run ``permute_plain`` /
``compress_plain``, the same functions in plain torch.  Round constants are protocol
constants taken from ``skyscraper/core/src/constants.rs:30-49``.
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
    K.launch("pk_permute", dev, lv.data_ptr(), l_rs, l_cs, rv.data_ptr(),
             r_rs, r_cs, lo.data_ptr(), ro.data_ptr(), n)
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
    K.launch("pk_compress", dev, lv.data_ptr(), l_rs, l_cs, rv.data_ptr(),
             r_rs, r_cs, out.data_ptr(), n)
    compress_v.launches += 1
    return out


compress_v.launches = 0
