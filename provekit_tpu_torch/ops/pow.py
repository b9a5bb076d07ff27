"""Proof-of-work grinding (WHIR round grinding) on the device.

Port of ``provekit_tpu/ops/pow.py``: the condition is
``compress(challenge, nonce) < threshold`` with ``threshold ~ 2^-bits * p``
computed through the reference's f64 path, the prover grinding at the
biased threshold ``threshold(bits + PROVER_BIAS)``.  The verifier's check and
the sequential host solver run the compression in the port's native library
(``native.compress``).  The device solver scans blocks
of ``_block_size(bits)`` nonces, one batched compress per block, and returns
the SMALLEST satisfying nonce of the first block that has one (a minimum
over the block, never the first hit a racing thread finds), so the
transcript equals the JAX package's byte for byte.
"""

from __future__ import annotations

import struct

import torch

from .. import native
from ..fields import bn254 as F
from ..fields import vector as V
from ..hash import skyscraper as S

PROVER_BIAS = 0.01


def _f64_parts(f: float) -> tuple[bool, int, int]:
    bits = struct.unpack("<Q", struct.pack("<d", f))[0]
    sign = bits >> 63 != 0
    exp_bits = (bits >> 52) & 0x7FF
    frac = bits & ((1 << 52) - 1)
    if exp_bits == 0:
        return sign, -1022, frac
    return sign, exp_bits - 1023, frac + (1 << 52)


def _f64_to_u256(f: float) -> int:
    if f != f:  # NaN -> MAX (matches reference's exp>256 branch)
        return (1 << 256) - 1
    sign, exp, significand = _f64_parts(f)
    if sign:
        return 0
    if exp > 256:
        return (1 << 256) - 1
    shift = exp - 52
    if shift < 0:
        return int(f + 0.5)
    return significand << shift


def threshold(difficulty: float) -> int:
    assert 0.0 <= difficulty < 80.0, "difficulty must be in [0, 80)"
    modulus = float(F.P >> 192) * 2.0 ** 192
    prob = 2.0 ** (-difficulty)
    return min(_f64_to_u256(prob * modulus), (1 << 256) - 1)


def verify(challenge: int, difficulty: float, nonce: int) -> bool:
    if difficulty == 0.0:
        return True
    return native.compress(challenge, nonce) < threshold(difficulty)


def solve_host_sequential(challenge: int, difficulty: float) -> int:
    """The first satisfying nonce by a sequential scan on the host: the
    device solver's nonce (the smallest in its first block with a hit), at
    the same biased threshold."""
    if difficulty == 0.0:
        return 0
    thresh = threshold(difficulty + PROVER_BIAS)
    nonce = 0
    while native.compress(challenge, nonce) >= thresh:
        nonce += 1
    return nonce


def _block_size(difficulty: float) -> int:
    return 1 << min(26, max(12, int(difficulty) + 2))


def less_than_mask(a: torch.Tensor, bound: int) -> torch.Tensor:
    """(16, n) canonical planes -> (n,) mask of value < bound."""
    x = a.to(torch.int64)
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(lt)
    for i in range(15, -1, -1):
        b = (bound >> (16 * i)) & 0xFFFF
        lt |= ~decided & (x[i] < b)
        decided |= x[i] != b
    return lt


def solve_dev(challenge: torch.Tensor, difficulty: float) -> torch.Tensor:
    """(16, 1) canonical device challenge -> (16, 1) canonical nonce.

    Nonces are 32-bit, as in the JAX package's device solver.  The host
    reads one flag per block to stop the scan."""
    dev = challenge.device
    if difficulty == 0.0:
        return V.zeros((1,), dev)
    block = _block_size(difficulty)
    thresh = threshold(difficulty + PROVER_BIAS)
    base = torch.arange(block, dtype=torch.int64, device=dev)
    offset = 0
    while True:
        lo = (base + offset) & 0xFFFFFFFF
        nonces = torch.zeros((16, block), dtype=V.I32, device=dev)
        nonces[0] = lo & 0xFFFF
        nonces[1] = lo >> 16
        mask = less_than_mask(S.compress_v(challenge, nonces), thresh)
        first = torch.where(mask, base, block).min()
        if int(first) < block:
            nonce = (offset + first) & 0xFFFFFFFF
            out = V.zeros((1,), dev)
            out[0, 0] = nonce & 0xFFFF
            out[1, 0] = nonce >> 16
            return out
        offset += block
