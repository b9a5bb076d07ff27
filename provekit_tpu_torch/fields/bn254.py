"""BN254 scalar-field (Fr) constants and scalar (Python-int) reference arithmetic.

This is the proof field of the whole framework (reference:
``provekit/common/src/lib.rs:19`` pins ``FieldElement`` to the BN254 scalar
field).  The batched tensor arithmetic (``provekit_tpu_torch.fields.vector``)
computes the same values as the plain-integer functions in this module.

Scalars here are plain Python ints in ``[0, P)``.  Arbitrary-precision host
arithmetic is used for transcript bookkeeping, parameter derivation, twiddle
generation and test oracles; the hot batched paths run on the device via
``fields.vector`` and the CUDA kernels.
"""

from __future__ import annotations

# BN254 (alt_bn128) scalar field modulus.
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Number of bits / bytes / 16-bit limbs in the canonical representation.
BITS = 254
BYTES = 32
NLIMBS = 16  # 16 x 16-bit limbs = 256 bits
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery constants for R = 2^256.
R = (1 << 256) % P
R2 = (R * R) % P
R3 = (R * R2) % P
RINV = pow(R, P - 2, P)
# -P^-1 mod 2^16 (CIOS per-limb Montgomery factor).
NPRIME16 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

# Multiplicative generator of Fr* (matches ark-bn254 Fr::GENERATOR).
GENERATOR = 5
# 2-adicity: p - 1 = 2^28 * odd.
TWO_ADICITY = 28
ROOT_OF_UNITY = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)  # order 2^28

HALF = pow(2, P - 2, P)  # 1/2 mod p (reference: common/src/utils/mod.rs:23)


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return (P - a) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def sqr(a: int) -> int:
    return (a * a) % P


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    # extended Euclid: the same value as a^(P-2), about ten times faster
    return pow(a, -1, P)


def pow_(a: int, e: int) -> int:
    return pow(a, e, P)


def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (log_n <= 28)."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"2-adicity exceeded: {log_n} > {TWO_ADICITY}")
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)


def to_bytes_le(a: int) -> bytes:
    return int(a).to_bytes(BYTES, "little")


def from_bytes_le(b: bytes) -> int:
    return int.from_bytes(b, "little") % P


def to_limbs(a: int) -> list[int]:
    """Little-endian 16-bit limb decomposition (length NLIMBS)."""
    return [(a >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NLIMBS)]


def from_limbs(limbs) -> int:
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (LIMB_BITS * i)
    return acc


def to_mont(a: int) -> int:
    return (a * R) % P


def from_mont(a: int) -> int:
    return (a * RINV) % P


def _selfcheck() -> None:
    assert (P - 1) % (1 << TWO_ADICITY) == 0
    assert (P - 1) % (1 << (TWO_ADICITY + 1)) != 0
    w = root_of_unity(2)
    assert pow(w, 4, P) == 1 and pow(w, 2, P) != 1
    assert (NPRIME16 * P) % (1 << LIMB_BITS) == (1 << LIMB_BITS) - 1


_selfcheck()
