"""Passport validity circuits: the composed "flagship" workload.

Port of ``provekit_tpu/circuits/passport.py``: the same programs and witnesses.

Counterpart of ``noir-examples/noir-passport-examples/complete_age_check``
(``src/main.nr:36-70``), the largest program in the reference's compiler
test matrix (``tooling/provekit-bench/tests/compiler.rs:85``).  The
reference circuit composes four statements over a machine-readable-zone
document (DG1) and its Security Object Document (SOD):

1. ``compare_age``     — the MRZ birth-date field proves age >= min_age at
   the public current date (``zkpassport_libs/compare/age``).
2. ``check_expiry``    — the MRZ expiry-date field is not in the past
   (``zkpassport_libs/data-check/expiry``).
3. ``check_dg1_hash_within_sod`` — SHA-256(DG1) appears at a (private)
   offset inside the SOD (``passport_validity_check/src/lib.nr:173-180``)
   — a hash + dynamic-index memory-read composition.
4. a signature over (a digest of) the SOD verifies under a document-signer
   public key.  The reference's ``complete_age_check`` uses RSA-2048
   (``sig_check_rsa``); its zkpassport library set also ships the ECDSA
   P-256 variant (``zkpassport_libs/sig-check/ecdsa/src/lib.nr``), which is
   what this module composes — the non-native-arithmetic load is the same
   class (bignum mul gadgets over a 256-bit modulus).

Layout used here (TD3 passports): DG1 is 95 bytes = 5-byte header + 90-byte
MRZ; birth date YYMMDD at bytes 62..68, expiry YYMMDD at 70..76, both ASCII
digits.  Dates compare as integers with the standard two-digit-year window
(birth years above the current YY are 19xx).  All DG1/SOD bytes are
range-checked u8 witnesses; the SOD is a ROM block (indexed-LogUp lowering,
``compiler/memory.py``) read at offset+i for the 32 digest bytes.
"""

from __future__ import annotations

import hashlib

from ..acir import model as acir
from ..fields import bn254 as F
from . import p256
from .p256 import LB, NN, Builder, ECPoint, NNContext
from .sha256 import sha256_bytes_gadget

DG1_LEN = 95
SOD_LEN = 700
BIRTH_OFF = 62
EXPIRY_OFF = 70


# --- small comparison gadgets -------------------------------------------------


def ascii_digit(b: Builder, byte_w: acir.Witness) -> acir.Witness:
    """d = byte - '0' with 0 <= d <= 9 proven (d and 9-d both 4-bit)."""
    d = b.linear([(1, byte_w)], -ord("0"))
    b.range(d, 4)
    nine_minus = b.linear([(-1, d)], 9)
    b.range(nine_minus, 4)
    return d


def digits_to_num(b: Builder, byte_ws: list) -> acir.Witness:
    """ASCII-digit bytes (big-endian decimal) -> number witness."""
    digits = [ascii_digit(b, w) for w in byte_ws]
    n = len(digits)
    return b.linear([(10 ** (n - 1 - i), d) for i, d in enumerate(digits)])


def assert_le(b: Builder, lo_terms, hi_terms, const: int, bits: int) -> None:
    """sum(hi) - sum(lo) + const >= 0, proven by a ``bits``-wide witness."""
    val = (sum(c * b.val(w) for c, w in hi_terms)
           - sum(c * b.val(w) for c, w in lo_terms) + const)
    assert 0 <= val < (1 << bits), f"comparison violated at build: {val}"
    diff = b.new_witness(val)
    b.range(diff, bits)
    b.assert_linear([(c, w) for c, w in hi_terms]
                    + [(-c, w) for c, w in lo_terms] + [(-1, diff)], const)


def gt_bit(b: Builder, a_w: acir.Witness, b_w: acir.Witness,
           bound_bits: int) -> acir.Witness:
    """t = (a > b) as a constrained bit, for a, b < 2^bound_bits - 1.

    e = t ? (a - b - 1) : (b - a) is witnessed and range-checked, which
    pins t: the other branch would make e negative (huge mod p).
    """
    av, bv = b.val(a_w), b.val(b_w)
    t = b.new_witness(1 if av > bv else 0)
    b.opcodes.append(acir.AssertZero(acir.Expression(
        mul_terms=[(1, t, t)], linear_combinations=[(F.P - 1, t)])))
    e = b.new_witness((av - bv - 1) if av > bv else (bv - av))
    b.range(e, bound_bits)
    # e = (b - a) + t*(2a - 2b - 1)
    b.opcodes.append(acir.AssertZero(acir.Expression(
        mul_terms=[(2, t, a_w), (F.P - 2, t, b_w)],
        linear_combinations=[(1, b_w), (F.P - 1, a_w), (F.P - 1, t),
                             (F.P - 1, e)])))
    return t


# --- the composed circuit -----------------------------------------------------


def passport_circuit(dg1: bytes, sod: bytes, dg1_offset_in_sod: int,
                     current_date: str, min_age: int,
                     signature=None, sig_nbits: int = 256):
    """Build the composed passport circuit + witness assignment.

    ``signature``: None (hash/date/ROM checks only) or (pub, r, s) — an
    ECDSA P-256 signature over SHA-256(SOD), verified in-circuit against
    the in-circuit digest (the DSC-signature leg of the reference's
    ``check_passport_validity``).

    Returns (acir.Program, acir_values).
    """
    assert len(dg1) == DG1_LEN and len(sod) == SOD_LEN
    assert sod[dg1_offset_in_sod:dg1_offset_in_sod + 32] == \
        hashlib.sha256(dg1).digest(), "SOD does not contain H(DG1)"
    assert len(current_date) == 8 and current_date.isdigit()

    b = Builder()

    # private inputs: DG1 bytes, SOD bytes, the hash offset
    dg1_ws = [b.new_witness(v) for v in dg1]
    sod_ws = [b.new_witness(v) for v in sod]
    off_w = b.new_witness(dg1_offset_in_sod)
    # public inputs: current date (8 ASCII bytes), min_age
    date_ws = [b.new_witness(ord(ch)) for ch in current_date]
    age_w = b.new_witness(min_age)
    n_inputs = b.next_witness

    for w in dg1_ws + sod_ws + date_ws:
        b.range(w, 8)
    b.range(off_w, 10)
    b.range(age_w, 8)

    # -- date checks (compare_age / check_expiry) ---------------------------
    cur_full = digits_to_num(b, date_ws)              # YYYYMMDD
    cur_yy = digits_to_num(b, date_ws[2:4])
    birth_num = digits_to_num(b, dg1_ws[BIRTH_OFF:BIRTH_OFF + 6])   # YYMMDD
    birth_yy = digits_to_num(b, dg1_ws[BIRTH_OFF:BIRTH_OFF + 2])
    expiry_num = digits_to_num(b, dg1_ws[EXPIRY_OFF:EXPIRY_OFF + 6])

    # century window: birth_yy > cur_yy  =>  19xx else 20xx
    t = gt_bit(b, birth_yy, cur_yy, 7)
    # birth_full = birth_num + 1e6*(20 - t); age check:
    #   birth_full + 1e4*min_age <= cur_full
    assert_le(b,
              lo_terms=[(1, birth_num), (-1_000_000, t), (10_000, age_w)],
              hi_terms=[(1, cur_full)],
              const=-20_000_000, bits=27)
    # expiry window: always 20xx; expiry_full >= cur_full
    assert_le(b, lo_terms=[(1, cur_full)], hi_terms=[(1, expiry_num)],
              const=20_000_000, bits=27)

    # -- H(DG1) within SOD (sha256 + ROM reads at dynamic offset) -----------
    dg1_digest = sha256_bytes_gadget(b, dg1_ws, DG1_LEN)
    b.opcodes.append(acir.MemoryInit(block_id=0, init=list(sod_ws)))
    for i in range(32):
        idx = b.linear([(1, off_w)], i)
        b.opcodes.append(acir.MemoryOp(block_id=0, op=acir.MemOp(
            operation=0,
            index=acir.Expression.from_witness(idx),
            value=acir.Expression.from_witness(dg1_digest[i]))))

    # -- signature over SHA-256(SOD) ----------------------------------------
    if signature is not None:
        pub, r, s = signature
        sod_digest = sha256_bytes_gadget(b, sod_ws, SOD_LEN)
        fp = NNContext(b, p256.P256_P)
        fn = NNContext(b, p256.P256_N)
        # recompose 32 big-endian digest bytes into 120/120/16-bit limbs
        # (15+15+2 bytes) — loosely-reduced h for the ECDSA gadget
        def limb(byte_slice, hi_byte_index):
            return b.linear([(1 << (8 * (hi_byte_index - k)), w)
                             for k, w in enumerate(byte_slice)])
        h_nn = NN((limb(sod_digest[17:32], 14),
                   limb(sod_digest[2:17], 14),
                   limb(sod_digest[0:2], 1)))
        assert fn.value(h_nn) == int.from_bytes(
            hashlib.sha256(sod).digest(), "big")
        q_pt = ECPoint(fp.witness(pub[0]), fp.witness(pub[1]))
        r_nn = fn.witness(r)
        s_nn = fn.witness(s)
        p256.ecdsa_verify_gadget(b, q_pt, r_nn, s_nn, h_nn, fp, fn,
                                 nbits=sig_nbits)

    circuit = acir.Circuit(
        opcodes=b.opcodes,
        private_parameters=list(range(n_inputs - 9)),
        public_parameters=list(range(n_inputs - 9, n_inputs)),
        return_values=[],
        current_witness_index=b.next_witness)
    return acir.Program(functions=[circuit]), dict(b.values)


def passport_test_vector(seed: int = 1, with_signature: bool = True,
                         current_date: str = "20260819", min_age: int = 18):
    """Deterministic (dg1, sod, offset, signature) fixture.

    DG1 carries a synthetic TD3 MRZ with birth date 1990-01-02 and expiry
    2030-12-31; the SOD embeds SHA-256(DG1) at a seed-derived offset and is
    ECDSA-signed over its own SHA-256 digest.
    """
    rng_bytes = hashlib.sha256(b"passport-%d" % seed).digest()
    mrz = bytearray(b"<" * DG1_LEN)
    mrz[:5] = b"\x61\x5b\x5f\x1f\x58"          # DG1 tag/length header
    mrz[5:44] = b"P<UTOERIKSSON<<ANNA<MARIA<<<<<<<<<<<<<<"
    mrz[BIRTH_OFF:BIRTH_OFF + 6] = b"900102"
    mrz[EXPIRY_OFF:EXPIRY_OFF + 6] = b"301231"
    dg1 = bytes(mrz)

    offset = 64 + (seed * 37) % 256
    sod = bytearray((rng_bytes * ((SOD_LEN // 32) + 1))[:SOD_LEN])
    sod[offset:offset + 32] = hashlib.sha256(dg1).digest()
    sod = bytes(sod)

    signature = None
    if with_signature:
        d = int.from_bytes(hashlib.sha256(b"passport-key-%d" % seed).digest(),
                           "big") % p256.P256_N
        k = int.from_bytes(hashlib.sha256(b"passport-k-%d" % seed).digest(),
                           "big") % p256.P256_N
        h = int.from_bytes(hashlib.sha256(sod).digest(), "big")
        pub = p256.ec_mul(d, (p256.P256_GX, p256.P256_GY))
        r, s = p256.ecdsa_sign(h % p256.P256_N, d, k)
        signature = (pub, r, s)
    return dg1, sod, offset, current_date, min_age, signature
