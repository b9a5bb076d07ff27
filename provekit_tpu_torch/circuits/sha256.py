"""SHA-256 circuits: the bitwise/lookup-heavy benchmark workload.

The reference's measurement protocol includes ``noir-examples/sha256`` /
``noir-native-sha256`` (BASELINE.md step 2; ``noir-examples/noir-r1cs-test-
programs/small-sha`` in the compiler test matrix).  Noir's stdlib sha256
lowers to ACIR as 32-bit AND/XOR blackbox calls plus range-checked
decompositions; this module builds that ACIR shape programmatically — a
full message-schedule + compression function over u32 words, with every
rotation/shift done by a range-checked split and every ∧/⊕ emitted as a
``BlackBoxAnd``/``BlackBoxXor`` (which the compiler lowers to the 2^16
8-bit-atom LogUp table, ``compiler/binops.py``).

The digest is checked against ``hashlib.sha256`` at build time, so the
generated witness is a known-answer test for the whole gadget stack.
"""

from __future__ import annotations

import hashlib
from math import isqrt

from ..acir import model as acir
from ..fields import bn254 as F

MASK32 = 0xFFFFFFFF


def _icbrt(n: int) -> int:
    x = int(round(n ** (1 / 3)))
    while x * x * x > n:
        x -= 1
    while (x + 1) ** 3 <= n:
        x += 1
    return x


def _primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


_P64 = _primes(64)
# fractional parts of sqrt/cbrt of the first primes (FIPS 180-4 constants)
H0 = [isqrt(p << 64) & MASK32 for p in _P64[:8]]
K = [_icbrt(p << 96) & MASK32 for p in _P64]


class _Builder:
    """ACIR builder tracking the witness assignment alongside the opcodes."""

    def __init__(self):
        self.opcodes: list = []
        self.values: dict[int, int] = {}
        self.next_witness = 0

    def new_witness(self, value: int) -> acir.Witness:
        w = acir.Witness(self.next_witness)
        self.values[self.next_witness] = value % F.P
        self.next_witness += 1
        return w

    def val(self, w: acir.Witness) -> int:
        return self.values[w.index]

    def range(self, w: acir.Witness, bits: int) -> None:
        assert self.val(w) < (1 << bits)
        self.opcodes.append(acir.BlackBoxRange(acir.FunctionInput(w, bits)))

    def assert_linear(self, terms, const: int = 0) -> None:
        self.opcodes.append(acir.AssertZero(acir.Expression(
            linear_combinations=[(c % F.P, w) for c, w in terms],
            q_c=const % F.P)))

    def linear(self, terms, const: int = 0) -> acir.Witness:
        val = const + sum(c * self.val(w) for c, w in terms)
        out = self.new_witness(val)
        self.assert_linear(list(terms) + [(F.P - 1, out)], const)
        return out

    # -- u32 gadgets ---------------------------------------------------------

    def u32_input(self, value: int) -> acir.Witness:
        w = self.new_witness(value & MASK32)
        self.range(w, 32)
        return w

    def xor(self, a: acir.Witness, b: acir.Witness) -> acir.Witness:
        out = self.new_witness(self.val(a) ^ self.val(b))
        self.opcodes.append(acir.BlackBoxXor(
            acir.FunctionInput(a, 32), acir.FunctionInput(b, 32), out))
        return out

    def and_(self, a: acir.Witness, b: acir.Witness) -> acir.Witness:
        out = self.new_witness(self.val(a) & self.val(b))
        self.opcodes.append(acir.BlackBoxAnd(
            acir.FunctionInput(a, 32), acir.FunctionInput(b, 32), out))
        return out

    def not32(self, a: acir.Witness) -> acir.Witness:
        return self.linear([(F.P - 1, a)], MASK32)

    def _split(self, x: acir.Witness, r: int):
        """x = hi·2^r + lo with lo < 2^r, hi < 2^(32-r); returns (lo, hi)."""
        v = self.val(x)
        lo = self.new_witness(v & ((1 << r) - 1))
        hi = self.new_witness(v >> r)
        self.range(lo, r)
        self.range(hi, 32 - r)
        self.assert_linear([(1, x), (F.P - (1 << r), hi), (F.P - 1, lo)])
        return lo, hi

    def rotr(self, x: acir.Witness, r: int) -> acir.Witness:
        lo, hi = self._split(x, r)
        return self.linear([(1 << (32 - r), lo), (1, hi)])

    def shr(self, x: acir.Witness, r: int) -> acir.Witness:
        _, hi = self._split(x, r)
        return hi

    def add32(self, *words: acir.Witness) -> acir.Witness:
        """Sum of k u32 words reduced mod 2^32 (carry range-checked)."""
        total = sum(self.val(w) for w in words)
        lo = self.new_witness(total & MASK32)
        carry = self.new_witness(total >> 32)
        carry_bits = max(1, (len(words) - 1).bit_length())
        self.range(lo, 32)
        self.range(carry, carry_bits)
        self.assert_linear([(1, w) for w in words]
                           + [(F.P - 1, lo), (F.P - (1 << 32), carry)])
        return lo


def _sigma0(b, x):
    return b.xor(b.xor(b.rotr(x, 7), b.rotr(x, 18)), b.shr(x, 3))


def _sigma1(b, x):
    return b.xor(b.xor(b.rotr(x, 17), b.rotr(x, 19)), b.shr(x, 10))


def _Sigma0(b, x):
    return b.xor(b.xor(b.rotr(x, 2), b.rotr(x, 13)), b.rotr(x, 22))


def _Sigma1(b, x):
    return b.xor(b.xor(b.rotr(x, 6), b.rotr(x, 11)), b.rotr(x, 25))


def _ch(b, e, f, g):
    return b.xor(b.and_(e, f), b.and_(b.not32(e), g))


def _maj(b, x, y, z):
    return b.xor(b.xor(b.and_(x, y), b.and_(x, z)), b.and_(y, z))


def _compress(b: _Builder, state: list, block: list) -> list:
    w = list(block)
    for i in range(16, 64):
        w.append(b.add32(_sigma1(b, w[i - 2]), w[i - 7],
                         _sigma0(b, w[i - 15]), w[i - 16]))
    a, bb, c, d, e, f, g, h = state
    k_w = [b.new_witness(K[i]) for i in range(64)]
    for i, kw in enumerate(k_w):
        b.assert_linear([(1, kw)], F.P - K[i])
    for i in range(64):
        t1 = b.add32(h, _Sigma1(b, e), _ch(b, e, f, g), k_w[i], w[i])
        t2 = b.add32(_Sigma0(b, a), _maj(b, a, bb, c))
        a, bb, c, d, e, f, g, h = (
            b.add32(t1, t2), a, bb, c, b.add32(d, t1), e, f, g)
    return [b.add32(s, n) for s, n in zip(state, [a, bb, c, d, e, f, g, h])]


def _pad(message: bytes) -> bytes:
    ml = len(message) * 8
    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded)) % 64)
    return padded + ml.to_bytes(8, "big")


def sha256_bytes_gadget(b, byte_ws: list, msg_len: int) -> list:
    """sha256 over u8 byte witnesses (caller range-checks them).

    Static-length message (padding bytes are constants), returns the 32
    digest bytes as fresh range-checked u8 witnesses.  This is the
    composable form used by the passport circuits
    (``check_dg1_hash_within_sod``: passport_validity_check/src/lib.nr:100).
    """
    assert len(byte_ws) == msg_len
    msg_vals = bytes(b.val(w) for w in byte_ws)
    padded = _pad(msg_vals)

    words = []
    for i in range(0, len(padded), 4):
        terms, const = [], 0
        for j in range(4):
            idx = i + j
            shift = 8 * (3 - j)
            if idx < msg_len:
                terms.append((1 << shift, byte_ws[idx]))
            else:
                const += padded[idx] << shift
        words.append(b.linear(terms, const))

    state = [b.new_witness(h) for h in H0]
    for w, h in zip(state, H0):
        b.assert_linear([(1, w)], F.P - h)
    for blk in range(len(padded) // 64):
        state = _compress(b, state, words[blk * 16:(blk + 1) * 16])

    digest = b"".join(b.val(s).to_bytes(4, "big") for s in state)
    assert digest == hashlib.sha256(msg_vals).digest()

    out_bytes = []
    for s in state:
        v = b.val(s)
        byte_w = []
        for j in range(4):
            bw = b.new_witness((v >> (8 * (3 - j))) & 0xFF)
            b.range(bw, 8)
            byte_w.append(bw)
        b.assert_linear([(1 << (8 * (3 - j)), bw)
                         for j, bw in enumerate(byte_w)] + [(F.P - 1, s)])
        out_bytes.extend(byte_w)
    return out_bytes


def sha256_circuit(message: bytes):
    """Returns (acir.Program, witness values dict, digest bytes).

    The message words are private inputs (range-checked); padding words are
    constant-constrained; the 8 digest words are the circuit's return
    values.  Digest is validated against ``hashlib.sha256`` before
    returning.
    """
    b = _Builder()
    padded = _pad(message)
    n_msg_words = (len(message) + 3) // 4
    words = []
    for i in range(0, len(padded), 4):
        v = int.from_bytes(padded[i:i + 4], "big")
        w = b.u32_input(v)
        if i // 4 >= n_msg_words:  # padding: pin to its constant
            b.assert_linear([(1, w)], F.P - v if v else 0)
        words.append(w)

    state = [b.new_witness(h) for h in H0]
    for w, h in zip(state, H0):
        b.assert_linear([(1, w)], F.P - h)
    for blk in range(len(padded) // 64):
        state = _compress(b, state, words[blk * 16:(blk + 1) * 16])

    digest = b"".join(b.val(s).to_bytes(4, "big") for s in state)
    expect = hashlib.sha256(message).digest()
    assert digest == expect, "sha256 circuit digest mismatch vs hashlib"

    out = [b.linear([(1, s)]) for s in state]
    circuit = acir.Circuit(
        opcodes=b.opcodes,
        private_parameters=[w.index for w in words[:n_msg_words]],
        return_values=[o.index for o in out],
        current_witness_index=b.next_witness)
    return acir.Program(functions=[circuit]), dict(b.values), digest


def chain_circuit(n_blocks: int, seed: int = 1):
    """Benchmark workload: hash a 64·n_blocks-byte deterministic message."""
    msg = hashlib.sha256(b"provekit-tpu-sha-bench-%d" % seed).digest()
    msg = (msg * ((64 * n_blocks) // 32 + 1))[:64 * n_blocks - 9]
    return sha256_circuit(msg)
