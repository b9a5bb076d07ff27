"""P-256 (secp256r1) ECDSA-verify circuits: non-native field arithmetic.

Port of ``provekit_tpu/circuits/p256.py``: the same programs and witnesses.

Counterpart of ``noir-examples/p256_std`` / ``p256_bigcurve`` (ECDSA
signature verification via ``std::ecdsa_secp256r1::verify_signature`` —
``noir-examples/p256_std/src/main.nr:1-9``): the workload class BASELINE
calls "non-native field arithmetic, big MSM-like matvecs".  This module
builds the ACIR circuit programmatically (like ``circuits.poseidon``)
together with the full witness assignment.

Non-native arithmetic design (bignum-style, 3 x 120-bit limbs over BN254-Fr):

* An emulated element of a 256-bit field m is limbs (l0, l1, l2), range
  checked to (120, 120, 17) bits — values are kept *loosely reduced*
  (< 2^257), which is sound for every intermediate identity and
  canonicalized only where a unique representative is compared.
* ``mul mod m``: witness q, r with a*b = q*m + r over Z, proven by
  (1) three base-2^120 column identities with offset-encoded carry
  witnesses (each column magnitude < 2^243 < Fr, so mod-Fr zero is
  integer zero), and (2) the same identity evaluated mod Fr — by CRT
  (|a*b - q*m - r| < 2^515 < 2^360 * Fr) the two checks force equality
  over Z.
* Linear combinations reduce the same way with small quotients.
* Range checks use the compiler's digital-decomposition + 8-bit LogUp
  lowering (``compiler/range_check.py``), so every 120-bit limb costs 15
  looked-up digits — the constraint profile that makes this family
  "bitwise/lookup heavy" like the reference's.

Curve arithmetic: affine incomplete formulas with witnessed slopes
(lambda * dx = dy checked by a mul gadget).  Scalar multiplication is a
Shamir double ladder over the joint bits of (u1, u2) with an auxiliary
offset point K (and a final subtraction of 2^256 * K) so the accumulator
never passes through infinity; exceptional add cases (P == +-Q) occur with
negligible probability for honestly generated witnesses, as in standard
bignum-based in-circuit ECDSA.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..acir import model as acir
from ..fields import bn254 as F
from .sha256 import _Builder as _Sha256Builder

# --- P-256 parameters -------------------------------------------------------

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_A = P256_P - 3
P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
P256_GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
P256_GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

LB = 120                 # limb bits
B = 1 << LB              # limb base
LIMB_BITS = (120, 120, 17)


def limbs_of(v: int) -> tuple[int, int, int]:
    return (v & (B - 1), (v >> LB) & (B - 1), v >> (2 * LB))


# --- host-side curve arithmetic (witness generation) -------------------------


def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % P256_P == 0:
            return None
        lam = (3 * x1 * x1 + P256_A) * pow(2 * y1, -1, P256_P) % P256_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P256_P) % P256_P
    x3 = (lam * lam - x1 - x2) % P256_P
    return (x3, (lam * (x1 - x3) - y1) % P256_P)


def ec_double(p):
    return ec_add(p, p)


def ec_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = ec_add(acc, p)
        p = ec_double(p)
        k >>= 1
    return acc


def ec_neg(p):
    return None if p is None else (p[0], (P256_P - p[1]) % P256_P)


def _aux_point():
    """A deterministic curve point unrelated to G (x = smallest valid >= 5)."""
    x = 5
    while True:
        rhs = (x * x * x + P256_A * x + P256_B) % P256_P
        y = pow(rhs, (P256_P + 1) // 4, P256_P)  # p = 3 mod 4
        if y * y % P256_P == rhs:
            return (x, y)
        x += 1


K_POINT = _aux_point()


def ecdsa_sign(h: int, d: int, k: int):
    """Reference ECDSA signature (for test/bench witness generation)."""
    R = ec_mul(k, (P256_GX, P256_GY))
    r = R[0] % P256_N
    s = pow(k, -1, P256_N) * (h + r * d) % P256_N
    assert r and s
    return r, s


# --- circuit builder ---------------------------------------------------------


class Builder(_Sha256Builder):
    """ACIR builder with value tracking; extends the sha256 u32 builder with
    general AssertZero expressions and the bignum witness helpers (shared
    base so the passport circuits can compose sha256 + bignum gadgets)."""

    def assert_expr(self, mul_terms=(), linear=(), const: int = 0) -> None:
        self.opcodes.append(acir.AssertZero(acir.Expression(
            mul_terms=[(c % F.P, a, b) for c, a, b in mul_terms],
            linear_combinations=[(c % F.P, w) for c, w in linear],
            q_c=const % F.P)))

    def range_check(self, w: acir.Witness, bits: int) -> None:
        self.opcodes.append(acir.BlackBoxRange(
            acir.FunctionInput(value=w, num_bits=bits)))

    def ranged_witness(self, value: int, bits: int) -> acir.Witness:
        assert 0 <= value < (1 << bits), (value, bits)
        w = self.new_witness(value)
        self.range_check(w, bits)
        return w

    def const_witness(self, value: int) -> acir.Witness:
        w = self.new_witness(value)
        self.assert_expr(linear=[(1, w)], const=-value)
        return w

    def bit_witness(self, value: int) -> acir.Witness:
        w = self.new_witness(value)
        self.assert_expr(mul_terms=[(1, w, w)], linear=[(-1, w)])
        return w


@dataclass(frozen=True)
class NN:
    """Non-native element: three limb witnesses (values via the builder)."""
    limbs: tuple  # (w0, w1, w2)


class NNContext:
    """Emulated-field gadgets over modulus ``m`` on a shared Builder."""

    def __init__(self, b: Builder, m: int):
        assert m.bit_length() == 256
        self.b = b
        self.m = m
        self.ml = limbs_of(m)

    # -- element creation ----------------------------------------------------

    def value(self, x: NN) -> int:
        ls = [self.b.val(w) for w in x.limbs]
        return ls[0] + (ls[1] << LB) + (ls[2] << (2 * LB))

    def witness(self, v: int) -> NN:
        ls = limbs_of(v)
        return NN(tuple(self.b.ranged_witness(ls[i], LIMB_BITS[i])
                        for i in range(3)))

    def constant(self, v: int) -> NN:
        ls = limbs_of(v)
        return NN(tuple(self.b.const_witness(ls[i]) for i in range(3)))

    # -- multiplication -------------------------------------------------------

    def mul(self, a: NN, b2: NN, out: NN | None = None) -> NN:
        """r = a * b mod m (loosely reduced).  If ``out`` is given, instead
        *assert* a * b ≡ out (mod m) — used for division/inverse gadgets."""
        bld, m = self.b, self.m
        av, bv = self.value(a), self.value(b2)
        prod = av * bv
        if out is None:
            r_val = prod % m
            q_val = prod // m
            r = self.witness(r_val)
        else:
            r = out
            r_val = self.value(out)
            diff = prod - r_val
            assert diff % m == 0, "mul_assert: inconsistent witness"
            q_val = diff // m
        assert 0 <= q_val < (1 << 258)
        ql = limbs_of(q_val)
        q = NN((bld.ranged_witness(ql[0], 120),
                bld.ranged_witness(ql[1], 120),
                bld.ranged_witness(ql[2], 18)))

        al, bl, rl, qlw = a.limbs, b2.limbs, r.limbs, q.limbs
        ml = self.ml

        def ival(w):
            return bld.val(w)

        # columns d_k = sum_{i+j=k} a_i b_j - sum q_i m_j - r_k over Z
        d = [0, 0, 0]
        for k in range(3):
            s = 0
            for i in range(k + 1):
                s += ival(al[i]) * ival(bl[k - i])
                s -= ival(qlw[i]) * ml[k - i]
            d[k] = s - ival(rl[k])
        # carries: d0 = v0*B ; d1 + v0 = v1*B ; d2 + v1 = v2*B
        v0, rem = divmod(d[0], B)
        assert rem == 0
        v1, rem = divmod(d[1] + v0, B)
        assert rem == 0
        v2, rem = divmod(d[2] + v1, B)
        assert rem == 0
        OFS = (1 << 121, 1 << 123, 1 << 123)
        vbits = (122, 124, 124)
        vw = [bld.ranged_witness(v + o, bits)
              for v, o, bits in zip((v0, v1, v2), OFS, vbits)]

        # column 0: a0*b0 - m0*q0 - r0 - B*(v0' - OFS0) == 0
        bld.assert_expr(
            mul_terms=[(1, al[0], bl[0])],
            linear=[(-ml[0], qlw[0]), (-1, rl[0]), (-B, vw[0])],
            const=B * OFS[0])
        # column 1: a0*b1 + a1*b0 - m1*q0 - m0*q1 - r1 + (v0'-OFS0)
        #           - B*(v1'-OFS1) == 0
        bld.assert_expr(
            mul_terms=[(1, al[0], bl[1]), (1, al[1], bl[0])],
            linear=[(-ml[1], qlw[0]), (-ml[0], qlw[1]), (-1, rl[1]),
                    (1, vw[0]), (-B, vw[1])],
            const=-OFS[0] + B * OFS[1])
        # column 2
        bld.assert_expr(
            mul_terms=[(1, al[0], bl[2]), (1, al[1], bl[1]),
                       (1, al[2], bl[0])],
            linear=[(-ml[2], qlw[0]), (-ml[1], qlw[1]), (-ml[0], qlw[2]),
                    (-1, rl[2]), (1, vw[1]), (-B, vw[2])],
            const=-OFS[1] + B * OFS[2])

        # native (mod Fr) identity via recomposed products
        A = bld.new_witness(av % F.P)
        bld.assert_expr(linear=[(1, al[0]), (B, al[1]), (B * B, al[2]),
                                (-1, A)])
        Bw = bld.new_witness(bv % F.P)
        bld.assert_expr(linear=[(1, bl[0]), (B, bl[1]), (B * B, bl[2]),
                                (-1, Bw)])
        lin = [(-m * pow(B, i, F.P), qlw[i]) for i in range(3)]
        lin += [(-pow(B, i, F.P), rl[i]) for i in range(3)]
        bld.assert_expr(mul_terms=[(1, A, Bw)], linear=lin)
        return r

    def sqr(self, a: NN) -> NN:
        return self.mul(a, a)

    def assert_nonzero(self, a: NN) -> None:
        """Prove a ≢ 0 (mod m) by witnessing its inverse: a * a^-1 == 1.

        Soundness gadget: an adversarial witness cannot satisfy this for
        a ≡ 0 since no inverse exists.  One mul-gadget of cost."""
        inv = self.witness(pow(self.value(a) % self.m, -1, self.m))
        self.mul(a, inv, out=self.constant(1))

    # -- linear reduction ------------------------------------------------------

    def linear(self, terms: list[tuple[int, NN]], const: int = 0) -> NN:
        """out = (sum c_i * x_i + const) mod m with small integer c_i.

        Shifts negatives positive with an S*m offset, witnesses the small
        quotient k and two offset carries, and proves the limb identity
        sum c_i x_i + const + S*m = out + k*m over Z (columns < 2^135 < Fr).
        """
        bld, m = self.b, self.m
        S = sum(max(0, -c) for c, _ in terms) + (1 if const < 0 else 0)
        total = sum(c * self.value(x) for c, x in terms) + const + S * m
        assert total >= 0
        out_val = total % m
        k_val = total // m
        assert k_val < (1 << 10)
        out = self.witness(out_val)
        kw = bld.ranged_witness(k_val, 10)

        ml, ol = self.ml, out.limbs
        cl = limbs_of((const + S * m) % (1 << 384)) if const + S * m >= 0 \
            else None
        assert cl is not None
        d = [0, 0, 0]
        for j in range(3):
            s = cl[j] - bld.val(ol[j]) - k_val * ml[j]
            for c, x in terms:
                s += c * bld.val(x.limbs[j])
            d[j] = s
        v0, rem = divmod(d[0], B)
        assert rem == 0
        v1, rem = divmod(d[1] + v0, B)
        assert rem == 0
        assert d[2] + v1 == 0
        OFS = 1 << 14
        v0w = bld.ranged_witness(v0 + OFS, 15)
        v1w = bld.ranged_witness(v1 + OFS, 15)

        def col(j, extra_lin, extra_const):
            lin = [(c, x.limbs[j]) for c, x in terms]
            lin += [(-1, ol[j]), (-ml[j], kw)] + extra_lin
            bld.assert_expr(linear=lin, const=cl[j] + extra_const)

        col(0, [(-B, v0w)], B * OFS)
        col(1, [(1, v0w), (-B, v1w)], -OFS + B * OFS)
        col(2, [(1, v1w)], -OFS)
        return out

    def add(self, a: NN, b2: NN) -> NN:
        return self.linear([(1, a), (1, b2)])

    def sub(self, a: NN, b2: NN) -> NN:
        return self.linear([(1, a), (-1, b2)])

    # -- comparisons / canonical form -----------------------------------------

    def canonicalize(self, a: NN) -> NN:
        """Unique representative: r = a mod m with r < m proven.

        a < 2^257 so a = k*m + r with k in {0..3}; r < m via the witness
        t = m - 1 - r >= 0 (exact limb identity, t range-checked)."""
        bld, m = self.b, self.m
        av = self.value(a)
        k_val, r_val = divmod(av, m)
        assert k_val < 4
        r = self.witness(r_val)
        kw = bld.ranged_witness(k_val, 2)
        self._assert_eq_plus_km(a, r, kw, k_val)
        # r < m: t = (m-1) - r, limb-exact with borrow witnesses
        t_val = m - 1 - r_val
        t = self.witness(t_val)
        ml1 = limbs_of(m - 1)
        # r + t = m - 1 over Z: columns r_j + t_j - (m-1)_j with carries
        d0 = bld.val(r.limbs[0]) + bld.val(t.limbs[0]) - ml1[0]
        c0, rem = divmod(d0, B)
        assert rem == 0 and c0 in (0, 1)
        c0w = bld.bit_witness(c0)
        d1 = bld.val(r.limbs[1]) + bld.val(t.limbs[1]) + c0 - ml1[1]
        c1, rem = divmod(d1, B)
        assert rem == 0 and c1 in (0, 1)
        c1w = bld.bit_witness(c1)
        bld.assert_expr(linear=[(1, r.limbs[0]), (1, t.limbs[0]),
                                (-B, c0w)], const=-ml1[0])
        bld.assert_expr(linear=[(1, r.limbs[1]), (1, t.limbs[1]), (1, c0w),
                                (-B, c1w)], const=-ml1[1])
        bld.assert_expr(linear=[(1, r.limbs[2]), (1, t.limbs[2]), (1, c1w)],
                        const=-ml1[2])
        return r

    def _assert_eq_plus_km(self, a: NN, r: NN, kw, k_val: int) -> None:
        """a = k*m + r over Z (a, r limb-ranged; k a small ranged witness)."""
        bld, ml = self.b, self.ml
        d0 = self.b.val(a.limbs[0]) - k_val * ml[0] - bld.val(r.limbs[0])
        v0, rem = divmod(d0, B)
        assert rem == 0
        d1 = bld.val(a.limbs[1]) - k_val * ml[1] - bld.val(r.limbs[1]) + v0
        v1, rem = divmod(d1, B)
        assert rem == 0
        assert bld.val(a.limbs[2]) - k_val * ml[2] - bld.val(r.limbs[2]) \
            + v1 == 0
        OFS = 1 << 4
        v0w = bld.ranged_witness(v0 + OFS, 5)
        v1w = bld.ranged_witness(v1 + OFS, 5)
        bld.assert_expr(linear=[(1, a.limbs[0]), (-ml[0], kw),
                                (-1, r.limbs[0]), (-B, v0w)], const=B * OFS)
        bld.assert_expr(linear=[(1, a.limbs[1]), (-ml[1], kw),
                                (-1, r.limbs[1]), (1, v0w), (-B, v1w)],
                        const=-OFS + B * OFS)
        bld.assert_expr(linear=[(1, a.limbs[2]), (-ml[2], kw),
                                (-1, r.limbs[2]), (1, v1w)], const=-OFS)

    def assert_canonical_eq_mod(self, a_canon: NN, b_canon: NN,
                                other_m: int) -> None:
        """a ≡ b (mod other_m) for a < m, b < other_m: a = b + k*other_m,
        k in {0,1} (valid when m < 2*other_m — true for p vs n on P-256)."""
        bld = self.b
        av = self.value(a_canon)
        bv = self.value(b_canon)
        k_val = (av - bv) // other_m
        assert av - bv - k_val * other_m == 0 and k_val in (0, 1)
        kw = bld.bit_witness(k_val)
        oml = limbs_of(other_m)
        v0, rem = divmod(self.b.val(a_canon.limbs[0])
                         - self.b.val(b_canon.limbs[0]) - k_val * oml[0], B)
        assert rem == 0
        d1 = (self.b.val(a_canon.limbs[1])
              - self.b.val(b_canon.limbs[1]) - k_val * oml[1] + v0)
        v1, rem = divmod(d1, B)
        assert rem == 0
        OFS = 1 << 4
        v0w = bld.ranged_witness(v0 + OFS, 5)
        v1w = bld.ranged_witness(v1 + OFS, 5)
        bld.assert_expr(linear=[(1, a_canon.limbs[0]), (-1, b_canon.limbs[0]),
                                (-oml[0], kw), (-B, v0w)], const=B * OFS)
        bld.assert_expr(linear=[(1, a_canon.limbs[1]), (-1, b_canon.limbs[1]),
                                (-oml[1], kw), (1, v0w), (-B, v1w)],
                        const=-OFS + B * OFS)
        bld.assert_expr(linear=[(1, a_canon.limbs[2]), (-1, b_canon.limbs[2]),
                                (-oml[2], kw), (1, v1w)], const=-OFS)

    # -- selects / bits --------------------------------------------------------

    def select(self, bit, a: NN, b2: NN) -> NN:
        """bit ? a : b — per-limb product select (no new range checks)."""
        bld = self.b
        bv = bld.val(bit)
        out_ls = []
        for j in range(3):
            av, b2v = bld.val(a.limbs[j]), bld.val(b2.limbs[j])
            o = bld.new_witness(av if bv else b2v)
            bld.assert_expr(
                mul_terms=[(1, bit, a.limbs[j]), (-1, bit, b2.limbs[j])],
                linear=[(1, b2.limbs[j]), (-1, o)])
            out_ls.append(o)
        return NN(tuple(out_ls))

    def decompose_bits(self, a: NN, nbits: int = 256) -> list:
        """LSB-first boolean decomposition tied to the limbs of ``a``.

        Forces a < 2^nbits with canonical bits (the per-limb recomposition
        is exact — no carries can hide values)."""
        bld = self.b
        av = self.value(a)
        assert av < (1 << nbits)
        bits = [bld.bit_witness((av >> i) & 1) for i in range(nbits)]
        for j in range(3):
            lo = j * LB
            hi = min(nbits, (j + 1) * LB)
            lin = [(1 << (i - lo), bits[i]) for i in range(lo, hi)]
            lin.append((-1, a.limbs[j]))
            bld.assert_expr(linear=lin)
        return bits


# --- curve gadgets -----------------------------------------------------------


@dataclass(frozen=True)
class ECPoint:
    x: NN
    y: NN


class CurveGadget:
    def __init__(self, fp: NNContext):
        self.fp = fp

    def point_value(self, p: ECPoint):
        return (self.fp.value(p.x) % P256_P, self.fp.value(p.y) % P256_P)

    def witness_point(self, pv) -> ECPoint:
        return ECPoint(self.fp.witness(pv[0]), self.fp.witness(pv[1]))

    def constant_point(self, pv) -> ECPoint:
        return ECPoint(self.fp.constant(pv[0]), self.fp.constant(pv[1]))

    def assert_on_curve(self, p: ECPoint) -> None:
        """y^2 ≡ x^3 + a*x + b (mod p)."""
        fp = self.fp
        x2 = fp.sqr(p.x)
        x3 = fp.mul(x2, p.x)
        rhs = fp.linear([(1, x3), (-3, p.x)], P256_B)
        y2v = fp.value(p.y) ** 2 % P256_P
        rhsv = fp.value(rhs) % P256_P
        assert y2v == rhsv, "point not on curve"
        fp.mul(p.y, p.y, out=rhs)

    def add(self, p1: ECPoint, p2: ECPoint) -> ECPoint:
        """Incomplete affine addition; dx != 0 is *constrained*, not assumed.

        Without the dx-invertibility constraint an adversarial prover could
        arrange acc == addend (e.g. Q = 2*K_POINT passes assert_on_curve),
        leaving lambda unconstrained and the accumulator forgeable."""
        fp = self.fp
        v1, v2 = self.point_value(p1), self.point_value(p2)
        s = ec_add(v1, v2)
        lam_v = ((v2[1] - v1[1]) * pow(v2[0] - v1[0], -1, P256_P)) % P256_P
        lam = fp.witness(lam_v)
        dx = fp.sub(p2.x, p1.x)
        dy = fp.sub(p2.y, p1.y)
        fp.assert_nonzero(dx)                        # soundness: x1 != x2
        fp.mul(lam, dx, out=dy)                      # lam * dx == dy
        l2 = fp.sqr(lam)
        x3 = fp.linear([(1, l2), (-1, p1.x), (-1, p2.x)])
        t = fp.sub(p1.x, x3)
        u = fp.mul(lam, t)
        y3 = fp.sub(u, p1.y)
        assert (fp.value(x3) % P256_P, fp.value(y3) % P256_P) == s
        return ECPoint(x3, y3)

    def double(self, p: ECPoint) -> ECPoint:
        fp = self.fp
        v = self.point_value(p)
        s = ec_double(v)
        lam_v = (3 * v[0] * v[0] + P256_A) * pow(2 * v[1], -1, P256_P) % P256_P
        lam = fp.witness(lam_v)
        x2 = fp.sqr(p.x)
        num = fp.linear([(3, x2)], P256_A)           # 3x^2 + a
        den = fp.linear([(2, p.y)])                  # 2y
        fp.assert_nonzero(den)                       # soundness: y != 0
        fp.mul(lam, den, out=num)                    # lam * 2y == 3x^2 + a
        l2 = fp.sqr(lam)
        x3 = fp.linear([(1, l2), (-2, p.x)])
        t = fp.sub(p.x, x3)
        u = fp.mul(lam, t)
        y3 = fp.sub(u, p.y)
        assert (fp.value(x3) % P256_P, fp.value(y3) % P256_P) == s
        return ECPoint(x3, y3)

    def select(self, bit, a: ECPoint, b: ECPoint) -> ECPoint:
        return ECPoint(self.fp.select(bit, a.x, b.x),
                       self.fp.select(bit, a.y, b.y))


# --- circuit families --------------------------------------------------------


def scalar_mul_circuit(k: int, nbits: int = 8):
    """k*G via a double-and-add ladder with a K-offset accumulator.

    Returns (acir.Program, acir_values, expected_point).  ``nbits`` bounds
    the ladder length (tests use small nbits; ECDSA uses 256)."""
    assert 0 < k < (1 << nbits)
    b = Builder()
    fp = NNContext(b, P256_P)
    fn = NNContext(b, P256_N)
    curve = CurveGadget(fp)

    k_nn = fn.witness(k)
    n_inputs = b.next_witness
    bits = fn.decompose_bits(k_nn, nbits)

    g = curve.constant_point((P256_GX, P256_GY))
    acc_v = K_POINT
    acc = curve.constant_point(acc_v)
    for i in range(nbits - 1, -1, -1):
        acc = curve.double(acc)
        added = curve.add(acc, g)
        acc = curve.select(bits[i], added, acc)
    # subtract 2^nbits * K
    k_off = ec_neg(ec_mul(1 << nbits, K_POINT))
    acc = curve.add(acc, curve.constant_point(k_off))
    expected = ec_mul(k, (P256_GX, P256_GY))
    assert curve.point_value(acc) == expected

    circuit = acir.Circuit(
        opcodes=b.opcodes,
        private_parameters=list(range(n_inputs)),
        return_values=[],
        current_witness_index=b.next_witness)
    return acir.Program(functions=[circuit]), dict(b.values), expected


def ecdsa_verify_gadget(b: Builder, q_pt: ECPoint, r_nn: NN, s_nn: NN,
                        h_nn: NN, fp: NNContext, fn: NNContext,
                        nbits: int = 256) -> None:
    """In-circuit ECDSA verification over pre-built witnesses.

    Verifies (r, s) over Q for message hash h (all loosely-reduced NN
    elements on a shared builder — composable, used by the passport
    circuits where h comes from an in-circuit sha256 digest):
      w = s^-1 mod n; u1 = h*w; u2 = r*w; R = u1*G + u2*Q; R.x ≡ r (mod n).
    u1*G + u2*Q runs as one Shamir double ladder over the joint bits."""
    curve = CurveGadget(fp)
    curve.assert_on_curve(q_pt)
    s = fn.value(s_nn) % P256_N

    one = fn.constant(1)
    w_val = pow(s, -1, P256_N)
    w_nn = fn.witness(w_val)
    fn.mul(s_nn, w_nn, out=one)                      # s*w ≡ 1 (mod n)
    u1 = fn.mul(h_nn, w_nn)
    u2 = fn.mul(r_nn, w_nn)
    u1c = fn.canonicalize(u1)
    u2c = fn.canonicalize(u2)
    bits1 = fn.decompose_bits(u1c, nbits)
    bits2 = fn.decompose_bits(u2c, nbits)

    g_pt = curve.constant_point((P256_GX, P256_GY))
    t_pt = curve.add(g_pt, q_pt)                     # G + Q
    acc = curve.constant_point(K_POINT)
    for i in range(nbits - 1, -1, -1):
        acc = curve.double(acc)
        sel_hi = curve.select(bits2[i], t_pt, g_pt)  # b2 ? (b1? T : Q) ...
        sel_lo = curve.select(bits2[i], q_pt, g_pt)  # dummy G when (0,0)
        addend = curve.select(bits1[i], sel_hi, sel_lo)
        added = curve.add(acc, addend)
        b1v, b2v = b.val(bits1[i]), b.val(bits2[i])
        any_w = b.new_witness(b1v | b2v)             # b1 + b2 - b1*b2
        b.assert_expr(mul_terms=[(1, bits1[i], bits2[i])],
                      linear=[(-1, bits1[i]), (-1, bits2[i]), (1, any_w)])
        acc = curve.select(any_w, added, acc)
    k_off = ec_neg(ec_mul(1 << nbits, K_POINT))
    acc = curve.add(acc, curve.constant_point(k_off))

    # R.x mod n == r, with r != 0 (spec requires 1 <= r <= n-1; s != 0 is
    # already implied by the s*w == 1 constraint above)
    rx_canon = fp.canonicalize(acc.x)
    r_canon = fn.canonicalize(r_nn)
    fn.assert_nonzero(r_canon)
    fp.assert_canonical_eq_mod(rx_canon, r_canon, P256_N)


def ecdsa_verify_circuit(pub, r: int, s: int, h: int, nbits: int = 256):
    """Full standalone ECDSA verification circuit (the p256_std workload).

    Witnesses (pub, r, s, h) as private inputs and runs
    ``ecdsa_verify_gadget``.  Returns (acir.Program, acir_values)."""
    b = Builder()
    fp = NNContext(b, P256_P)
    fn = NNContext(b, P256_N)

    q_pt = ECPoint(fp.witness(pub[0]), fp.witness(pub[1]))
    r_nn = fn.witness(r)
    s_nn = fn.witness(s)
    h_nn = fn.witness(h)
    n_inputs = b.next_witness

    ecdsa_verify_gadget(b, q_pt, r_nn, s_nn, h_nn, fp, fn, nbits=nbits)

    circuit = acir.Circuit(
        opcodes=b.opcodes,
        private_parameters=list(range(n_inputs)),
        return_values=[],
        current_witness_index=b.next_witness)
    return acir.Program(functions=[circuit]), dict(b.values)


def ecdsa_test_vector(seed: int = 1, nbits: int = 256):
    """Deterministic (pub, r, s, h) test vector with nbits-bounded scalars."""
    import hashlib
    d = int.from_bytes(hashlib.sha256(b"p256-key-%d" % seed).digest(),
                       "big") % P256_N
    h = int.from_bytes(hashlib.sha256(b"p256-msg-%d" % seed).digest(),
                       "big") % P256_N
    k = int.from_bytes(hashlib.sha256(b"p256-nonce-%d" % seed).digest(),
                       "big") % P256_N
    pub = ec_mul(d, (P256_GX, P256_GY))
    r, s = ecdsa_sign(h, d, k)
    if nbits < 256:
        # shrink the ladder for test runs: instead of a real signature,
        # fabricate (r, s, h) with small u1, u2 (still exercises every gadget)
        u1 = (seed * 3 + 1) % (1 << nbits)
        u2 = (seed * 5 + 2) % (1 << nbits)
        R = ec_add(ec_mul(u1, (P256_GX, P256_GY)), ec_mul(u2, pub))
        r = R[0] % P256_N
        # need u2 = r/s and u1 = h/s: pick s = r * u2^-1, h = u1 * s
        s = r * pow(u2, -1, P256_N) % P256_N
        h = u1 * s % P256_N
    return pub, r, s, h
