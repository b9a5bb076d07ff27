"""BN254 elliptic-curve groups G1 (over Fq) and G2 (over Fq2).

Port of ``provekit_tpu/recursion/curve.py``.

Affine + Jacobian arithmetic on host Python ints; generic over the
coordinate field (Fq ints or Fq2 pairs).  Replaces the reference's
gnark-crypto curve layer (a git dependency of ``recursive-verifier``).
"""

from __future__ import annotations

from ..fields.bn254 import P as FR_ORDER  # group order r
from .fq import B2, FQ2_ONE, FQ2_ZERO, Fq2, Q, fq_inv


class _Group:
    """Short-Weierstrass curve y^2 = x^3 + b in affine coords; None = inf."""

    def __init__(self, b, fone, fzero, add, sub, mul, sqr, inv, neg, eq):
        self.b = b
        self.one_ = fone
        self.zero_ = fzero
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.fsqr, self.finv, self.fneg, self.feq = sqr, inv, neg, eq

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.fsqr(y)
        rhs = self.fadd(self.fmul(self.fsqr(x), x), self.b)
        return self.feq(lhs, rhs)

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if self.feq(x1, x2):
            if self.feq(y1, y2):
                return self.double(p)
            return None
        lam = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fsqr(lam), x1), x2)
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p):
        if p is None:
            return None
        x1, y1 = p
        if self.feq(y1, self.zero_):
            return None
        lam = self.fmul(self.fmul(self.fsqr(x1), 3),
                        self.finv(self.fmul(y1, 2)))
        x3 = self.fsub(self.fsqr(lam), self.fmul(x1, 2))
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.fneg(p[1]))

    def mul(self, p, k: int):
        k %= FR_ORDER
        acc = None
        add = p
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.double(add)
            k >>= 1
        return acc

    def msm(self, points, scalars):
        """Multi-scalar mul, 4-bit windowed Pippenger (host)."""
        W = 4
        nbits = FR_ORDER.bit_length()
        windows = (nbits + W - 1) // W
        result = None
        for wi in range(windows - 1, -1, -1):
            if result is not None:
                for _ in range(W):
                    result = self.double(result)
            buckets = [None] * (1 << W)
            shift = wi * W
            for pt, s in zip(points, scalars):
                d = (s >> shift) & ((1 << W) - 1)
                if d and pt is not None:
                    buckets[d] = self.add(buckets[d], pt)
            running = None
            acc = None
            for d in range((1 << W) - 1, 0, -1):
                running = self.add(running, buckets[d])
                acc = self.add(acc, running)
            result = self.add(result, acc)
        return result


def _int_ops():
    return dict(
        add=lambda a, b: (a + b) % Q, sub=lambda a, b: (a - b) % Q,
        mul=lambda a, b: a * b % Q, sqr=lambda a: a * a % Q,
        inv=fq_inv, neg=lambda a: (-a) % Q, eq=lambda a, b: a == b)


def _fq2_ops():
    return dict(
        add=lambda a, b: a + b, sub=lambda a, b: a - b,
        mul=lambda a, b: a * b, sqr=lambda a: a.sqr(),
        inv=lambda a: a.inv(), neg=lambda a: -a, eq=lambda a, b: a == b)


G1 = _Group(3, 1, 0, **_int_ops())
G2 = _Group(B2, FQ2_ONE, FQ2_ZERO, **_fq2_ops())


def g1_generator():
    return (1, 2)


def g2_generator():
    return (
        Fq2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634),
        Fq2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531),
    )
