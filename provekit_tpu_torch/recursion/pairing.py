"""Optimal ate pairing on BN254.

Port of ``provekit_tpu/recursion/pairing.py``.

Construction: lift G2 points to E(Fq12) through the sextic twist
(x, y) -> (x' w^2, y' w^3) with the Fq2 coefficients re-expressed in the
u = w^6 - 9 basis, run the Miller loop over the ate loop count 6x+2 with
affine line functions in Fq12, apply the two Frobenius correction lines, and
finish with the (q^12-1)/r exponentiation.  Validated by bilinearity tests
(``tests/test_recursion.py``).  Replaces the gnark pairing backend used by
``recursive-verifier`` (a git dependency of the reference).
"""

from __future__ import annotations

from ..fields.bn254 import P as FR_ORDER
from .curve import G2 as G2_GROUP
from .fq import Fq12, Q, W2, W3

# BN parameter x and the ate loop count 6x+2
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288

_FINAL_EXP = (Q ** 12 - 1) // FR_ORDER


def twist(pt):
    """E'(Fq2) -> E(Fq12): coefficients to the w-basis, then (x w^2, y w^3)."""
    if pt is None:
        return None
    x, y = pt
    # c0 + c1*u with u = w^6 - 9  ->  (c0 - 9 c1) + c1 w^6
    nx = Fq12([(x[0] - 9 * x[1]) % Q] + [0] * 5 + [x[1]] + [0] * 5)
    ny = Fq12([(y[0] - 9 * y[1]) % Q] + [0] * 5 + [y[1]] + [0] * 5)
    return (nx * W2, ny * W3)


def cast_g1(pt):
    if pt is None:
        return None
    return (Fq12.from_fq(pt[0]), Fq12.from_fq(pt[1]))


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (doubling if equal) at point t.

    Points in E(Fq12) affine coords. Returns an Fq12 value whose zero set is
    the line; the standard Miller-loop accumulator factor.
    """
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) * (y1 * 2).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _add_fq12(p, q):
    """Affine add on E(Fq12) (b never needed: inputs are on the curve)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            m = (x1 * x1 * 3) * (y1 * 2).inv()
        else:
            return None
        lam = m
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _frobenius_g2_fq12(pt):
    """Frobenius endomorphism phi(x, y) = (x^q, y^q) on E(Fq12) points."""
    if pt is None:
        return None
    return (_fq12_frob(pt[0]), _fq12_frob(pt[1]))


# Precompute w^(i*q mod ...) action: (sum c_i w^i)^q = sum c_i (w^q)^i.
def _build_frob_tables():
    wq = Fq12((0, 1) + (0,) * 10).pow(Q)
    powers = [Fq12.one()]
    for _ in range(11):
        powers.append(powers[-1] * wq)
    return powers


_FROB_POWERS = _build_frob_tables()


def _fq12_frob(a: Fq12) -> Fq12:
    acc = Fq12.zero()
    for i, c in enumerate(a):
        if c:
            acc = acc + _FROB_POWERS[i] * c
    return acc


def miller_loop(q_pt, p_pt) -> Fq12:
    """Miller loop for e(P, Q): q_pt, p_pt are E(Fq12) affine points."""
    if q_pt is None or p_pt is None:
        return Fq12.one()
    r = q_pt
    f = Fq12.one()
    for bit in bin(ATE_LOOP_COUNT)[3:]:  # MSB-first, skip leading 1
        f = f * f * _line(r, r, p_pt)
        r = _add_fq12(r, r)
        if bit == "1":
            f = f * _line(r, q_pt, p_pt)
            r = _add_fq12(r, q_pt)
    q1 = _frobenius_g2_fq12(q_pt)
    nq2 = _frobenius_g2_fq12(q1)
    nq2 = (nq2[0], -nq2[1])
    f = f * _line(r, q1, p_pt)
    r = _add_fq12(r, q1)
    f = f * _line(r, nq2, p_pt)
    return f


def pairing(p, q, final_exp: bool = True) -> Fq12:
    """e(p, q) for p in G1(Fq), q in G2(Fq2)."""
    if p is None or q is None:
        return Fq12.one()
    assert G2_GROUP.is_on_curve(q), "q not on twist curve"
    f = miller_loop(twist(q), cast_g1(p))
    return f.pow(_FINAL_EXP) if final_exp else f


def pairing_product_is_one(pairs) -> bool:
    """prod e(p_i, q_i) == 1, with a single shared final exponentiation."""
    acc = Fq12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        acc = acc * miller_loop(twist(q), cast_g1(p))
    return acc.pow(_FINAL_EXP).is_one()
