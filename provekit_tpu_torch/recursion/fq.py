"""BN254 base-field towers for pairing: Fq, Fq2, Fq12 (+ Fq12 as poly ring).

Port of ``provekit_tpu/recursion/fq.py``.

The reference gets these from gnark/ark (git dependencies); this is a
from-scratch implementation.  Representation choices follow the classic
polynomial-ring construction: Fq2 = Fq[u]/(u^2+1) and Fq12 = Fq[w]/(w^12 -
18 w^6 + 82), the minimal polynomial of w with u = w^6 - 9 — one flat ring
instead of the 2-3-2 tower, trading constants for simplicity.  Host-side
Python ints (pairing runs once per verification; the proving hot path never
touches this module).
"""

from __future__ import annotations

# BN254 base field modulus (the coordinate field; Fr = scalar field lives in
# fields/bn254.py).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Fq12 modulus: w^12 - 18 w^6 + 82  (so (w^6 - 9)^2 = -1, i.e. u = w^6 - 9)
FQ12_MOD = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # low-degree first, deg 12 implied


def fq_inv(a: int) -> int:
    return pow(a, Q - 2, Q)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1), elements (c0, c1) = c0 + c1*u


class Fq2(tuple):
    __slots__ = ()

    def __new__(cls, c0: int, c1: int = 0):
        return super().__new__(cls, (c0 % Q, c1 % Q))

    def __getnewargs__(self):
        # pickle (the CLI's --keys cache) rebuilds through __new__; tuple's
        # own (self,) would hand it one tuple for c0
        return (self[0], self[1])

    @property
    def c0(self):
        return self[0]

    @property
    def c1(self):
        return self[1]

    def __add__(self, o):
        return Fq2(self[0] + o[0], self[1] + o[1])

    def __sub__(self, o):
        return Fq2(self[0] - o[0], self[1] - o[1])

    def __neg__(self):
        return Fq2(-self[0], -self[1])

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self[0] * o, self[1] * o)
        a0, a1 = self
        b0, b1 = o
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def sqr(self):
        a0, a1 = self
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def inv(self):
        a0, a1 = self
        d = fq_inv((a0 * a0 + a1 * a1) % Q)
        return Fq2(a0 * d, -a1 * d)

    def conj(self):
        return Fq2(self[0], -self[1])

    def is_zero(self):
        return self[0] == 0 and self[1] == 0

    @classmethod
    def one(cls):
        return cls(1, 0)

    @classmethod
    def zero(cls):
        return cls(0, 0)


FQ2_ONE = Fq2(1, 0)
FQ2_ZERO = Fq2(0, 0)

# Twist constant: E' : y^2 = x^3 + 3/(9+u) over Fq2
B1 = 3
B2 = Fq2(3, 0) * Fq2(9, 1).inv()


# ---------------------------------------------------------------------------
# Fq12 as Fq[w]/(w^12 - 18w^6 + 82); elements are 12-tuples of Fq, low first


class Fq12(tuple):
    __slots__ = ()

    def __new__(cls, coeffs):
        return super().__new__(cls, tuple(c % Q for c in coeffs))

    @classmethod
    def one(cls):
        return cls((1,) + (0,) * 11)

    @classmethod
    def zero(cls):
        return cls((0,) * 12)

    @classmethod
    def from_fq(cls, c: int):
        return cls((c,) + (0,) * 11)

    @classmethod
    def from_fq2(cls, x: Fq2):
        """Embed c0 + c1*u with u = w^6 - 9: (c0 - 9 c1) + c1 w^6."""
        c = [0] * 12
        c[0] = (x[0] - 9 * x[1]) % Q
        c[6] = x[1]
        return cls(c)

    def __add__(self, o):
        return Fq12(a + b for a, b in zip(self, o))

    def __sub__(self, o):
        return Fq12(a - b for a, b in zip(self, o))

    def __neg__(self):
        return Fq12(-a for a in self)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(a * o for a in self)
        # schoolbook 12x12 then reduce by w^12 = 18w^6 - 82
        t = [0] * 23
        for i, a in enumerate(self):
            if a:
                for j, b in enumerate(o):
                    t[i + j] += a * b
        for k in range(22, 11, -1):
            v = t[k]
            if v:
                t[k] = 0
                t[k - 6] += 18 * v
                t[k - 12] -= 82 * v
        return Fq12(t[:12])

    __rmul__ = __mul__

    def sqr(self):
        return self * self

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[w] against the ring modulus."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self) + [0]
        high = [c % Q for c in FQ12_MOD] + [1]
        while _deg(low):
            r = _poly_div(high, low)
            nm, new = list(hm), list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        d = fq_inv(low[0])
        return Fq12([c * d for c in lm[:12]])

    def is_one(self):
        return self[0] == 1 and all(c == 0 for c in self[1:])


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_div(a, b):
    """Division of polynomial a by b over Fq, returns quotient (len 13)."""
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * 13
    inv_lead = fq_inv(b[degb])
    for i in range(dega - degb, -1, -1):
        c = temp[degb + i] * inv_lead % Q
        out[i] = c
        if c:
            for j in range(degb + 1):
                temp[i + j] = (temp[i + j] - c * b[j]) % Q
    return out


# w and w^k as Fq12 constants
W = Fq12((0, 1) + (0,) * 10)
W2 = W * W
W3 = W2 * W
