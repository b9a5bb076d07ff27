"""M31 / CM31 arithmetic and NTT.

Port of ``provekit_tpu/fields/m31.py``: the Mersenne-31 field the reference
plans to migrate to (its ``playground/cm31_ntt`` prototypes CM31 radix-8
NTTs).  No prove calls this module; it is the port's copy of the JAX
package's playground, with the same values.

* M31: p = 2^31 - 1.  Elements are ``int64`` lanes in [0, p): a product of
  two fits 62 bits, and two Mersenne folds (2^31 = 1) reduce it.
* CM31: p^2 complex extension (a + ib); its multiplicative group has
  2-adicity 32, enabling power-of-two NTTs (M31* itself has 2-adicity 1).

The scalar (Python int) reference is copied unchanged; the vector ops and
the NTT are plain torch on any device (the JAX module has no Pallas kernel,
so there is no kernel to port).
"""

from __future__ import annotations

import functools

import torch

from ..ops.ntt import _bitrev_index

P31 = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Scalar reference


def m31_mul(a: int, b: int) -> int:
    return a * b % P31


def m31_add(a: int, b: int) -> int:
    return (a + b) % P31


def cm31_mul(a: tuple, b: tuple) -> tuple:
    (ar, ai), (br, bi) = a, b
    return ((ar * br - ai * bi) % P31, (ar * bi + ai * br) % P31)


def cm31_add(a: tuple, b: tuple) -> tuple:
    return ((a[0] + b[0]) % P31, (a[1] + b[1]) % P31)


def cm31_pow(a: tuple, e: int) -> tuple:
    acc = (1, 0)
    base = a
    while e:
        if e & 1:
            acc = cm31_mul(acc, base)
        base = cm31_mul(base, base)
        e >>= 1
    return acc


def cm31_inv(a: tuple) -> tuple:
    # norm = a * conj(a) = ar^2 + ai^2 in M31
    norm = (a[0] * a[0] + a[1] * a[1]) % P31
    ninv = pow(norm, P31 - 2, P31)
    return (a[0] * ninv % P31, (P31 - a[1]) * ninv % P31)


# |CM31*| = p^2 - 1 = 2^32 * 3 * 7^2 * 11 * 31 * 151 * 331
CM31_GROUP_ORDER = P31 * P31 - 1
CM31_TWO_ADICITY = 32
# A generator of CM31* (verified at import against the group factorization).
CM31_GENERATOR = (7, 2)
_ODD_FACTORS = [3, 7, 11, 31, 151, 331]


def cm31_root_of_unity(log_n: int) -> tuple:
    assert log_n <= CM31_TWO_ADICITY
    return cm31_pow(CM31_GENERATOR, CM31_GROUP_ORDER >> log_n)


def _selfcheck():
    assert CM31_GROUP_ORDER % (1 << 32) == 0
    n = CM31_GROUP_ORDER >> 32
    for q in _ODD_FACTORS:
        while n % q == 0:
            n //= q
    assert n == 1, n
    for q in [2] + _ODD_FACTORS:
        assert cm31_pow(CM31_GENERATOR, CM31_GROUP_ORDER // q) != (1, 0), q
    w = cm31_root_of_unity(4)
    assert cm31_pow(w, 16) == (1, 0) and cm31_pow(w, 8) != (1, 0)


_selfcheck()


# ---------------------------------------------------------------------------
# Vectorized (int64 lanes holding values in [0, p))


def vadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return torch.where(s >= P31, s - P31, s)


def vsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + P31, d)


def vmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M31 product: the 62-bit product folded twice at bit 31 (2^31 = 1),
    which leaves a value <= p, then one conditional subtract."""
    x = a * b
    x = (x & P31) + (x >> 31)          # < 2^32
    x = (x & P31) + (x >> 31)          # <= p
    return torch.where(x >= P31, x - P31, x)


def cvmul(ar, ai, br, bi):
    """CM31 product on int64 lane pairs."""
    rr = vsub(vmul(ar, br), vmul(ai, bi))
    ii = vadd(vmul(ar, bi), vmul(ai, br))
    return rr, ii


def cvadd(ar, ai, br, bi):
    return vadd(ar, br), vadd(ai, bi)


def cvsub(ar, ai, br, bi):
    return vsub(ar, br), vsub(ai, bi)


# ---------------------------------------------------------------------------
# CM31 NTT (radix-2 iterative, the JAX module's stage order)


@functools.lru_cache(maxsize=None)
def _cm31_stage_twiddles(log_n: int, inverse: bool):
    """Per stage s = 1..log_n, the (real, imaginary) host lanes of w_s^k,
    k < 2^(s-1)."""
    tables = []
    for s in range(1, log_n + 1):
        w = cm31_root_of_unity(s)
        if inverse:
            w = cm31_inv(w)
        half = 1 << (s - 1)
        tw = [(1, 0)] * half
        for k in range(1, half):
            tw[k] = cm31_mul(tw[k - 1], w)
        tables.append(tuple(torch.tensor([t[c] for t in tw],
                                         dtype=torch.int64)
                            for c in (0, 1)))
    return tuple(tables)


def _cm31_ntt_core(xr: torch.Tensor, xi: torch.Tensor, log_n: int,
                   inverse: bool):
    n = 1 << log_n
    dev = xr.device
    rev = _bitrev_index(log_n, dev)
    xr, xi = xr[rev], xi[rev]
    twiddles = _cm31_stage_twiddles(log_n, inverse)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        blocks = n >> s
        xr_ = xr.reshape(blocks, 2, half)
        xi_ = xi.reshape(blocks, 2, half)
        lo_r, lo_i = xr_[:, 0, :], xi_[:, 0, :]
        hi_r, hi_i = xr_[:, 1, :], xi_[:, 1, :]
        twr, twi = (t.to(dev) for t in twiddles[s - 1])
        tr, ti = cvmul(hi_r, hi_i, twr[None, :], twi[None, :])
        ar, ai = cvadd(lo_r, lo_i, tr, ti)
        br, bi = cvsub(lo_r, lo_i, tr, ti)
        xr = torch.stack([ar, br], dim=1).reshape(n)
        xi = torch.stack([ai, bi], dim=1).reshape(n)
    if inverse:
        n_inv = torch.full_like(xr, pow(n, P31 - 2, P31))
        xr, xi = vmul(xr, n_inv), vmul(xi, n_inv)
    return xr, xi


def cm31_ntt(xr: torch.Tensor, xi: torch.Tensor):
    """Forward CM31 NTT of (n,) int64 real and imaginary lanes, n = 2^k."""
    return _cm31_ntt_core(xr, xi, xr.shape[0].bit_length() - 1, False)


def cm31_intt(xr: torch.Tensor, xi: torch.Tensor):
    """Inverse of :func:`cm31_ntt`."""
    return _cm31_ntt_core(xr, xi, xr.shape[0].bit_length() - 1, True)
