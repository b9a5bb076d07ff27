"""Sumcheck compute: eq tables, folds, round sums, batched MLE evaluation.

Port of ``provekit_tpu/ops/sumcheck.py``.  Variable order (the reference's):
the FIRST challenge binds the most-significant index bit, so eq tables are
built MSB-first and Spartan rounds pair x[i] with x[i + n/2]; WHIR rounds
bind the least-significant bit and pair x[2i] with x[2i + 1].

Every function computes exact field values, so the sums may be taken in any
order: ``V.sum_mod`` adds the digit planes in int64 and reduces once.
"""

from __future__ import annotations

import torch

from ..fields import bn254 as F
from ..fields import vector as V


def _col(alpha: torch.Tensor, ndim: int) -> torch.Tensor:
    """(16,) or (16, 1) scalar -> (16, 1, ..., 1) broadcasting column."""
    return alpha.reshape((16,) + (1,) * (ndim - 1))


def eq_table(rs: list[int], device) -> torch.Tensor:
    """eq(r, x) over the boolean hypercube, (16, 2^m) Montgomery.

    Iterative doubling E <- [E*(1-r_k), E*r_k] over the coords in reverse,
    so rs[0] lands on the most-significant index bit."""
    r_m = V.pack([F.to_mont(r % F.P) for r in rs], device)
    return eq_table_m(r_m)


def eq_table_m(r_m: torch.Tensor) -> torch.Tensor:
    """eq table from (16, m) Montgomery coords on the device."""
    dev = r_m.device
    e = V.const(F.to_mont(1), dev)
    one = e
    for k in range(r_m.shape[1] - 1, -1, -1):
        rk = r_m[:, k:k + 1]
        e = torch.cat([V.mont_mul(e, V.sub_mod(one, rk)),
                       V.mont_mul(e, rk)], dim=1)
    return e


def eq_point(rs: list[int], alphas: list[int]) -> int:
    """eq(r, alpha) as a host scalar."""
    acc = 1
    for r, a in zip(rs, alphas):
        acc = acc * (r * a + (1 - r) * (1 - a)) % F.P
    return acc % F.P


def eval_cubic(coeffs: list[int], x: int) -> int:
    """Horner eval of a polynomial given coefficients [c0..] (host ints)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % F.P
    return acc


def weighted_sum(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Modular dot product <weights, values>: (16,n)x(16,n) -> (16,)."""
    return V.sum_mod(V.mont_mul(weights, values))


# --- stacked rounds: K polynomials per call ---------------------------------


def fold_stacked_msb(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(16, K, n) -> (16, K, n/2), binding the MSB variable of each."""
    n = x.shape[2]
    lo, hi = x[:, :, :n // 2], x[:, :, n // 2:]
    return V.add_mod(lo, V.mont_mul(_col(alpha, 3), V.sub_mod(hi, lo)))


def fold_stacked_lsb(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(16, K, n) -> (16, K, n/2), binding the LSB variable of each."""
    ev, od = x[:, :, 0::2], x[:, :, 1::2]
    return V.add_mod(ev, V.mont_mul(_col(alpha, 3), V.sub_mod(od, ev)))


def spartan_round_stacked(abce: torch.Tensor):
    """One Spartan round over F(x) = eq(x) * (a(x) b(x) - c(x)) on a stacked
    (16, 4, n) [a; b; c; eq] array.  Returns the three (16,) Montgomery sums
    the prover sends: F at X=0, at X=-1, and the X^3 coefficient."""
    h = abce.shape[2] // 2
    a0, b0, c0, e0 = (abce[:, k, :h] for k in range(4))
    a1, b1, c1, e1 = (abce[:, k, h:] for k in range(4))

    def dbl_sub(x0, x1):  # 2*x0 - x1  (evaluation at X=-1 along the line)
        return V.sub_mod(V.add_mod(x0, x0), x1)

    mm = V.mont_mul
    f0 = mm(e0, V.sub_mod(mm(a0, b0), c0))
    fm1 = mm(dbl_sub(e0, e1),
             V.sub_mod(mm(dbl_sub(a0, a1), dbl_sub(b0, b1)), dbl_sub(c0, c1)))
    finf = mm(V.sub_mod(e1, e0), mm(V.sub_mod(a1, a0), V.sub_mod(b1, b0)))
    return V.sum_mod(f0), V.sum_mod(fm1), V.sum_mod(finf)


def whir_round_split_dev(fw: torch.Tensor):
    """One WHIR round with the even/odd split done once.

    fw (16, 2, n) [f; w] -> (ev (16,2,n/2), d (16,2,n/2), h0, h1, h2): the
    quadratic's sums h(X) = sum_x f(x,X) w(x,X) as (16,) Montgomery
    coefficients, and the halves :func:`fold_from_split_dev` folds."""
    ev, od = fw[:, :, 0::2], fw[:, :, 1::2]
    d = V.sub_mod(od, ev)
    f0, w0 = ev[:, 0], ev[:, 1]
    df, dw = d[:, 0], d[:, 1]
    mm = V.mont_mul
    h0 = V.sum_mod(mm(f0, w0))
    h1 = V.sum_mod(V.add_mod(mm(f0, dw), mm(w0, df)))
    h2 = V.sum_mod(mm(df, dw))
    return ev, d, h0, h1, h2


def fold_from_split_dev(ev: torch.Tensor, d: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """(16,2,h) halves from whir_round_split_dev -> folded (16,2,h)."""
    return V.add_mod(ev, V.mont_mul(_col(alpha, 3), d))


def whir_round_stacked(fw: torch.Tensor):
    """The three WHIR round sums of a stacked (16, 2, n) [f; w] array."""
    _, _, h0, h1, h2 = whir_round_split_dev(fw)
    return h0, h1, h2


# --- batched eq combinations and MLE evaluations ----------------------------


def _eq_tables(coords_m: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(16, m, p) Montgomery coords, (16, p, 1) scale -> (16, p, 2^m)
    tables scale_p * eq(coords_p, .), same bit order as eq_table."""
    one = V.const_like(F.to_mont(1), coords_m)
    omrs = V.sub_mod(one, coords_m)
    e = scale
    for k in range(coords_m.shape[1] - 1, -1, -1):
        e = torch.cat([V.mont_mul(e, omrs[:, k, :, None]),
                       V.mont_mul(e, coords_m[:, k, :, None])], dim=2)
    return e


def combine_eq_weights_dev(coords_m: torch.Tensor, coeffs_m: torch.Tensor,
                           m: int) -> torch.Tensor:
    """sum_i coeffs[i] * eq(coords_i, .): coords (16, m, p), coeffs (16, p)
    Montgomery -> (16, 2^m) Montgomery table."""
    assert coords_m.shape[1] == m
    tables = _eq_tables(coords_m, coeffs_m[:, :, None])
    return V.sum_mod(tables, axis=1)


def eval_multilinear_batch_dev(evals: torch.Tensor,
                               coords_m: torch.Tensor) -> torch.Tensor:
    """MLE evaluations at device points: evals (16, 2^m), coords (16, m, p)
    Montgomery -> (16, p) Montgomery (MSB-first folds, all points at once)."""
    x = evals[:, None, :]
    for k in range(coords_m.shape[1]):
        h = x.shape[2] // 2
        lo, hi = x[:, :, :h], x[:, :, h:]
        x = V.add_mod(lo, V.mont_mul(coords_m[:, k, :, None],
                                     V.sub_mod(hi, lo)))
    return x[:, :, 0].expand(16, coords_m.shape[2])


def eval_multilinear_batch(evals: torch.Tensor,
                           coords_list: list[list[int]]) -> list[int]:
    """MLE evaluations at host points (MSB-first coords) -> host ints."""
    m = len(coords_list[0])
    flat = [F.to_mont(c[k] % F.P) for k in range(m) for c in coords_list]
    coords = V.pack(flat, evals.device).reshape(16, m, len(coords_list))
    vals = V.from_mont(eval_multilinear_batch_dev(evals, coords))
    return V.unpack(vals)


def eval_multilinear(evals: torch.Tensor, point: list[int]) -> int:
    """Evaluate an MLE given by hypercube evals at a point (MSB-first)."""
    return eval_multilinear_batch(evals, [point])[0]
