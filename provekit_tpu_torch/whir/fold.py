"""Host-side leaf folding: recover f^(next)(y^2^k) from 2^k opened values.

The verifier-side half of WHIR folding (gnark ``computeFold``,
recursive-verifier/app/circuit/mtUtilities.go): a leaf holds
{f(y*mu^t)} for the coset of y; successive radix-2 steps
  f'(z^2) = (f(z) + f(-z))/2 + alpha * (f(z) - f(-z))/(2z)
bind the same variables the sumcheck bound, so the folded value equals the
next oracle's evaluation at y^(2^k).
"""

from __future__ import annotations

from ..fields import bn254 as F

INV2 = pow(2, F.P - 2, F.P)


def fold_opened_leaf(values: list[int], y: int, alphas: list[int]) -> int:
    """values[t] = f(y * mu^t), len(values) = 2^len(alphas), mu of that order."""
    k = len(alphas)
    assert len(values) == 1 << k
    mu = F.root_of_unity(k)
    ys = [y * pow(mu, t, F.P) % F.P for t in range(1 << k)]
    cur = list(values)
    for alpha in alphas:
        half = len(cur) // 2
        nxt = []
        for t in range(half):
            s = (cur[t] + cur[t + half]) % F.P
            d = (cur[t] - cur[t + half]) % F.P
            inv_y = pow(ys[t], F.P - 2, F.P)
            nxt.append((s + alpha * d % F.P * inv_y) % F.P * INV2 % F.P)
        cur = nxt
        ys = [yt * yt % F.P for yt in ys[:half]]
    return cur[0]


def rlc_leaf(values: list[int], batch_size: int, gamma: int) -> list[int]:
    """Collapse a batched leaf [poly0 vals | poly1 vals | ...] by gamma-RLC."""
    fold_size = len(values) // batch_size
    out = []
    for t in range(fold_size):
        acc, g = 0, 1
        for i in range(batch_size):
            acc = (acc + g * values[i * fold_size + t]) % F.P
            g = g * gamma % F.P
        out.append(acc)
    return out
