"""Per-round sumcheck scalar steps with the on-device Fiat-Shamir sponge.

Port of the per-round part of ``provekit_tpu/ops/fused.py``: each step
turns one round's (16, 1) sums into the wire messages, absorbs them into the
device sponge, squeezes the round challenge and returns it in canonical and
Montgomery form.  The port runs every round this way (the JAX package's
whole-segment fused kernels emit the same bytes); every step starts right
after a squeeze (absorb_pos == 0), so the absorb/squeeze pattern is static,
and a step's absorb and squeeze are one launch of the duplex kernel.
"""

from __future__ import annotations

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..hash import skyscraper as S


def _eval_poly_mont(coeffs: list, x: torch.Tensor) -> torch.Tensor:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = V.add_mod(V.mont_mul(acc, x), c)
    return acc


def whir_round_messages(h0, h1, h2):
    """Quadratic sums (Montgomery (16,1)) -> wire messages [h(0),h(1),h(2)]
    (the whir crate's sumcheck wire basis is evaluations)."""
    e1 = V.add_mod(V.add_mod(h0, h1), h2)
    e2 = V.add_mod(e1, V.add_mod(h1, V.add_mod(h2, V.add_mod(h2, h2))))
    return [h0, e1, e2]


def spartan_round_coeffs(f0, fm1, finf, claim, prefix, g, pm, sm, sfx,
                         rho, half_c):
    """ZK-combined cubic coefficients [cc0..cc3] for one Spartan round.

    All inputs (16, 1) Montgomery; ``g`` is the round's blinding cubic as a
    list of 4 (reference prover/src/whir_r1cs.rs:103-180)."""
    mm = V.mont_mul
    const_term = V.add_mod(mm(pm, prefix), mm(sm, sfx))
    gp0 = V.add_mod(mm(pm, g[0]), const_term)
    gp1, gp2, gp3 = (mm(pm, g[k]) for k in (1, 2, 3))

    cc0 = V.add_mod(f0, mm(rho, gp0))
    g_at_m1 = V.sub_mod(V.add_mod(gp0, gp2), V.add_mod(gp1, gp3))
    comb_m1 = V.add_mod(fm1, mm(rho, g_at_m1))
    three_c0 = V.add_mod(V.add_mod(cc0, cc0), cc0)
    cc2 = mm(half_c, V.sub_mod(V.add_mod(claim, comb_m1), three_c0))
    cc3 = V.add_mod(finf, mm(rho, gp3))
    cc1 = V.sub_mod(V.sub_mod(claim, V.add_mod(cc0, cc0)),
                    V.add_mod(cc3, cc2))
    return [cc0, cc1, cc2, cc3]


def whir_scalar_step(state: torch.Tensor, h0, h1, h2):
    """-> (state', msgs_canon (16,3), alpha_canon (16,1), alpha_mont)."""
    msgs = whir_round_messages(h0, h1, h2)
    msgs_c = torch.cat([V.from_mont(x) for x in msgs], dim=1)
    state, alpha_c = S.duplex_v(state, msgs_c, 0, 1)
    return state, msgs_c, alpha_c, V.to_mont(alpha_c)


def spartan_scalar_step(state: torch.Tensor, f0, fm1, finf, claim, prefix,
                        g4: torch.Tensor, pm, sm, sfx, rho):
    """One round's ZK combination + sponge advance; g4 is the round's
    blinding cubic as (16, 4).  Returns
    (state', cs_canon (16,4), alpha_canon, alpha_mont, claim', prefix')."""
    half_c = V.const(F.to_mont(F.HALF), state.device)
    g = [g4[:, k:k + 1] for k in range(4)]
    cs = spartan_round_coeffs(f0, fm1, finf, claim, prefix, g,
                              pm, sm, sfx, rho, half_c)
    cs_c = torch.cat([V.from_mont(c) for c in cs], dim=1)
    state, alpha_c = S.duplex_v(state, cs_c, 0, 1)
    alpha_m = V.to_mont(alpha_c)
    claim = _eval_poly_mont(cs, alpha_m)
    prefix = V.add_mod(prefix, _eval_poly_mont(g, alpha_m))
    return state, cs_c, alpha_c, alpha_m, claim, prefix
