"""Sumcheck rounds with the on-device Fiat-Shamir sponge, one at a time or
as a whole fused segment.

Port of ``provekit_tpu/ops/fused.py``.  A round's scalar step turns its
(16, 1) sums into the wire messages, absorbs them into the device sponge,
squeezes the round challenge and returns it in canonical and Montgomery
form; every step starts right after a squeeze (absorb_pos == 0), so the
absorb/squeeze pattern is static.

* :func:`whir_rounds` and :func:`spartan_rounds` run rounds one at a time:
  the round sums, the scalar step (one duplex launch) and the fold, each a
  few launches.  The provers run the leading rounds this way, those on
  arrays longer than :data:`FUSE_MAX` (:func:`lead_rounds`): none on the
  repository's circuits at the default.
* :func:`whir_sumcheck_segment` and :func:`spartan_sumcheck_fused` run all
  remaining rounds in one cooperative launch of
  ``csrc/sumcheck_segment.cu`` over the card on a CUDA tensor (counted in
  ``.launches``, their sponge permutations in ``.permutations``), or
  raise.  A CPU tensor takes the plain version beside
  each, :func:`whir_sumcheck_segment_plain` and
  :func:`spartan_sumcheck_fused_plain`: the per-round loop on CPU copies of
  the inputs (plain torch limb ops and ``S.duplex_plain`` there), its
  results moved back to the inputs' device.

All of them emit the same messages and challenges: every value is an exact
field element.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..fields import bn254 as F
from ..fields import vector as V
from ..hash import skyscraper as S
from . import sumcheck as sc


# Rounds on arrays longer than this run one at a time; the remaining rounds
# run as one segment launch over the whole card.  The default sets no limit
# of its own: 2^32 elements, whose 32 rounds are the most a Spartan segment
# takes (its scalars' room in shared memory), so every sumcheck is one
# launch.  0 runs every round one at a time (the plain per-round path).
FUSE_MAX = 1 << 32


def lead_rounds(n: int, count: int) -> int:
    """How many of ``count`` sumcheck rounds (WHIR or Spartan) on ``n``
    elements run one at a time: those on arrays longer than FUSE_MAX."""
    lead = 0
    while lead < count and (n >> lead) > FUSE_MAX:
        lead += 1
    return lead


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


def _stacked(cols: list, k: int, dev) -> tuple:
    """Per-round (16, k) messages and (16, 1) challenges -> (16, rounds, k),
    (16, rounds)."""
    if not cols:
        return V.zeros((0, k), dev), V.zeros((0,), dev)
    msgs, alphas = zip(*cols)
    return torch.stack(msgs, dim=1), torch.cat(alphas, dim=1)


def whir_rounds(fw: torch.Tensor, state: torch.Tensor, count: int):
    """``count`` WHIR rounds (LSB pairing) on fw (16, 2, n) [f; w]
    Montgomery, one at a time: round sums -> [messages + sponge advance]
    -> fold.  Returns (fw (16, 2, n >> count), state', messages
    (16, count, 3) canonical, alphas (16, count) canonical)."""
    cols = []
    for _ in range(count):
        ev, d, h0, h1, h2 = sc.whir_round_split_dev(fw)
        state, msgs_c, alpha_c, alpha_m = whir_scalar_step(
            state, h0.reshape(16, 1), h1.reshape(16, 1), h2.reshape(16, 1))
        cols.append((msgs_c, alpha_c))
        fw = sc.fold_from_split_dev(ev, d, alpha_m)
    return (fw, state, *_stacked(cols, 3, fw.device))


def spartan_rounds(abce: torch.Tensor, state: torch.Tensor, claim, prefix,
                   rho, g_coeffs, pms, sms, suffix, count: int):
    """``count`` ZK-Spartan rounds (MSB pairing) on abce (16, 4, n)
    [a; b; c; eq] Montgomery, one at a time; round i takes the blinding
    cubic ``g_coeffs[:, i]`` and the factors ``pms``, ``sms``, ``suffix``
    column i (see protocol.spartan).  Returns (abce (16, 4, n >> count),
    state', coefficients (16, count, 4) canonical, alphas (16, count)
    canonical, claim', prefix')."""
    cols = []
    for i in range(count):
        f0, fm1, finf = sc.spartan_round_stacked(abce)
        (state, cs_c, alpha_c, alpha_m, claim,
         prefix) = spartan_scalar_step(
            state, f0.reshape(16, 1), fm1.reshape(16, 1),
            finf.reshape(16, 1), claim, prefix, g_coeffs[:, i],
            pms[:, i:i + 1], sms[:, i:i + 1], suffix[:, i:i + 1], rho)
        cols.append((cs_c, alpha_c))
        abce = sc.fold_stacked_msb(abce, alpha_m)
    return (abce, state, *_stacked(cols, 4, abce.device), claim, prefix)


def whir_sumcheck_segment_plain(fw: torch.Tensor, state: torch.Tensor,
                                count: int):
    """:func:`whir_sumcheck_segment` in plain torch: :func:`whir_rounds` on
    CPU copies, the results on ``fw``'s device."""
    out = whir_rounds(fw.cpu(), state.cpu(), count)
    return tuple(t.to(fw.device) for t in out)


def spartan_sumcheck_fused_plain(abce, state, claim0, rho, g_coeffs, pms,
                                 sms, suffix, prefix0, m_0: int):
    """:func:`spartan_sumcheck_fused` in plain torch: :func:`spartan_rounds`
    on CPU copies, the results on ``abce``'s device."""
    cpu = [t.cpu() for t in (abce, state, claim0, prefix0, rho, g_coeffs,
                             pms, sms, suffix)]
    _, state2, coeffs, alphas, _, _ = spartan_rounds(*cpu, m_0)
    return tuple(t.to(abce.device) for t in (state2, coeffs, alphas))


_PK_WHIR_SEGMENT = K.Entry("pk_whir_segment")
_PK_SPARTAN_SEGMENT = K.Entry("pk_spartan_segment")


def _partials(dev) -> torch.Tensor:
    """The segment kernels' cross-block round sums: two slots of three
    8-limb values for each of the grid's most blocks (the kernels'
    ``seg::MAX_BLOCKS``)."""
    blocks = K.lib()["pk_segment_max_blocks"]()
    return torch.empty(2 * blocks * 3 * 8, dtype=V.I32, device=dev)


def _log2_rounds(name: str, x: torch.Tensor, polys: int, rounds: int) -> int:
    n = x.shape[2] if x.dim() == 3 else 0
    if x.dim() != 3 or x.shape[1] != polys or n & (n - 1) or n == 0:
        raise ValueError(f"{name}: expected (16, {polys}, 2^k) planes, got "
                         f"{tuple(x.shape)}")
    if not 0 <= rounds <= n.bit_length() - 1:
        raise ValueError(f"{name}: {rounds} rounds on {n} elements")
    return n


def whir_sumcheck_segment(fw: torch.Tensor, state: torch.Tensor, count: int):
    """``count`` WHIR rounds in one launch (the JAX package's
    ``whir_sumcheck_segment``): fw (16, 2, n) [f; w] Montgomery, state
    (16, 2) canonical.  Returns (fw (16, 2, n >> count) folded, state',
    messages (16, count, 3) canonical, alphas (16, count) canonical).

    A CPU operand takes :func:`whir_sumcheck_segment_plain`; a CUDA operand
    launches ``pk_whir_segment`` (counted in ``.launches``) or raises."""
    if fw.device.type == "cpu" and state.device.type == "cpu":
        return whir_sumcheck_segment_plain(fw, state, count)
    dev = K.check_cuda_int32("whir_segment", fw, state)
    n = _log2_rounds("whir_segment", fw, 2, count)
    if tuple(state.shape) != (16, 2):
        raise ValueError(f"whir_segment: state {tuple(state.shape)}")
    out = torch.empty((16, 2 + 4 * count), dtype=V.I32, device=dev)
    folded = torch.empty((16, 2, n >> count), dtype=V.I32, device=dev)
    scratch = torch.empty(16 * 2 * (n // 2 + n // 4) if count >= 2 else 0,
                          dtype=V.I32, device=dev)
    partials = _partials(dev)
    _PK_WHIR_SEGMENT(dev, fw.data_ptr(), *fw.stride(), state.data_ptr(),
                     *state.stride(), n, count, scratch.data_ptr(),
                     folded.data_ptr(), out.data_ptr(), out.stride(0),
                     partials.data_ptr())
    whir_sumcheck_segment.launches += 1
    whir_sumcheck_segment.permutations += 3 * count
    return (folded if count else fw, out[:, :2],
            out[:, 2:2 + 3 * count].view(16, count, 3), out[:, 2 + 3 * count:])


whir_sumcheck_segment.launches = 0
whir_sumcheck_segment.permutations = 0


def spartan_sumcheck_fused(abce: torch.Tensor, state: torch.Tensor,
                           claim0: torch.Tensor, rho: torch.Tensor,
                           g_coeffs: torch.Tensor, pms: torch.Tensor,
                           sms: torch.Tensor, suffix: torch.Tensor,
                           prefix0: torch.Tensor, m_0: int):
    """``m_0`` ZK-Spartan rounds in one launch (the JAX package's
    ``spartan_sumcheck_fused``): abce (16, 4, 2^m_0) [a; b; c; eq]
    Montgomery, state (16, 2) canonical, claim0, rho and prefix0 (16, 1),
    g_coeffs (16, m_0, 4), pms, sms and suffix (16, m_0), all Montgomery.
    Returns (state', coefficients (16, m_0, 4) canonical, alphas (16, m_0)
    canonical).

    A CPU operand takes :func:`spartan_sumcheck_fused_plain`; a CUDA
    operand launches ``pk_spartan_segment`` (counted in ``.launches``) or
    raises."""
    scalars = [state, claim0, rho, prefix0, pms, sms, suffix, g_coeffs]
    if abce.device.type == "cpu" and all(x.device.type == "cpu"
                                         for x in scalars):
        return spartan_sumcheck_fused_plain(abce, state, claim0, rho,
                                            g_coeffs, pms, sms, suffix,
                                            prefix0, m_0)
    dev = K.check_cuda_int32("spartan_segment", abce, *scalars)
    n = _log2_rounds("spartan_segment", abce, 4, m_0)
    shapes = [tuple(x.shape) for x in scalars]
    if shapes != [(16, 2), (16, 1), (16, 1), (16, 1), (16, m_0), (16, m_0),
                  (16, m_0), (16, m_0, 4)]:
        raise ValueError(f"spartan_segment: scalar shapes {shapes}")
    scal = torch.cat(scalars[:-1] + [g_coeffs.reshape(16, 4 * m_0)], dim=1)
    out = torch.empty((16, 2 + 5 * m_0), dtype=V.I32, device=dev)
    scratch = torch.empty(16 * 4 * (n // 2) if m_0 >= 2 else 0,
                          dtype=V.I32, device=dev)
    partials = _partials(dev)
    _PK_SPARTAN_SEGMENT(dev, abce.data_ptr(), *abce.stride(),
                        scal.data_ptr(), scal.stride(0), n, m_0,
                        scratch.data_ptr(), out.data_ptr(), out.stride(0),
                        partials.data_ptr())
    spartan_sumcheck_fused.launches += 1
    spartan_sumcheck_fused.permutations += 4 * m_0
    return (out[:, :2], out[:, 2:2 + 4 * m_0].view(16, m_0, 4),
            out[:, 2 + 4 * m_0:])


spartan_sumcheck_fused.launches = 0
spartan_sumcheck_fused.permutations = 0
