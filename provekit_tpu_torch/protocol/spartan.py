"""ZK-Spartan sumcheck: reduce R1CS satisfaction to weighted witness openings.

Port of ``provekit_tpu/protocol/spartan.py`` (reference prover
``provekit/prover/src/whir_r1cs.rs:103-369`` and verifier
``provekit/verifier/src/whir_r1cs.rs:110-172``):

* Prove sum over the hypercube of F(x) = eq(r,x) * (Az(x) Bz(x) - Cz(x)) is 0,
  blinded by a random polynomial G = sum of per-round cubics, combined with a
  challenge rho: the sumcheck target is rho * sum(G).
* The blinding polynomial is itself committed (masked, batch 2) and opened via
  a second WHIR instance with tensor-of-powers weights proving
  sum_i g_i(alpha_i).

The ZK masks are the JAX package's stream exactly: ``jax.random.bits`` of a
threefry-2x32 key (``jax_threefry_partitionable`` layout), reproduced here
in torch int64 (``threefry2x32``, ``random_bits``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..fs import device as D
from ..ops import fused
from ..ops import sumcheck as sc
from ..whir import (DenseWeights, Statement, WhirConfig, committer, prover,
                    verifier)
from ..whir.verifier import WhirError

HALF = F.HALF


def eval_cubic(coeffs, x):
    return sc.eval_cubic(coeffs, x)


def blinding_coefficients_for_round(g_cubics, idx, alphas):
    """Round polynomial of G = sum_i g_i(X_i) partial-bound at alphas
    (reference compute_blinding_coefficients_for_round)."""
    n = len(g_cubics)
    all_fixed = idx == n
    if all_fixed:
        idx = n - 1
    prefix_sum = 0
    for i in range(idx):
        prefix_sum += eval_cubic(g_cubics[i], alphas[i])
    suffix_sum = 0
    for g in g_cubics[idx + 1:]:
        suffix_sum += eval_cubic(g, 0) + eval_cubic(g, 1)
    prefix_multiplier = pow(2, n - 1 - idx, F.P)
    suffix_multiplier = prefix_multiplier * HALF % F.P
    const_term = (prefix_multiplier * prefix_sum
                  + suffix_multiplier * suffix_sum) % F.P
    g = g_cubics[idx]
    coeffs = [(prefix_multiplier * g[0] + const_term) % F.P,
              prefix_multiplier * g[1] % F.P,
              prefix_multiplier * g[2] % F.P,
              prefix_multiplier * g[3] % F.P]
    if all_fixed:
        return [eval_cubic(coeffs, alphas[idx]), 0, 0, 0]
    return coeffs


def sum_over_hypercube(g_cubics):
    c = blinding_coefficients_for_round(g_cubics, 0, [])
    return (eval_cubic(c, 0) + eval_cubic(c, 1)) % F.P


def expand_powers(values):
    """[1, a, a^2, a^3] per alpha (prover/src/whir_r1cs.rs:371-380)."""
    out = []
    for v in values:
        out.extend([1, v, v * v % F.P, v * v * v % F.P])
    return out


# --- the mask stream: threefry-2x32 as jax.random computes it ---------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x, d: int):
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on Python ints or int64 tensors holding
    32-bit values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, rot) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def key_from_256_bits(bits: int) -> tuple[int, int]:
    """jax.random.PRNGKey(low 32 bits) followed by seven fold_in calls over
    the remaining 32-bit words (the JAX package's _key_from_256_bits)."""
    key = (0, bits & _M32)
    for i in range(1, 8):
        word = (bits >> (32 * i)) & _M32
        # fold_in(key, d) = threefry2x32(key, [0, d]) as one (2,) count
        key = threefry2x32(key[0], key[1], 0, word)
    return key


def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32) with jax_threefry_partitionable:
    element i hashes the 64-bit count i; the draw is the xor of the two
    output words.  Returned as int64 values in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= d
    counts = torch.arange(n, dtype=torch.int64, device=device)
    hi = counts >> 32
    lo = counts & _M32
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _reduce_512(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """x = hi*2^256 + lo (16-digit planes each) -> x mod P:
    mont_mul(hi, R^2) + reduce_256(lo) (bias 2^-258)."""
    return V.add_mod(V.reduce_256(lo),
                     V.mont_mul(hi, V.const(F.R2, lo.device)))


def random_mont_dev(n: int, device, rng) -> torch.Tensor:
    """(16, n) uniform field elements (Montgomery form) on the device.

    256 bits of ``rng`` key a threefry stream of 512 bits per element,
    reduced mod P.  Uniform canonical is uniform in Montgomery form too."""
    words = random_bits(key_from_256_bits(rng.getrandbits(256)), (16, n),
                        device)
    lo = (words & 0xFFFF).to(V.I32)
    hi = (words >> 16).to(V.I32)
    return _reduce_512(lo, hi)


def batch_commit_to_polynomial(m, whir_config, poly_mont, transcript, rng):
    """Commit [poly || mask] and a fresh random polynomial as a batch of two
    (reference batch_commit_to_polynomial).  ``poly_mont`` is a
    (16, 2^(m-1)) Montgomery device tensor."""
    nv = poly_mont.shape[1].bit_length() - 1
    assert poly_mont.shape[1] == 1 << nv and m == nv + 1
    dev = poly_mont.device
    mask = random_mont_dev(1 << nv, dev, rng)
    masked_arr = torch.cat([poly_mont, mask], dim=1)
    rand_arr = random_mont_dev(1 << m, dev, rng)
    return committer.commit(transcript, whir_config, [masked_arr, rand_arr])


def add_zk_sumcheck_pattern(ds, m_0: int) -> None:
    """add_zk_sumcheck_polynomials (common/src/utils/sumcheck.rs:123-129)."""
    ds.absorb(1, "Sum of G over boolean hypercube")
    ds.squeeze(1, "Rho")
    for _ in range(m_0):
        ds.absorb(4, "Sumcheck Polynomials").squeeze(1, "Sumcheck Random")
    ds.absorb(2, "Polynomial sums")


@dataclass
class SpartanProverOutput:
    r: object        # (16, m_0) Montgomery device scalars
    alpha: object    # (16, m_0) Montgomery device scalars


def _blinding_statement_dev(m_commit, alphas_m, com):
    """Statement over the blinding commitment: per alpha [1, a, a^2, a^3]."""
    m_0 = alphas_m.shape[1]
    a2 = D.mul(alphas_m, alphas_m)
    a3 = D.mul(a2, alphas_m)
    w = torch.stack([D.one_m(alphas_m.device, m_0), alphas_m, a2, a3],
                    dim=2).reshape(16, 4 * m_0)
    w = torch.nn.functional.pad(w, (0, (1 << m_commit) - w.shape[1]))
    weights = DenseWeights(w, m_commit)
    f_sum = sc.weighted_sum(w, com.polys[0]).reshape(16, 1)
    g_sum = sc.weighted_sum(w, com.polys[1]).reshape(16, 1)
    stmt = Statement(m_commit)
    sigma = V.add_mod(f_sum, V.mont_mul(com.batching_randomness, g_sum))
    stmt.add_constraint(weights, sigma)
    return stmt, f_sum, g_sum


def run_zk_sumcheck_prover(r1cs, z, transcript, m_0: int,
                           blinding_config: WhirConfig, rng):
    """Port of ``run_zk_sumcheck_prover`` (prover/src/whir_r1cs.rs:228-369);
    the rounds run as the reference's hybrid (``_spartan_rounds``)."""
    dev = z.device
    r_c = transcript.challenge_scalars_dev(m_0)     # (16, m_0) canonical
    r_m = D.to_mont(r_c)
    a, b, c = r1cs.witness_bounds(z)
    n = 1 << m_0
    pad = (0, n - a.shape[1])
    a, b, c = (torch.nn.functional.pad(x, pad) for x in (a, b, c))
    eq = D.eq_table_dev(r_m, m_0)

    g_cubics = [[rng.randrange(F.P) for _ in range(4)] for _ in range(m_0)]

    flat = [x for g in g_cubics for x in g]
    nv = max(1, (len(flat) - 1).bit_length())
    flat = flat + [0] * ((1 << nv) - len(flat))
    m_commit = nv + 1
    assert blinding_config.num_variables == m_commit, \
        (blinding_config.num_variables, m_commit)
    com = batch_commit_to_polynomial(
        m_commit, blinding_config, V.to_mont(V.pack(flat, dev)), transcript,
        rng)

    sum_g = sum_over_hypercube(g_cubics)
    transcript.add_scalars([sum_g])
    rho_m = D.to_mont(transcript.challenge_scalars_dev(1))
    claim0 = D.mul(rho_m, D.const_m(sum_g, dev))

    abce = torch.stack([a, b, c, eq], dim=1)

    pms = [pow(2, m_0 - 1 - i, F.P) for i in range(m_0)]
    sms = [p * F.HALF % F.P for p in pms]
    sfx = []
    for i in range(m_0):
        s = 0
        for g in g_cubics[i + 1:]:
            s += eval_cubic(g, 0) + eval_cubic(g, 1)
        sfx.append(s % F.P)
    g_arr = V.pack([F.to_mont(x) for g in g_cubics for x in g], dev
                   ).reshape(16, m_0, 4)
    pms_a = V.pack([F.to_mont(p) for p in pms], dev)
    sms_a = V.pack([F.to_mont(s) for s in sms], dev)
    sfx_a = V.pack([F.to_mont(s) for s in sfx], dev)
    assert transcript.absorb_pos == 0

    alphas_c = _spartan_rounds(transcript, abce, claim0, V.zeros((1,), dev),
                               rho_m, g_arr, pms_a, sms_a, sfx_a)
    alphas_m = D.to_mont(alphas_c)

    stmt, f_sum, g_sum = _blinding_statement_dev(m_commit, alphas_m, com)
    transcript.add_scalars_dev(D.from_mont(torch.cat([f_sum, g_sum], dim=1)))
    prover.prove(transcript, blinding_config, com, stmt)
    return SpartanProverOutput(r=r_m, alpha=alphas_m)


def _spartan_rounds(transcript, abce, claim, prefix, rho_m, g_arr,
                    pms_a, sms_a, sfx_a):
    """All ZK-Spartan rounds, the reference's hybrid
    (``provekit_tpu/protocol/spartan.py:245-275``): rounds on arrays longer
    than ``fused.FUSE_MAX`` one at a time, carrying the claim and the
    blinding prefix into one fused segment for the rest.  Returns the
    alphas (16, m_0) canonical."""
    m_0 = g_arr.shape[1]
    lead = fused.lead_rounds(abce.shape[2], m_0)
    alphas = []
    if lead:
        abce, state2, cs, a, claim, prefix = fused.spartan_rounds(
            abce, transcript.state, claim, prefix, rho_m, g_arr, pms_a,
            sms_a, sfx_a, lead)
        transcript.replay_fused(state2, list(cs.unbind(1)),
                                [("A", 4), ("S", 1)] * lead)
        alphas.append(a)
    if lead < m_0:
        tail = m_0 - lead
        state2, cs, a = fused.spartan_sumcheck_fused(
            abce, transcript.state, claim, rho_m, g_arr[:, lead:],
            pms_a[:, lead:], sms_a[:, lead:], sfx_a[:, lead:], prefix, tail)
        transcript.replay_fused(state2, list(cs.unbind(1)),
                                [("A", 4), ("S", 1)] * tail)
        alphas.append(a)
    return torch.cat(alphas, dim=1)


@dataclass
class SpartanVerifierOutput:
    r: list[int]
    alpha: list[int]
    last_sumcheck_val: int


def run_zk_sumcheck_verifier(transcript, m_0: int,
                             blinding_config: WhirConfig, device):
    """Port of ``run_sumcheck_verifier`` (verifier/src/whir_r1cs.rs:110-172),
    completing the blinding-weight evaluation the reference defers."""
    r = transcript.challenge_scalars(m_0)
    com = verifier.parse_commitment(transcript, blinding_config)
    [sum_g] = transcript.next_scalars(1)
    rho = transcript.challenge_scalars(1)[0]
    claim = rho * sum_g % F.P
    alphas = []
    for _ in range(m_0):
        coeffs = transcript.next_scalars(4)
        if (2 * coeffs[0] + coeffs[1] + coeffs[2] + coeffs[3]) % F.P != claim:
            raise WhirError("Spartan sumcheck equality assertion failed")
        alpha_i = transcript.challenge_scalars(1)[0]
        alphas.append(alpha_i)
        claim = eval_cubic(coeffs, alpha_i)

    f_sum, g_sum = transcript.next_scalars(2)
    m_commit = blinding_config.num_variables
    w_vals = expand_powers(alphas)
    w_vals = w_vals + [0] * ((1 << m_commit) - len(w_vals))
    stmt = Statement(m_commit)
    stmt.add_constraint(DenseWeights.from_ints(w_vals, m_commit, device),
                        (f_sum + com.batching_randomness * g_sum) % F.P)
    verifier.verify(transcript, blinding_config, com, stmt)

    last = (claim - rho * f_sum) % F.P
    return SpartanVerifierOutput(r=r, alpha=alphas, last_sumcheck_val=last)
