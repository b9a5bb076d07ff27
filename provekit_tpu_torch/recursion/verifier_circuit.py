"""In-circuit WHIR + ZK-Spartan verifier (gnark Circuit equivalent).

This synthesizes the complete NoirProof verification — commitment parsing,
ZK-Spartan sumcheck, two WHIR opening verifications, deferred weight
evaluation including the R1CS matrix-extension evaluation, and the final
Spartan identity — as R1CS constraints over the in-tree
:class:`CircuitBuilder`, so the resulting system can be wrapped in Groth16
(recursion/groth16.py).

Port of ``provekit_tpu/recursion/verifier_circuit.py``; the counterpart
of the reference's Go/gnark circuit:
* ``Circuit::Define`` (recursive-verifier/app/circuit/circuit.go:43-82)
* ``RunZKWhir`` (app/circuit/whir.go:16-415)
* ``runZKSumcheck`` (app/circuit/utilities.go:167)
* Merkle path verification (app/circuit/mt.go:11-100)
* ``evaluateR1CSMatrixExtension`` (app/circuit/matrix_evaluation.go:41-79)

Control flow mirrors the host verifiers (whir/verifier.py,
protocol/spartan.py, protocol/scheme.py) line for line; every host
``raise`` becomes a constraint, every host challenge a sponge squeeze.
The circuit layout is static per scheme: query multiplicity is handled by
processing every drawn query (duplicates re-verified) instead of the host's
sorted-dedup, which is equivalent and keeps wire counts config-determined.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields import bn254 as F
from ..ops import pow as pow_mod
from ..whir.hints import (deserialize_multipath, deserialize_scalar_vec,
                          deserialize_stir_answers)
from ..whir.parameters import WhirConfig
from .builder import LC, ONE, CircuitBuilder
from .gadgets import TranscriptGadget, compress

P = F.P
INV2 = pow(2, P - 2, P)


# ---------------------------------------------------------------------------
# small arithmetic gadgets


def horner(b: CircuitBuilder, coeffs: list, x: LC) -> LC:
    """Evaluate sum(coeffs[i] x^i); len(coeffs)-1 multiplications."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = b.mul(acc, x) + c
    return acc


def pow2k(b: CircuitBuilder, x: LC, k: int) -> LC:
    """x^(2^k) by k squarings."""
    for _ in range(k):
        x = b.square(x)
    return x


def univariate_point(b: CircuitBuilder, z: LC, m: int) -> list:
    """univariate_to_multilinear_point (whir/statement.py:21-32): MSB-first
    coords [z^(2^(m-1)), ..., z^2, z]."""
    coords = [None] * m
    acc = z
    for k in range(m - 1, -1, -1):
        coords[k] = acc
        if k:
            acc = b.square(acc)
    return coords


def eq_term(b: CircuitBuilder, c: LC, x: LC) -> LC:
    """c*x + (1-c)(1-x) == 2cx - c - x + 1: one multiplication."""
    return b.mul(c, x).scale(2) - c - x + 1


def eq_point_gadget(b: CircuitBuilder, cs: list, xs: list) -> LC:
    assert len(cs) == len(xs)
    acc = ONE
    for c, x in zip(cs, xs):
        acc = b.mul(acc, eq_term(b, c, x))
    return acc


def eq_table_gadget(b: CircuitBuilder, rs: list) -> list:
    """eq(r, x) over the hypercube; rs[0] on the MSB index bit
    (ops/sumcheck.py::eq_table semantics).  2^m - 1 multiplications."""
    table = [ONE]
    for r in reversed(rs):
        hi = [b.mul(e, r) for e in table]
        lo = [e - h for e, h in zip(table, hi)]
        table = lo + hi
    return table


def root_power(b: CircuitBuilder, idx_bits: list, log_domain: int) -> LC:
    """omega^idx for the 2^log_domain domain from the index bits (LSB first).

    Constant powers omega^(2^i) make each select linear; only the running
    product multiplies: len(idx_bits) constraints.
    """
    omega = F.root_of_unity(log_domain)
    acc = ONE
    for i, bit in enumerate(idx_bits):
        w = pow(omega, 1 << i, P)
        term = bit.scale(w - 1) + 1  # select(bit, w, 1) — linear
        acc = b.mul(acc, term)
    return acc


# ---------------------------------------------------------------------------
# transcript-level gadgets


def pow_check(b: CircuitBuilder, tr: TranscriptGadget, bits: float) -> None:
    """In-circuit grinding check (whir/verifier.py::_check_pow): nonce < 2^64
    and compress(challenge, nonce) < threshold."""
    ch = tr.challenge_scalars(1)[0]
    [nonce] = tr.next_scalars(1)
    lk = getattr(b, "lookups", None)
    if lk is not None:
        lk.uint_limbs(nonce, 64)  # pins nonce < 2^64
        h = compress(b, ch, nonce)
        # h <= threshold-1 < p also pins the decomposition canonical
        limbs = lk.uint_limbs(h, 256)
        lk.assert_limbs_le_constant(limbs, pow_mod.threshold(bits) - 1)
        return
    b.to_bits(nonce, 64)  # recomposition over 64 bits pins nonce < 2^64
    h = compress(b, ch, nonce)
    hbits = b.to_bits(h, 254, assert_canonical=True)
    b.assert_bits_le_constant(hbits, pow_mod.threshold(bits) - 1)


def read_sumcheck_rounds(b: CircuitBuilder, tr: TranscriptGadget, claim: LC,
                         count: int, binders: list) -> LC:
    """whir/verifier.py::_read_sumcheck_rounds — EVALUATION basis
    [h(0), h(1), h(2)]: assert h(0)+h(1) == claim, then interpolate the
    quadratic at the drawn alpha (gnark utilities.go:148-170)."""
    half = F.HALF
    for _ in range(count):
        e0, e1, e2 = tr.next_scalars(3)
        b.assert_zero(e0 + e1 - claim)
        alpha = tr.challenge_scalars(1)[0]
        binders.append(alpha)
        # b1 = (4e1 - e2 - 3e0)/2, b2 = (e2 - 2e1 + e0)/2
        b1 = (e1.scale(4) - e2 - e0.scale(3)).scale(half)
        b2 = (e2 - e1.scale(2) + e0).scale(half)
        claim = horner(b, [e0, b1, b2], alpha)
    return claim


@dataclass
class CommitmentGadget:
    root: LC
    ood_points: list
    ood_answers: list  # [point][poly]
    batching_randomness: LC


def parse_commitment_gadget(b: CircuitBuilder, tr: TranscriptGadget,
                            config: WhirConfig) -> CommitmentGadget:
    """whir/verifier.py::parse_commitment over circuit variables."""
    [root] = tr.next_scalars(1)
    ood_points, ood_answers = [], []
    if config.commitment_ood_samples:
        ood_points = tr.challenge_scalars(config.commitment_ood_samples)
        flat = tr.next_scalars(config.commitment_ood_samples * config.batch_size)
        for i in range(config.commitment_ood_samples):
            ood_answers.append(
                flat[i * config.batch_size:(i + 1) * config.batch_size])
    gamma = ONE
    if config.batch_size > 1:
        gamma = tr.challenge_scalars(1)[0]
    return CommitmentGadget(root, ood_points, ood_answers, gamma)


def combined_ood_answers(b: CircuitBuilder, com: CommitmentGadget) -> list:
    out = []
    for answers in com.ood_answers:
        acc, g = LC(), ONE
        for i, a in enumerate(answers):
            acc = acc + (a if i == 0 else b.mul(g, a))
            if i + 1 < len(answers):
                g = b.mul(g, com.batching_randomness) if i else com.batching_randomness
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Merkle / folding gadgets


def merkle_verify_gadget(b: CircuitBuilder, root: LC, leaf_values: list,
                         idx_bits: list, path: list) -> None:
    """ops/merkle.py::verify_path: left-fold leaf hash, then climb by index
    bits selecting sibling order (gnark mt.go:11-100)."""
    h = leaf_values[0]
    for v in leaf_values[1:]:
        h = compress(b, h, v)
    for bit, sib in zip(idx_bits, path):
        l = b.select(bit, sib, h)
        r = (h + sib) - l  # the other of the pair — saves one select
        h = compress(b, l, r)
    b.assert_eq(h, root)


def rlc_leaf_gadget(b: CircuitBuilder, values: list, batch_size: int,
                    gamma: LC) -> list:
    """whir/fold.py::rlc_leaf: gamma-RLC collapse of a batched leaf."""
    fold_size = len(values) // batch_size
    gammas = [ONE, gamma]
    while len(gammas) < batch_size:
        gammas.append(b.mul(gammas[-1], gamma))
    out = []
    for t in range(fold_size):
        acc = values[t]
        for i in range(1, batch_size):
            acc = acc + b.mul(gammas[i], values[i * fold_size + t])
        out.append(acc)
    return out


def fold_leaf_gadget(b: CircuitBuilder, values: list, y: LC,
                     alphas: list) -> LC:
    """whir/fold.py::fold_opened_leaf: radix-2 coset folding of an opened
    leaf; inverses are witness-backed (1/ys constraint-checked)."""
    k = len(alphas)
    assert len(values) == 1 << k
    mu = F.root_of_unity(k)
    ys = [y.scale(pow(mu, t, P)) for t in range(1 << k)]
    cur = list(values)
    for alpha in alphas:
        half = len(cur) // 2
        nxt = []
        for t in range(half):
            s = cur[t] + cur[t + half]
            d = cur[t] - cur[t + half]
            inv_y = b.inverse(ys[t])
            nxt.append((s + b.mul(b.mul(alpha, d), inv_y)).scale(INV2))
        cur = nxt
        ys = [b.square(yt) for yt in ys[:half]]
    return cur[0]


# ---------------------------------------------------------------------------
# WHIR opening verification


@dataclass
class StatementGadget:
    """Statement over circuit values.  Each constraint carries its claimed
    sum and a weight evaluator ``eval_fn(b, point, eq_table) -> LC`` where
    ``eq_table`` is the memoized eq table over the full folding point
    (dense weights need it; evaluation weights ignore it)."""
    num_variables: int
    constraints: list = field(default_factory=list)

    def add(self, eval_fn, sigma: LC) -> None:
        self.constraints.append((eval_fn, sigma))


def dense_weights_eval(weight_lcs: list):
    """Evaluator for a dense weight vector given as LCs (tensor weights of
    the blinding statement, spartan.py::_blinding_statement)."""
    def ev(b: CircuitBuilder, point: list, eq_table: list) -> LC:
        acc = LC()
        for j, w in enumerate(weight_lcs):
            if isinstance(w, LC) and w.is_constant() and w.const == 0:
                continue
            acc = acc + b.mul(w, eq_table[j])
        return acc
    ev.needs_table = True
    return ev


def matrix_weights_eval(entries: list, eq_alpha: list, shared: dict, key: str):
    """Evaluator for eq_alpha^T M weights (scheme.py statement): the
    R1CS-matrix extension evaluation sum v * eq_alpha[row] * eq_pt[col]
    (gnark matrix_evaluation.go:41-79).  The eq_alpha[row]*eq_pt[col]
    products are shared across A/B/C through ``shared``."""
    def ev(b: CircuitBuilder, point: list, eq_table: list) -> LC:
        acc = LC()
        for row, col, val in entries:
            prod = shared.get((row, col))
            if prod is None:
                prod = b.mul(eq_alpha[row], eq_table[col])
                shared[(row, col)] = prod
            acc = acc + prod.scale(val)
        return acc
    ev.needs_table = True
    return ev


def whir_verify_gadget(b: CircuitBuilder, tr: TranscriptGadget,
                       config: WhirConfig, com: CommitmentGadget,
                       statement: StatementGadget) -> list:
    """whir/verifier.py::verify as constraints.  Returns the binders."""
    m = config.num_variables
    iff = config.initial_folding_factor

    chat = tr.challenge_scalars(1)[0]
    values = combined_ood_answers(b, com) + [s for _, s in statement.constraints]
    claim, g = LC(), ONE
    powers = []
    for i, v in enumerate(values):
        powers.append(g)
        claim = claim + (v if i == 0 else b.mul(g, v))
        if i + 1 < len(values):
            g = chat if i == 0 else b.mul(g, chat)
    deferred = []  # (coeff LC, eval closure, bound_before)
    for coeff, z in zip(powers, com.ood_points):
        coords = univariate_point(b, z, m)
        deferred.append((coeff, _eq_eval_closure(coords), 0))
    for coeff, (eval_fn, _) in zip(powers[len(com.ood_points):],
                                   statement.constraints):
        deferred.append((coeff, eval_fn, 0))

    binders: list = []
    claim = read_sumcheck_rounds(b, tr, claim, iff, binders)

    prev_root = com.root
    prev_log_domain = config.starting_log_domain
    prev_fold_size = 1 << iff
    prev_batch = config.batch_size
    prev_alphas = binders[-iff:] if iff else []

    for r, rc in enumerate(config.rounds):
        [root] = tr.next_scalars(1)
        m_cur = m - iff - rc.folding_factor * r
        bound_so_far = iff + rc.folding_factor * r

        round_points, round_values = [], []
        if rc.ood_samples:
            oods = tr.challenge_scalars(rc.ood_samples)
            answers = tr.next_scalars(rc.ood_samples)
            round_points.extend(oods)
            round_values.extend(answers)

        if rc.pow_bits > 0:
            pow_check(b, tr, rc.pow_bits)

        folded_domain = (1 << prev_log_domain) // prev_fold_size
        k = folded_domain.bit_length() - 1
        queries = tr.challenge_scalars(rc.num_queries)
        openings = _hinted_openings(b, tr, queries, k,
                                    prev_batch * prev_fold_size)
        for idx_bits, leaf_vals, path in openings:
            merkle_verify_gadget(b, prev_root, leaf_vals, idx_bits, path)
            vals = leaf_vals
            if prev_batch > 1:
                vals = rlc_leaf_gadget(b, vals, prev_batch,
                                       com.batching_randomness)
            y = root_power(b, idx_bits, prev_log_domain)
            fold_val = fold_leaf_gadget(b, vals, y, prev_alphas)
            round_points.append(pow2k(b, y, prev_fold_size.bit_length() - 1))
            round_values.append(fold_val)

        chat_r = tr.challenge_scalars(1)[0]
        gpow = ONE
        for i, (z, v) in enumerate(zip(round_points, round_values)):
            claim = claim + (v if i == 0 else b.mul(gpow, v))
            coords = univariate_point(b, z, m_cur)
            deferred.append((gpow, _eq_eval_closure(coords), bound_so_far))
            if i + 1 < len(round_points):
                gpow = chat_r if i == 0 else b.mul(gpow, chat_r)

        claim = read_sumcheck_rounds(b, tr, claim, rc.folding_factor, binders)
        prev_root = root
        prev_log_domain -= 1
        prev_fold_size = 1 << rc.folding_factor
        prev_batch = 1
        prev_alphas = binders[-rc.folding_factor:]

    # --- final phase -------------------------------------------------------
    v_final = config.final_sumcheck_rounds
    final_coeffs = tr.next_scalars(1 << v_final)

    if config.final_pow_bits > 0:
        pow_check(b, tr, config.final_pow_bits)

    folded_domain = (1 << prev_log_domain) // prev_fold_size
    k = folded_domain.bit_length() - 1
    queries = tr.challenge_scalars(config.final_queries)
    openings = _hinted_openings(b, tr, queries, k,
                                prev_batch * prev_fold_size)
    for idx_bits, leaf_vals, path in openings:
        merkle_verify_gadget(b, prev_root, leaf_vals, idx_bits, path)
        vals = leaf_vals
        if prev_batch > 1:
            vals = rlc_leaf_gadget(b, vals, prev_batch,
                                   com.batching_randomness)
        y = root_power(b, idx_bits, prev_log_domain)
        fold_val = fold_leaf_gadget(b, vals, y, prev_alphas)
        point = pow2k(b, y, prev_fold_size.bit_length() - 1)
        want = horner(b, final_coeffs, point)
        b.assert_eq(fold_val, want)

    pre_final = len(binders)
    claim = read_sumcheck_rounds(b, tr, claim, v_final, binders)
    final_binders = binders[pre_final:]

    if config.final_folding_pow_bits > 0:
        pow_check(b, tr, config.final_folding_pow_bits)

    # deferred_weight_evaluations hint: consumed for transcript alignment;
    # this circuit recomputes every weight eval itself (stronger than gnark,
    # which trusts the values into the final identity)
    dv = deserialize_scalar_vec(tr.hint_bytes())
    if len(dv) != len(statement.constraints):
        raise ValueError("deferred_weight_evaluations count mismatch")

    # final identity: claim == W(binders) * f_final(final_binders)
    full_point = list(reversed(binders))
    eq_table = None

    def table():
        nonlocal eq_table
        if eq_table is None:
            eq_table = eq_table_gadget(b, full_point)
        return eq_table

    w_eval = LC()
    for coeff, eval_fn, bound_before in deferred:
        point = list(reversed(binders[bound_before:]))
        tbl = table() if bound_before == 0 and eval_fn.needs_table else None
        w_eval = w_eval + b.mul(coeff, eval_fn(b, point, tbl))

    # f_final: multilinear-in-monomial-basis eval over final_binders
    fin_point = list(reversed(final_binders))
    f_final = LC()
    mono = _monomial_table(b, fin_point)
    for j, c in enumerate(final_coeffs):
        jj = _bit_reverse_msb(j, v_final)
        f_final = f_final + (c if jj == 0 else b.mul(c, mono[jj]))

    b.assert_eq(claim, b.mul(w_eval, f_final))
    return binders


def _monomial_table(b: CircuitBuilder, point: list) -> list:
    """Products prod_{k in S} point[k] for every subset mask S, where mask
    bit k selects point[k]."""
    table = [ONE]
    for x in point:
        hi = [x if t is ONE else b.mul(t, x) for t in table]
        table = table + hi
    return table


def _bit_reverse_msb(j: int, v: int) -> int:
    """Map coefficient index j to the monomial-table mask.

    Coefficient j multiplies prod_{k: bit (v-1-k) of j} fin_point[k]
    (whir/verifier.py:222-227).  The table from _monomial_table indexes
    point[k] at mask bit k (little-endian over the loop order), so the mask
    is j's MSB-first bits re-read LSB-first: a bit reversal.
    """
    mask = 0
    for k in range(v):
        if (j >> (v - 1 - k)) & 1:
            mask |= 1 << k
    return mask


def _eq_eval_closure(coords: list):
    def ev(b: CircuitBuilder, point: list, eq_table) -> LC:
        return eq_point_gadget(b, coords, point)
    ev.needs_table = False
    return ev


def _hinted_openings(b: CircuitBuilder, tr: TranscriptGadget, queries: list,
                     k: int, leaf_elems: int):
    """Allocate the Merkle openings for the drawn queries, sorted-dedup'd.

    Mirrors the host verifier exactly (whir/verifier.py::_stir_indices —
    ``indices = sorted({s % 2^k})``): ONE opening per unique index,
    returned in ascending index order so the caller's chat^i combination
    weights line up with the prover's rank-indexed powers
    (whir/prover.py::_stir_ranks).  Every query scalar is decomposed
    canonically; a duplicate draw is constrained index-equal to its
    representative and allocates no second opening.  The grouping/order is
    fixed at synthesis time from the concrete transcript, so the circuit
    shape is proof-dependent exactly like the reference's MultiPath-shaped
    gnark circuit (recursive-verifier/app/circuit/common.go:33-85).
    """
    h_leaves = deserialize_stir_answers(tr.hint_bytes())
    h_idx, sibs, topdown = deserialize_multipath(tr.hint_bytes())
    h_paths = [([s] if k else []) + list(reversed(td))
               for s, td in zip(sibs, topdown)]
    lookup = {i: (lv, pt) for i, lv, pt in zip(h_idx, h_leaves, h_paths)}

    def recompose(idx_bits):
        acc = LC()
        for i, bit in enumerate(idx_bits):
            acc = acc + bit.scale(1 << i)
        return acc

    lk = getattr(b, "lookups", None)
    groups: dict = {}  # concrete index -> [idx_bits per draw]
    for q in queries:
        if lk is not None:
            _, bits = lk.canonical_limbs(q, low_bits=max(1, k))
        else:
            bits = b.to_bits(q, 254, assert_canonical=True)
        idx_bits = bits[:k]
        idx_val = sum(b.value(bit) << i for i, bit in enumerate(idx_bits))
        groups.setdefault(idx_val, []).append(idx_bits)
    out = []
    for idx_val in sorted(groups):
        rep, *dups = groups[idx_val]
        rep_lc = recompose(rep)
        for d in dups:
            b.assert_zero(recompose(d) - rep_lc)
        leaf_vals, path = lookup.get(idx_val, ([0] * leaf_elems, [0] * k))
        leaf_lcs = [b.alloc(v) for v in leaf_vals]
        path_lcs = [b.alloc(v) for v in path]
        out.append((rep, leaf_lcs, path_lcs))
    return out
