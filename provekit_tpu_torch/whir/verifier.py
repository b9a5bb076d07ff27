"""WHIR opening verifier: transcript replay, Merkle/fold checks, final identity.

Replaces ``whir::whir::verifier::Verifier::verify`` (reference
verifier/src/whir_r1cs.rs:175-188).  Unlike the reference's native verifier
(which defers the linear-statement weight evaluation with zero weights,
verifier/src/whir_r1cs.rs:92-107 — a known gap), this verifier completes the
final identity itself by evaluating every accumulated weight at the folding
point; dense statement weights may supply a sparse fast path via
``Weights.eval_mle``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import bn254 as F
from ..ops import merkle
from ..ops import pow as pow_mod
from .fold import fold_opened_leaf, rlc_leaf
from .hints import (deserialize_multipath, deserialize_scalar_vec,
                    deserialize_stir_answers)
from .parameters import WhirConfig
from .statement import Statement, univariate_to_multilinear_point


class WhirError(Exception):
    pass


@dataclass
class ParsedCommitment:
    root: int
    ood_points: list[int]
    ood_answers: list[list[int]]  # [point][poly]
    batching_randomness: int

    def combined_ood_answers(self) -> list[int]:
        out = []
        for answers in self.ood_answers:
            acc, g = 0, 1
            for a in answers:
                acc = (acc + g * a) % F.P
                g = g * self.batching_randomness % F.P
            out.append(acc)
        return out


def parse_commitment(transcript, config: WhirConfig) -> ParsedCommitment:
    [root] = transcript.next_scalars(1)
    ood_points, ood_answers = [], []
    if config.commitment_ood_samples:
        ood_points = transcript.challenge_scalars(config.commitment_ood_samples)
        flat = transcript.next_scalars(
            config.commitment_ood_samples * config.batch_size)
        for i in range(config.commitment_ood_samples):
            ood_answers.append(
                flat[i * config.batch_size:(i + 1) * config.batch_size])
    gamma = 1
    if config.batch_size > 1:
        gamma = transcript.challenge_scalars(1)[0]
    return ParsedCommitment(root, ood_points, ood_answers, gamma)


def _check_pow(transcript, bits: float) -> None:
    ch = transcript.challenge_scalars(1)[0]
    nonce = transcript.next_pow_nonce()
    if not pow_mod.verify(ch, bits, nonce):
        raise WhirError("PoW verification failed")


def _read_sumcheck_rounds(transcript, claim: int, count: int, binders: list):
    """Quadratic sumcheck rounds in the whir crate's EVALUATION basis:
    each round sends [h(0), h(1), h(2)]; check h(0)+h(1) == claim, then
    interpolate at the drawn alpha (gnark utilities.go:148-170)."""
    for _ in range(count):
        e0, e1, e2 = transcript.next_scalars(3)
        if (e0 + e1) % F.P != claim:
            raise WhirError("sumcheck consistency failed")
        alpha = transcript.challenge_scalars(1)[0]
        binders.append(alpha)
        b1 = (4 * e1 - e2 - 3 * e0) * F.HALF % F.P
        b2 = (e2 - 2 * e1 + e0) * F.HALF % F.P
        claim = (b2 * alpha % F.P * alpha + b1 * alpha + e0) % F.P
    return claim


def _stir_indices(transcript, num_queries: int, folded_domain: int) -> list[int]:
    scalars = transcript.challenge_scalars(num_queries)
    return sorted({s % folded_domain for s in scalars})


def _read_openings(transcript, indices: list[int], depth: int,
                   leaf_elems: int):
    """Parse the (stir_answers, merkle_proof) hint pair for one opening.

    Returns (leaf_values, bottom_up_paths); raises WhirError on any
    structural mismatch.  Wire format: whir/hints.py (the Go verifier's
    common.go:44-63 / mt.go:37-60 surface); answers-before-path order
    as observed in the reference's own proof bytes."""
    try:
        leaf_values = deserialize_stir_answers(transcript.hint_bytes())
        idx_mp, siblings, topdown = deserialize_multipath(
            transcript.hint_bytes())
    except ValueError as e:
        raise WhirError(f"malformed opening hint: {e}") from None
    if idx_mp != indices:
        raise WhirError("hinted indices do not match drawn queries")
    if len(leaf_values) != len(indices):
        raise WhirError("stir_answers count mismatch")
    if any(len(v) != leaf_elems for v in leaf_values):
        raise WhirError("stir_answers leaf width mismatch")
    paths = []
    for sib, td in zip(siblings, topdown):
        if len(td) != max(0, depth - 1):
            raise WhirError("auth path depth mismatch")
        paths.append(([sib] if depth else []) + list(reversed(td)))
    return leaf_values, paths


def verify(transcript, config: WhirConfig, commitment: ParsedCommitment,
           statement: Statement) -> list[int]:
    """Verify an opening proof.  Returns all folding randomness (binders).

    Raises WhirError on any failure.
    """
    m = config.num_variables
    iff = config.initial_folding_factor

    chat = transcript.challenge_scalars(1)[0]
    values = (commitment.combined_ood_answers()
              + [sigma for _, sigma in statement.constraints])
    claim, g = 0, 1
    # accumulated weights: (coeff, eval_fn(point)->int, num_bound_before)
    deferred = []
    powers = []
    for v in values:
        powers.append(g)
        claim = (claim + g * v) % F.P
        g = g * chat % F.P
    for coeff, z in zip(powers, commitment.ood_points):
        coords = univariate_to_multilinear_point(z, m)
        deferred.append((coeff, _eq_evaluator(coords), 0))
    for coeff, (wt, _) in zip(powers[len(commitment.ood_points):],
                              statement.constraints):
        deferred.append((coeff, wt.eval_mle, 0))

    binders: list[int] = []
    claim = _read_sumcheck_rounds(transcript, claim, iff, binders)

    prev_root = commitment.root
    prev_log_domain = config.starting_log_domain
    prev_fold_size = 1 << iff
    prev_batch = config.batch_size
    prev_alphas = binders[-iff:] if iff else []
    roots = [commitment.root]

    for r, rc in enumerate(config.rounds):
        [root] = transcript.next_scalars(1)
        m_cur = m - iff - rc.folding_factor * r
        bound_so_far = iff + rc.folding_factor * r

        round_points, round_values = [], []
        if rc.ood_samples:
            oods = transcript.challenge_scalars(rc.ood_samples)
            answers = transcript.next_scalars(rc.ood_samples)
            round_points.extend(oods)
            round_values.extend(answers)

        if rc.pow_bits > 0:
            _check_pow(transcript, rc.pow_bits)

        folded_domain = (1 << prev_log_domain) // prev_fold_size
        indices = _stir_indices(transcript, rc.num_queries, folded_domain)
        depth = folded_domain.bit_length() - 1
        leaf_elems = prev_batch * prev_fold_size
        leaf_values, paths = _read_openings(transcript, indices, depth,
                                            leaf_elems)
        omega_prev = F.root_of_unity(prev_log_domain)
        for idx, vals, path in zip(indices, leaf_values, paths):
            if not merkle.verify_path(prev_root, vals, idx, path):
                raise WhirError("Merkle path verification failed")
            if prev_batch > 1:
                vals = rlc_leaf(vals, prev_batch, commitment.batching_randomness)
            y = pow(omega_prev, idx, F.P)
            fold_val = fold_opened_leaf(vals, y, prev_alphas)
            round_points.append(pow(y, prev_fold_size, F.P))
            round_values.append(fold_val)

        chat_r = transcript.challenge_scalars(1)[0]
        gpow = 1
        for z, v in zip(round_points, round_values):
            claim = (claim + gpow * v) % F.P
            coords = univariate_to_multilinear_point(z, m_cur)
            deferred.append((gpow, _eq_evaluator(coords), bound_so_far))
            gpow = gpow * chat_r % F.P

        claim = _read_sumcheck_rounds(transcript, claim, rc.folding_factor,
                                      binders)
        prev_root = root
        prev_log_domain -= 1
        prev_fold_size = 1 << rc.folding_factor
        prev_batch = 1
        prev_alphas = binders[-rc.folding_factor:]
        roots.append(root)

    # --- final phase ------------------------------------------------------
    v_final = config.final_sumcheck_rounds
    final_coeffs = transcript.next_scalars(1 << v_final)

    if config.final_pow_bits > 0:
        _check_pow(transcript, config.final_pow_bits)

    folded_domain = (1 << prev_log_domain) // prev_fold_size
    indices = _stir_indices(transcript, config.final_queries, folded_domain)
    depth = folded_domain.bit_length() - 1
    leaf_elems = prev_batch * prev_fold_size
    leaf_values, paths = _read_openings(transcript, indices, depth,
                                        leaf_elems)
    omega_prev = F.root_of_unity(prev_log_domain)
    for idx, vals, path in zip(indices, leaf_values, paths):
        if not merkle.verify_path(prev_root, vals, idx, path):
            raise WhirError("final Merkle path verification failed")
        if prev_batch > 1:
            vals = rlc_leaf(vals, prev_batch, commitment.batching_randomness)
        y = pow(omega_prev, idx, F.P)
        fold_val = fold_opened_leaf(vals, y, prev_alphas)
        point = pow(y, prev_fold_size, F.P)
        # univariate evaluation of the final polynomial at `point`
        want = 0
        for j, c in enumerate(final_coeffs):
            want = (want + c * pow(point, j, F.P)) % F.P
        if fold_val != want:
            raise WhirError("final polynomial does not match folded oracle")

    pre_final_bound = len(binders)
    claim = _read_sumcheck_rounds(transcript, claim, v_final, binders)
    final_binders = binders[pre_final_bound:]

    if config.final_folding_pow_bits > 0:
        _check_pow(transcript, config.final_folding_pow_bits)

    # deferred weight evaluations: the reference verifier trusts this hint
    # and hands the check to the gnark circuit (circuit.go:75-79); this
    # verifier re-derives the statement-weight MLE evaluations and REJECTS
    # a lying hint.
    try:
        deferred_hint = deserialize_scalar_vec(transcript.hint_bytes())
    except ValueError as e:
        raise WhirError(f"malformed deferred hint: {e}") from None
    if len(deferred_hint) != len(statement.constraints):
        raise WhirError("deferred_weight_evaluations count mismatch")

    # final identity: claim == W(binders) * f_final(final_binders)
    w_eval = 0
    evals_at_point = []
    for coeff, eval_fn, bound_before in deferred:
        gamma_seq = binders[bound_before:]
        point = list(reversed(gamma_seq))
        ev = eval_fn(point)
        evals_at_point.append(ev)
        w_eval = (w_eval + coeff * ev) % F.P
    n_ood = len(commitment.ood_points)
    stmt_evals = evals_at_point[n_ood:n_ood + len(statement.constraints)]
    if stmt_evals != deferred_hint:
        raise WhirError("deferred weight evaluations do not match")

    f_final = 0
    fin_point = list(reversed(final_binders))
    for j, c in enumerate(final_coeffs):
        term = c
        for k in range(v_final):
            if (j >> (v_final - 1 - k)) & 1:
                term = term * fin_point[k] % F.P
        f_final = (f_final + term) % F.P

    if claim != w_eval * f_final % F.P:
        raise WhirError("final WHIR identity failed")

    return binders


def _eq_evaluator(coords: list[int]):
    def ev(point: list[int]) -> int:
        assert len(point) == len(coords)
        acc = 1
        for c, x in zip(coords, point):
            acc = acc * ((c * x + (1 - c) * (1 - x)) % F.P) % F.P
        return acc % F.P
    return ev
