"""WHIR protocol parameter derivation (whir-crate-conformant).

Reproduces the round-parameter schedule of the reference's WHIR dependency
(whir crate rev 3e7f8c2, ``WhirConfig::new`` in whir/src/whir/parameters.rs)
as pinned by the exported ``WHIRConfigGnark``
(``tooling/provekit-gnark/src/gnark_config.rs:32-98``: n_rounds, per-round
ood_samples/num_queries/pow_bits, final_queries, final_pow_bits,
final_folding_pow_bits, domain_generator, batch_size) and consumed
field-for-field by the Go verifier (``recursive-verifier/app/circuit/
types.go:25-38``, ``whir.go:15-46``).

Scheme-level choices come from ``provekit/r1cs-compiler/src/whir_r1cs.rs:
38-54``: security 128, ConjectureList soundness, constant folding factor 4,
starting rate 1/2, ``pow_bits = default_max_pow(num_variables, 1)``.

ConjectureList accounting (whir crate, parameters.rs):

* ``log_eta(rate) = -(rate + 1)``
* ``list_size_bits(nv, rate) = nv + rate - log_eta(rate)``
* out-of-domain samples: smallest ``o`` with
  ``o*field_bits + 1 - (2*list_size_bits + nv*o) >= security``
* in-domain queries: ``ceil(protocol_security / rate)`` where
  ``protocol_security = security - max_pow_bits``
* round PoW tops the error terms back up to ``security``:
  ``max(0, security - min(query_error, combination_error))`` with
  ``query_error = nq * rate`` and
  ``combination_error = field_bits - (list_size + log2(ood+nq) + 1)``
* per-fold ("folding") PoW bits are ``max(0, security - min(prox_gaps,
  sumcheck_err))`` — identically 0 over a 254-bit field at these sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..fields import bn254 as F

# BN254 scalar field size in bits (ark_ff MODULUS_BIT_SIZE for Fr).
FIELD_BITS = 254


def default_max_pow(num_variables: int, log_inv_rate: int) -> int:
    """whir::parameters::default_max_pow: nv + rate - 3."""
    return num_variables + log_inv_rate - 3


def _log_eta(log_inv_rate: int) -> float:
    """ConjectureList: -(rate + 1)."""
    return -(log_inv_rate + 1.0)


def _list_size_bits(num_variables: int, log_inv_rate: int) -> float:
    return num_variables + log_inv_rate - _log_eta(log_inv_rate)


def _rbr_ood_sample(num_variables: int, log_inv_rate: int,
                    ood_samples: int) -> float:
    lsb = _list_size_bits(num_variables, log_inv_rate)
    error = 2.0 * lsb + num_variables * ood_samples
    return ood_samples * FIELD_BITS + 1.0 - error


def ood_samples(security_level: int, num_variables: int,
                log_inv_rate: int) -> int:
    """Smallest sample count achieving `security_level` rbr bits (1..63)."""
    for o in range(1, 64):
        if _rbr_ood_sample(num_variables, log_inv_rate, o) >= security_level:
            return o
    raise ValueError("could not find an appropriate number of OOD samples")


def _queries(protocol_security_level: int, log_inv_rate: int) -> int:
    """ConjectureList: each query contributes `rate` bits."""
    return math.ceil(protocol_security_level / log_inv_rate)


def _rbr_queries(log_inv_rate: int, num_queries: int) -> float:
    return float(num_queries * log_inv_rate)


def _rbr_queries_combination(num_variables: int, log_inv_rate: int,
                             ood: int, num_queries: int) -> float:
    lsb = _list_size_bits(num_variables, log_inv_rate)
    return FIELD_BITS - (lsb + math.log2(ood + num_queries) + 1.0)


def _folding_pow_bits(security_level: int, num_variables: int,
                      log_inv_rate: int) -> float:
    prox_gaps = FIELD_BITS - (num_variables + log_inv_rate
                              - _log_eta(log_inv_rate))
    sumcheck = FIELD_BITS - (_list_size_bits(num_variables, log_inv_rate)
                             + 1.0)
    return max(0.0, security_level - min(prox_gaps, sumcheck))


@dataclass(frozen=True)
class RoundConfig:
    ood_samples: int
    num_queries: int
    pow_bits: float
    folding_pow_bits: float
    log_domain_size: int      # domain size of the oracle being queried
    log_inv_rate: int         # of the oracle being queried
    folding_factor: int


@dataclass
class WhirConfig:
    num_variables: int
    batch_size: int = 1
    security_level: int = 128
    max_pow_bits: int | None = None   # None -> default_max_pow(nv, rate)
    starting_log_inv_rate: int = 1
    folding_factor: int = 4

    # derived
    commitment_ood_samples: int = field(init=False)
    initial_folding_factor: int = field(init=False)
    starting_folding_pow_bits: float = field(init=False)
    final_sumcheck_rounds: int = field(init=False)
    n_rounds: int = field(init=False)
    rounds: list = field(init=False)
    final_queries: int = field(init=False)
    final_pow_bits: float = field(init=False)
    final_folding_pow_bits: float = field(init=False)
    starting_log_domain: int = field(init=False)
    domain_generator: int = field(init=False)

    def __post_init__(self):
        m, ff = self.num_variables, self.folding_factor
        assert m >= 1
        if self.max_pow_bits is None:
            self.max_pow_bits = default_max_pow(
                m, self.starting_log_inv_rate)
        # FoldingFactor::Constant::compute_number_of_rounds — the last full
        # fold is merged into the final phase.
        self.initial_folding_factor = min(ff, m)
        self.final_sumcheck_rounds = m % ff if m >= ff else 0
        self.n_rounds = max(
            0, (m - self.final_sumcheck_rounds) // ff - 1) if m >= ff else 0
        self.starting_log_domain = m + self.starting_log_inv_rate
        assert self.starting_log_domain <= F.TWO_ADICITY
        self.domain_generator = F.root_of_unity(self.starting_log_domain)

        protocol_security = max(0, self.security_level - self.max_pow_bits)

        # initial_statement=true path (whir_r1cs.rs:40-51)
        self.commitment_ood_samples = ood_samples(
            self.security_level, m, self.starting_log_inv_rate)
        self.starting_folding_pow_bits = _folding_pow_bits(
            self.security_level, m, self.starting_log_inv_rate)

        nv = m - self.initial_folding_factor
        log_inv_rate = self.starting_log_inv_rate
        log_domain = self.starting_log_domain
        self.rounds = []
        for _ in range(self.n_rounds):
            # queries are set w.r.t. the OLD rate, the rest to the NEW rate
            next_rate = log_inv_rate + (ff - 1)
            nq = _queries(protocol_security, log_inv_rate)
            ood = ood_samples(self.security_level, nv, next_rate)
            query_error = _rbr_queries(log_inv_rate, nq)
            comb_error = _rbr_queries_combination(nv, next_rate, ood, nq)
            pow_bits = max(0.0, self.security_level
                           - min(query_error, comb_error))
            fold_pow = _folding_pow_bits(self.security_level, nv, next_rate)
            self.rounds.append(RoundConfig(
                ood_samples=ood, num_queries=nq, pow_bits=pow_bits,
                folding_pow_bits=fold_pow, log_domain_size=log_domain,
                log_inv_rate=log_inv_rate, folding_factor=ff))
            nv -= ff
            log_inv_rate = next_rate
            log_domain -= 1

        self.final_log_domain = log_domain
        self.final_log_inv_rate = log_inv_rate
        self.final_queries = _queries(protocol_security, log_inv_rate)
        self.final_pow_bits = max(
            0.0, self.security_level
            - _rbr_queries(log_inv_rate, self.final_queries))
        self.final_folding_pow_bits = max(
            0.0, self.security_level - (FIELD_BITS - 1.0))

        # The transcript engine emits no ops for per-sumcheck-round grinding;
        # over a 254-bit field these are identically zero (the Go verifier
        # does not model them either — whir.go:166,189).
        assert self.starting_folding_pow_bits == 0.0
        assert all(r.folding_pow_bits == 0.0 for r in self.rounds)

    # -- helpers -----------------------------------------------------------

    def opening_budgets(self) -> list[tuple[int, int, int]]:
        """Per-opening (queries, tree_depth, leaf_elems) in prover order.

        Mirrors the oracle geometry of ``whir.prover.prove``: opening r
        reads the round-(r-1) tree (the initial commitment for r=0, with
        batch_size polys per leaf), the final opening reads the last tree.
        Used for the proof-size budget (no query dedup assumed).
        """
        outs = []
        prev_log = self.starting_log_domain
        prev_fold = 1 << self.initial_folding_factor
        k = self.batch_size
        for rc in self.rounds:
            depth = prev_log - (prev_fold.bit_length() - 1)
            outs.append((rc.num_queries, depth, k * prev_fold))
            prev_log -= 1
            prev_fold = 1 << rc.folding_factor
            k = 1
        depth = prev_log - (prev_fold.bit_length() - 1)
        outs.append((self.final_queries, depth, k * prev_fold))
        return outs

    def proof_size_budget(self, n_constraints: int) -> int:
        """Upper-bound transcript bytes contributed by this WHIR proof
        (sumcheck absorbs + pow nonces + opening hints + deferred hint;
        auth paths un-deduped and un-prefix-compressed)."""
        size = 0
        # absorbed scalars of proof_pattern (+ 8-byte pow nonces)
        absorbs = 3 * self.initial_folding_factor
        nonces = 0
        for rc in self.rounds:
            absorbs += 1 + rc.ood_samples
            nonces += 1 if rc.pow_bits > 0 else 0
            absorbs += 3 * rc.folding_factor
        absorbs += 1 << self.final_sumcheck_rounds
        nonces += 1 if self.final_pow_bits > 0 else 0
        nonces += 1 if self.final_folding_pow_bits > 0 else 0
        size += 32 * absorbs + 8 * nonces
        for q, depth, leaf_elems in self.opening_budgets():
            multipath = (8 + q * 32) + (8 + q * 8) \
                + (8 + q * (8 + depth * 32)) + (8 + q * 8)
            answers = 8 + q * (8 + leaf_elems * 32)
            size += (4 + multipath) + (4 + answers)
        size += 4 + 8 + 32 * n_constraints  # deferred_weight_evaluations
        return size

    def commit_size(self) -> int:
        """Absorbed bytes of one batch commitment (commit_pattern)."""
        return 32 * (1 + self.commitment_ood_samples * self.batch_size)

    def round_domain_generator(self, r: int) -> int:
        """Generator of the domain of the r-th committed oracle (0 = initial)."""
        return F.root_of_unity(self.starting_log_domain - r)

    def describe(self) -> dict:
        """The WHIRConfigGnark-shaped summary (gnark_config.rs:60-98).

        folding_factor lists one entry per WHIR round (gnark appends the
        final-phase factor itself, whir.go:21-27); pow entries are f64->i32
        truncations like the Rust export.
        """
        return {
            "n_rounds": self.n_rounds,
            "rate": self.starting_log_inv_rate,
            "n_vars": self.num_variables,
            "folding_factor": [self.initial_folding_factor]
                              + [r.folding_factor for r in self.rounds],
            "ood_samples": [r.ood_samples for r in self.rounds],
            "num_queries": [r.num_queries for r in self.rounds],
            "pow_bits": [int(r.pow_bits) for r in self.rounds],
            "final_queries": self.final_queries,
            "final_pow_bits": int(self.final_pow_bits),
            "final_folding_pow_bits": int(self.final_folding_pow_bits),
            "domain_generator": str(self.domain_generator),
            "batch_size": self.batch_size,
        }
