"""WhirR1CSScheme: the top-level R1CS proof scheme (prove / verify).

Port of ``provekit_tpu/protocol/scheme.py``:
* parameters: ``WhirR1CSScheme::new_for_r1cs``
  (r1cs-compiler/src/whir_r1cs.rs:15-54) — m = log2ceil(witnesses)+1,
  m_0 = log2ceil(constraints), witness WHIR batch 2, blinding WHIR over
  log2ceil(4*m_0)+1 variables.
* transcript: ``create_io_pattern`` (common/src/whir_r1cs.rs:28-39) —
  commit witness, draw r, commit blinding, zk sumcheck, blinding WHIR,
  claimed-evaluations hint, witness WHIR.
* prover: ``WhirR1CSProver::prove`` (prover/src/whir_r1cs.rs:40-100).
* verifier: ``WhirR1CSVerifier::verify`` (verifier/src/whir_r1cs.rs:35-89),
  with the linear-statement weights (eq_r^T M rows) evaluated at the
  folding point instead of deferred.

The scheme carries the torch ``device`` that prove and verify run on; the
entry points default to the card (``"cuda"``), and the CPU is taken only
when the caller asks for it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..fs import DomainSeparator
from ..fs import device as D
from ..ops import sumcheck as sc
from ..r1cs import R1CS
from ..utils.profiling import span
from ..whir import (DenseWeights, Statement, WhirConfig, committer, prover,
                    verifier)
from ..whir.hints import (deserialize_claimed_evaluations,
                          serialize_claimed_evaluations)
from ..whir.prover import _scalars_of_block
from ..whir.verifier import WhirError
from . import spartan


def next_power_of_two_log(n: int) -> int:
    """ceil(log2(n)) (reference utils::next_power_of_two semantics)."""
    if n <= 1:
        return 0
    return (n - 1).bit_length()


@dataclass
class WhirR1CSScheme:
    m: int
    m_0: int
    a_num_terms: int
    whir_witness: WhirConfig
    whir_for_hiding_spartan: WhirConfig
    security_level: int = 128
    # None -> each WHIR config derives default_max_pow(num_vars, rate),
    # matching the reference (whir_r1cs.rs:43); an int pins both configs
    # (used by reduced-security tests).
    max_pow_bits: int | None = None
    # the torch device every prove and verify of this scheme runs on
    device: torch.device = field(kw_only=True)

    @classmethod
    def new_for_r1cs(cls, r1cs: R1CS, security_level: int = 128,
                     max_pow_bits: int | None = None, *,
                     device="cuda") -> "WhirR1CSScheme":
        m = next_power_of_two_log(r1cs.num_witnesses)
        m_0 = max(1, next_power_of_two_log(r1cs.num_constraints))
        blinding_vars = next_power_of_two_log(4 * m_0) + 1
        return cls(
            m=m + 1,
            m_0=m_0,
            a_num_terms=next_power_of_two_log(max(1, r1cs.a.nnz)),
            whir_witness=WhirConfig(
                num_variables=m + 1, batch_size=2,
                security_level=security_level, max_pow_bits=max_pow_bits),
            whir_for_hiding_spartan=WhirConfig(
                num_variables=blinding_vars, batch_size=2,
                security_level=security_level, max_pow_bits=max_pow_bits),
            security_level=security_level, max_pow_bits=max_pow_bits,
            device=torch.device(device))

    # -- transcript shape --------------------------------------------------

    def create_io_pattern(self) -> DomainSeparator:
        ds = DomainSeparator("🌪️")
        committer.commit_pattern(ds, self.whir_witness, label="_witness")
        ds.squeeze(self.m_0, "rand")
        committer.commit_pattern(ds, self.whir_for_hiding_spartan,
                                 label="_blinding")
        spartan.add_zk_sumcheck_pattern(ds, self.m_0)
        prover.proof_pattern(ds, self.whir_for_hiding_spartan, "_blinding")
        ds.hint("claimed_evaluations")
        prover.proof_pattern(ds, self.whir_witness, "_witness")
        return ds

    def proof_size_budget(self) -> int:
        """Upper-bound proof bytes from the scheme parameters alone.

        Sums the transcript's absorbed scalars and hint bodies across both
        WHIR instances (query counts x tree depths x 32-byte scalars),
        assuming no STIR-index dedup and no auth-path prefix compression —
        actual proofs come in under this (VERDICT r3 item 10: a derivable
        size budget to compare `len(proof)` against)."""
        size = self.whir_witness.commit_size() \
            + self.whir_for_hiding_spartan.commit_size()
        if self.whir_witness.batch_size > 1:
            pass  # batching randomness is squeezed, not absorbed
        # zk-sumcheck absorbs: sum_g, m_0 x 4 coeffs, 2 polynomial sums
        size += 32 * (1 + 4 * self.m_0 + 2)
        size += self.whir_for_hiding_spartan.proof_size_budget(1)
        size += 4 + 8 + 3 * 32 + 8 + 3 * 32  # claimed_evaluations hint
        size += self.whir_witness.proof_size_budget(3)
        return size

    # -- prove -------------------------------------------------------------

    def prove(self, r1cs: R1CS, witness: list[int], rng=None) -> bytes:
        """Prove R1CS satisfaction on ``self.device``.  ``rng`` (a
        ``random.Random``) is the proof's only randomness: the ZK masks and
        blinding polynomials; without one it is the OS's entropy."""
        rng = rng if rng is not None else random.SystemRandom()
        assert len(witness) == r1cs.num_witnesses
        assert r1cs.num_witnesses <= 1 << self.m
        assert r1cs.num_constraints <= 1 << self.m_0
        dev = self.device
        tr = D.DeviceProverState(self.create_io_pattern(), dev)

        with span("commit_witness"):
            z = V.to_mont(V.pack(witness, dev))
            padded = torch.nn.functional.pad(
                z, (0, (1 << (self.m - 1)) - len(witness)))
            com = spartan.batch_commit_to_polynomial(
                self.m, self.whir_witness, padded, tr, rng)

        with span("zk_spartan_sumcheck"):
            out = spartan.run_zk_sumcheck_prover(
                r1cs, z, tr, self.m_0, self.whir_for_hiding_spartan, rng)

        # weights: eq_alpha^T A, B, C over witness columns
        with span("statement_weights"):
            eq_alpha = D.eq_table_dev(out.alpha, self.m_0)[
                :, :r1cs.num_constraints]
            statement = Statement(self.m)
            f_sums, g_sums = [], []
            masked_arr = com.polys[0]
            rand_arr = com.polys[1]
            for mat in (r1cs.a, r1cs.b, r1cs.c):
                row = mat.mul_left(eq_alpha)  # (16, num_witnesses) Montgomery
                row_p = torch.nn.functional.pad(
                    row, (0, (1 << self.m) - row.shape[1]))
                w = DenseWeights(row_p, self.m)
                f = sc.weighted_sum(row_p, masked_arr).reshape(16, 1)
                g = sc.weighted_sum(row_p, rand_arr).reshape(16, 1)
                f_sums.append(f)
                g_sums.append(g)
                statement.add_constraint(
                    w, V.add_mod(f, V.mont_mul(com.batching_randomness, g)))

        sums_c = D.from_mont(torch.cat(f_sums + g_sums, dim=1))

        def _claimed_builder(block):
            # ark ClaimedEvaluations { f_sums: Vec<Fp256>, g_sums: Vec<Fp256> }
            vals = _scalars_of_block(block, 1, 6)[0]
            return serialize_claimed_evaluations(vals[:3], vals[3:])

        tr.hint_arrays(_claimed_builder, [sums_c])

        with span("whir_open_witness"):
            prover.prove(tr, self.whir_witness, com, statement)
        with span("narg_fetch"):
            return tr.narg_string()

    # -- verify ------------------------------------------------------------

    def verify(self, r1cs: R1CS, proof: bytes) -> None:
        """Verify ``proof``; raises WhirError (or ValueError on a malformed
        transcript) when it is rejected."""
        dev = self.device
        tr = self.create_io_pattern().to_verifier_state(proof)

        com = verifier.parse_commitment(tr, self.whir_witness)
        sout = spartan.run_zk_sumcheck_verifier(
            tr, self.m_0, self.whir_for_hiding_spartan, dev)

        try:
            f_sums, g_sums = deserialize_claimed_evaluations(tr.hint_bytes())
        except ValueError as e:
            raise WhirError(f"claimed_evaluations hint malformed: {e}") \
                from None
        if len(f_sums) != 3 or len(g_sums) != 3:
            raise WhirError("claimed_evaluations count mismatch")

        eq_alpha = sc.eq_table(sout.alpha, dev)[:, :r1cs.num_constraints]
        statement = Statement(self.m)
        for mat, f, g in zip((r1cs.a, r1cs.b, r1cs.c), f_sums, g_sums):
            row = mat.mul_left(eq_alpha)
            row_p = torch.nn.functional.pad(
                row, (0, (1 << self.m) - row.shape[1]))
            statement.add_constraint(
                DenseWeights(row_p, self.m),
                (f + com.batching_randomness * g) % F.P)

        verifier.verify(tr, self.whir_witness, com, statement)
        tr.finish()

        eq_r_alpha = sc.eq_point(sout.r, sout.alpha)
        want = (f_sums[0] * f_sums[1] - f_sums[2]) % F.P * eq_r_alpha % F.P
        if sout.last_sumcheck_val != want:
            raise WhirError("Spartan final check failed")
