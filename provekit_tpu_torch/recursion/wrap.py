"""Recursive verification: wrap a NoirProof in Groth16.

Port of ``provekit_tpu/recursion/wrap.py``.

End-to-end counterpart of the reference's Go pipeline
(``recursive-verifier/cmd/cli/main.go`` → ``circuit.PrepareAndVerifyCircuit``
→ ``Circuit::Define`` → groth16.Prove/Verify, app/circuit/common.go:15-177):

1. :func:`build_verifier_circuit` synthesizes the full scheme verification
   (protocol/scheme.py::verify) as an R1CS over CircuitBuilder, with the
   proof's absorbed scalars as PUBLIC inputs (gnark's ``Transcript`` public
   witness, circuit.go:24-41) and Merkle openings/claimed sums as private
   hints.
2. :func:`setup` / :func:`prove` / :func:`verify` run the in-tree Groth16
   engine (recursion/groth16.py) on that circuit.

NOTE on key reuse: the circuit layout depends on the CONCRETE proof, not
just the scheme — STIR query dedup (which draws collide) and the sorted
opening order are fixed at synthesis (verifier_circuit.py::_hinted_openings),
so Groth16 keys from :func:`setup` are single-proof: wrapping a different
proof requires re-synthesis + a fresh setup.  The reference shares this
property (its gnark circuit shape embeds the proof's MultiPath geometry,
common.go:33-85); its CI regenerates the CCS per workload for the same
reason.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import bn254 as F
from ..whir.parameters import WhirConfig
from . import groth16
from .builder import CircuitBuilder, LC, ONE
from .gadgets import TranscriptGadget, split_transcript
from .verifier_circuit import (CommitmentGadget, StatementGadget,
                               dense_weights_eval, eq_table_gadget, eq_term,
                               horner, matrix_weights_eval,
                               parse_commitment_gadget, read_sumcheck_rounds,
                               whir_verify_gadget)

P = F.P


def spartan_verify_gadget(b: CircuitBuilder, tr: TranscriptGadget, m_0: int,
                          blinding_config: WhirConfig):
    """protocol/spartan.py::run_zk_sumcheck_verifier as constraints."""
    r = tr.challenge_scalars(m_0)
    com = parse_commitment_gadget(b, tr, blinding_config)
    [sum_g] = tr.next_scalars(1)
    rho = tr.challenge_scalars(1)[0]
    claim = b.mul(rho, sum_g)
    alphas = []
    for _ in range(m_0):
        coeffs = tr.next_scalars(4)
        b.assert_zero(coeffs[0].scale(2) + coeffs[1] + coeffs[2]
                      + coeffs[3] - claim)
        alpha = tr.challenge_scalars(1)[0]
        alphas.append(alpha)
        claim = horner(b, coeffs, alpha)

    f_sum, g_sum = tr.next_scalars(2)
    # tensor-of-powers weights [1, a, a^2, a^3] per alpha
    # (spartan.py::expand_powers / _blinding_statement)
    weights: list = []
    for a in alphas:
        a2 = b.square(a)
        weights.extend([ONE, a, a2, b.mul(a2, a)])
    m_commit = blinding_config.num_variables
    weights = weights + [LC()] * ((1 << m_commit) - len(weights))
    stmt = StatementGadget(m_commit)
    stmt.add(dense_weights_eval(weights),
             f_sum + b.mul(com.batching_randomness, g_sum))
    whir_verify_gadget(b, tr, blinding_config, com, stmt)

    last = claim - b.mul(rho, f_sum)
    return r, alphas, last


def build_verifier_circuit(scheme, inner_r1cs, proof: bytes,
                           debug_assert: bool = False, lookups: bool = True,
                           challenges=None) -> CircuitBuilder:
    """Synthesize the full verification of ``proof`` for ``scheme``.

    Mirrors protocol/scheme.py::verify.  Returns the populated builder;
    ``builder.build()`` yields (R1CS, witness) and
    ``builder.num_public`` public inputs (the absorbed transcript scalars,
    in order).  With ``debug_assert`` every row is checked against the
    host assignment as it is emitted (satisfaction proof without
    materializing the packed R1CS — used by scripts/recursion_scale.py).

    With ``lookups`` (default, the production path) the Skyscraper bar /
    PoW / query decompositions run through logUp tables
    (recursion/lookup.py) and the builder gains TWO trailing public inputs
    — the lookup challenges (beta, theta) — plus ``builder.lookups``
    holding the committed-wire indices for the Groth16 commitment.
    ``challenges`` supplies their concrete values (derived from the
    commitment point by :func:`prove`); without it a fixed placeholder is
    used, which yields the correct SHAPE and a satisfied system, but not
    the binding the soundness argument needs — :func:`prove` always
    re-synthesizes with the real values.
    """
    io = scheme.create_io_pattern()
    scalars_int, hints = split_transcript(io, proof)

    b = CircuitBuilder(debug_assert=debug_assert)
    scalar_lcs = [b.public_input(v) for v in scalars_int]
    beta_lc = theta_lc = None
    if lookups:
        from .lookup import (Lookups, PLACEHOLDER_BETA, PLACEHOLDER_THETA)
        bv, tv = challenges or (PLACEHOLDER_BETA, PLACEHOLDER_THETA)
        beta_lc = b.public_input(bv)
        theta_lc = b.public_input(tv)
        b.lookups = Lookups(b)
    tr = TranscriptGadget(b, io, scalar_lcs, list(hints))

    com = parse_commitment_gadget(b, tr, scheme.whir_witness)
    r, alpha, last = spartan_verify_gadget(
        b, tr, scheme.m_0, scheme.whir_for_hiding_spartan)

    # claimed_evaluations hint -> private witnesses (arthur.hint,
    # verifier/src/whir_r1cs.rs:79; gnark treats these as private witness)
    from ..whir.hints import deserialize_claimed_evaluations
    fv, gv = deserialize_claimed_evaluations(tr.hint_bytes())
    if len(fv) != 3 or len(gv) != 3:
        raise ValueError("claimed_evaluations count mismatch")
    f_sums = [b.alloc(v) for v in fv]
    g_sums = [b.alloc(v) for v in gv]

    # statement weights: eq_alpha^T M for M in (A, B, C) — evaluated at the
    # folding point inside whir_verify_gadget via the R1CS matrix-extension
    # evaluation (gnark matrix_evaluation.go:41-79)
    eq_alpha = eq_table_gadget(b, alpha)
    shared: dict = {}
    stmt = StatementGadget(scheme.m)
    for mat, f, g in zip((inner_r1cs.a, inner_r1cs.b, inner_r1cs.c),
                         f_sums, g_sums):
        entries = list(mat.iter_entries())
        stmt.add(matrix_weights_eval(entries, eq_alpha, shared, ""),
                 f + b.mul(com.batching_randomness, g))

    whir_verify_gadget(b, tr, scheme.whir_witness, com, stmt)
    tr.finish()

    # final Spartan identity: last == (f_a f_b - f_c) * eq(r, alpha)
    eq_ra = ONE
    for rr, aa in zip(r, alpha):
        eq_ra = b.mul(eq_ra, eq_term(b, rr, aa))
    want = b.mul(b.mul(f_sums[0], f_sums[1]) - f_sums[2], eq_ra)
    b.assert_eq(last, want)
    if lookups:
        b.lookups.finalize(beta_lc, theta_lc)
    return b


def lookup_challenges(d_point) -> tuple[int, int]:
    """(beta, theta) = hash of the Pedersen commitment point.

    The commitment binds every looked-up wire and multiplicity (the PoK in
    groth16.verify pins D to the committed basis), so challenges derived
    from D are sampled after the lookup multiset is fixed — the Fiat-Shamir
    step gnark performs for ``api.Commit`` (std/multicommit); the wrapper
    verifier recomputes them from the proof's D and refuses mismatching
    public inputs.
    """
    import hashlib
    if d_point is None:
        ser = b"infinity"
    else:
        ser = d_point[0].to_bytes(32, "big") + d_point[1].to_bytes(32, "big")
    out = []
    for tag in (b"beta", b"theta"):
        ctr = 0
        while True:
            h = hashlib.sha256(b"provekit-tpu-logup-" + tag + b"-" + ser
                               + ctr.to_bytes(4, "big")).digest()
            v = int.from_bytes(h, "big") % P
            if v:
                out.append(v)
                break
            ctr += 1
    return out[0], out[1]


@dataclass
class RecursiveKeys:
    keys: groth16.Groth16Keys
    wrapper_r1cs: object


def setup(scheme, inner_r1cs, sample_proof: bytes, rng=None,
          lookups: bool = True) -> RecursiveKeys:
    """Build the wrapper circuit once and run the Groth16 trusted setup."""
    builder = build_verifier_circuit(scheme, inner_r1cs, sample_proof,
                                     lookups=lookups)
    wrapper, _ = builder.build()
    committed = builder.lookups.committed if lookups else None
    return RecursiveKeys(
        groth16.setup(wrapper, rng=rng, committed=committed), wrapper)


def prove(rk: RecursiveKeys, scheme, inner_r1cs, proof: bytes,
          rng=None) -> tuple[groth16.Groth16Proof, list[int]]:
    """Wrap ``proof`` in a Groth16 proof.  Returns (g16 proof, publics).

    With lookups the synthesis runs twice: pass 1 (placeholder challenges)
    yields the committed wires' values — which are challenge-independent —
    the commitment D over them fixes (beta, theta), and pass 2 solves the
    challenge-dependent wires (logUp inverses) with the real values.
    """
    lookups = bool(rk.keys.committed)
    builder = build_verifier_circuit(scheme, inner_r1cs, proof,
                                     lookups=lookups)
    d_pt = None
    if lookups:
        cvals = [builder.values[i] for i in rk.keys.committed]
        d_pt = groth16.commit(rk.keys, cvals)
        builder = build_verifier_circuit(
            scheme, inner_r1cs, proof, lookups=True,
            challenges=lookup_challenges(d_pt))
        assert [builder.values[i] for i in rk.keys.committed] == cvals, \
            "committed wires drifted between synthesis passes"
    z = list(builder.values)
    assert len(z) == rk.wrapper_r1cs.num_witnesses, \
        "circuit shape differs from the setup-time synthesis"
    publics = z[1:builder.num_public + 1]
    return (groth16.prove(rk.keys, rk.wrapper_r1cs, z, rng=rng, d_pt=d_pt),
            publics)


def verify(rk: RecursiveKeys, g16_proof: groth16.Groth16Proof,
           publics: list[int]) -> bool:
    if rk.keys.committed:
        beta, theta = lookup_challenges(g16_proof.d)
        if list(publics[-2:]) != [beta, theta]:
            return False
    return groth16.verify(rk.keys, g16_proof, publics)
