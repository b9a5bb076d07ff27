"""The port's transcript pattern and its bookkeeping against the JAX
package's, exactly.

A ``DomainSeparator`` declares the order of a proof's absorbs, squeezes and
hints; its bytes seed the sponge (the IV), so any drift changes every
challenge.  Each pattern below must give the JAX package's bytes and IV,
and a prover or verifier that leaves the declared order, or reads a
malformed transcript, must be refused with the JAX package's message.
Nothing here permutes the sponge: hints move bytes only, and every refusal
comes before a permutation.
"""

import pytest

from provekit_tpu.fields import bn254 as JF
from provekit_tpu.fs import DomainSeparator as JDomainSeparator
from provekit_tpu_torch.fs import DomainSeparator

# name -> ops (kind, count, label) of a pattern
PATTERNS = {
    "empty": [],
    "sumcheck": [("A", 1, "commitment"), ("S", 1, "ood_query"),
                 ("A", 3, "sumcheck_poly"), ("S", 1, "folding_randomness"),
                 ("A", 3, "sumcheck_poly"), ("S", 2, "stir_queries")],
    "hints": [("H", 0, "merkle_proof"), ("A", 2, "ood_answers"),
              ("H", 0, "stir_answers"), ("H", 0, "claimed_evaluations")],
    "pow": [("S", 1, "pow-challenge"), ("A", 8, "pow-nonce"),
            ("S", 1, "after")],
    "labels": [("A", 1, "α→β"), ("S", 1, "x" * 300), ("H", 0, "")],
}


def domsep(cls, ops, label="provekit"):
    d = cls(label)
    for kind, count, name in ops:
        if kind == "A":
            d.absorb(count, name)
        elif kind == "S":
            d.squeeze(count, name)
        else:
            d.hint(name)
    return d


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_domain_separator_is_the_jax_one(name):
    got = domsep(DomainSeparator, PATTERNS[name])
    want = domsep(JDomainSeparator, PATTERNS[name])
    assert got.as_bytes() == want.as_bytes()
    assert got.iv() == want.iv() and len(got.iv()) == 32
    assert [(o.kind, o.count, o.label) for o in got.ops] == [
        (o.kind, o.count, o.label) for o in want.ops]
    assert got.as_bytes().startswith(b"provekit")


def test_hints_travel_as_jax_frames_them():
    """Hints are length-prefixed bytes on the wire, read back unchanged."""
    ops = [("H", 0, "a"), ("H", 0, "b"), ("H", 0, "c")]
    data = [b"", b"\x01", bytes(range(200))]
    prover, jprover = (domsep(c, ops).to_prover_state()
                       for c in (DomainSeparator, JDomainSeparator))
    for d in data:
        prover.hint_bytes(d)
        jprover.hint_bytes(d)
    narg = prover.narg_string()
    assert narg == jprover.narg_string()
    assert narg[:4] == b"\0\0\0\0" and len(narg) == 12 + 1 + 200
    verifier = domsep(DomainSeparator, ops).to_verifier_state(narg)
    assert [verifier.hint_bytes() for _ in data] == data
    verifier.finish()


def _prover(cls, ops, steps):
    p = domsep(cls, ops).to_prover_state()
    for step in steps:
        step(p)


def _verifier(cls, ops, narg, steps):
    v = domsep(cls, ops).to_verifier_state(narg)
    for step in steps:
        step(v)


# name -> a run (on either package's classes) that must be refused
REFUSALS = {
    "prover_hint_where_absorb_declared": lambda c: _prover(
        c, [("A", 1, "x")], [lambda p: p.hint_bytes(b"h")]),
    "prover_past_the_pattern": lambda c: _prover(
        c, [("H", 0, "h")], [lambda p: p.hint_bytes(b""),
                             lambda p: p.hint_bytes(b"")]),
    "prover_stops_early": lambda c: _prover(
        c, [("H", 0, "h"), ("A", 1, "x")],
        [lambda p: p.hint_bytes(b""), lambda p: p.narg_string()]),
    "verifier_wrong_count": lambda c: _verifier(
        c, [("A", 2, "x")], bytes(64), [lambda v: v.next_scalars(1)]),
    "verifier_non_canonical_scalar": lambda c: _verifier(
        c, [("A", 1, "x")], JF.P.to_bytes(32, "little"),
        [lambda v: v.next_scalars(1)]),
    "verifier_short_hint": lambda c: _verifier(
        c, [("H", 0, "h")], b"\x05\0\0\0ab", [lambda v: v.hint_bytes()]),
    "verifier_trailing_bytes": lambda c: _verifier(
        c, [("H", 0, "h")], b"\x01\0\0\0ab",
        [lambda v: v.hint_bytes(), lambda v: v.finish()]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_transcript_refusals_are_the_jax_refusals(case):
    with pytest.raises(ValueError) as want:
        REFUSALS[case](JDomainSeparator)
    with pytest.raises(ValueError) as got:
        REFUSALS[case](DomainSeparator)
    assert str(got.value) == str(want.value)
