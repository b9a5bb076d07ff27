"""The port's recursion (``recursion/``) and host curve engine
(``native/curve.py``) against the JAX package's, on the CPU.

Every comparison is exact: the same field elements, points, keys, wires and
matrices.  No JAX prove runs here: the inner proofs are the port's, proved
with a seeded ``rng``, whose bytes are the JAX package's
(``tests/test_torch_e2e.py`` pins the tiny proof's digest).  The engine is
held to the pure-Python curve code of both packages and to the JAX
package's own native library; the Groth16 keys and proofs of the port
(engine) equal the JAX package's on the same seeded ``rng``.
"""

import importlib
import pathlib
import pickle
import random

import pytest
import torch

import chip_smoke
from provekit_tpu.fields import bn254 as JF
from provekit_tpu.native import curve as JNC
from provekit_tpu.r1cs import R1CS as JR1CS
from provekit_tpu.recursion import groth16 as jgroth16
from provekit_tpu.recursion import wrap as jwrap
from provekit_tpu.recursion.curve import G1 as JG1
from provekit_tpu.recursion.curve import G2 as JG2
from provekit_tpu.recursion.fq import Fq2 as JFq2
from provekit_tpu.recursion.fq import Fq12 as JFq12
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.native import build as NB
from provekit_tpu_torch.native import curve as NC
from provekit_tpu_torch.r1cs import R1CS
from provekit_tpu_torch.recursion import fq, groth16, wrap
from provekit_tpu_torch.recursion.curve import (G1, G2, g1_generator,
                                                g2_generator)
from provekit_tpu_torch.recursion.gadgets import split_transcript
from provekit_tpu_torch.whir.verifier import WhirError
from tests.test_verifier_circuit import tiny_scheme as jtiny_scheme

torch.set_num_threads(1)

CPU = torch.device("cpu")
jfq = importlib.import_module("provekit_tpu.recursion.fq")
pairing = importlib.import_module("provekit_tpu_torch.recursion.pairing")
jpairing = importlib.import_module("provekit_tpu.recursion.pairing")


def as_jax(x):
    """A port value (int, Fq2, Fq12, point, list) as the JAX package's."""
    if isinstance(x, fq.Fq2):
        return JFq2(x[0], x[1])
    if isinstance(x, fq.Fq12):
        return JFq12(x)
    if isinstance(x, (tuple, list)):
        return type(x)(as_jax(v) for v in x)
    return x


# -- fields and groups --------------------------------------------------------


def test_fq_towers_match_jax():
    rng = random.Random(3)
    assert (fq.Q, fq.FQ12_MOD, fq.B2) == (jfq.Q, jfq.FQ12_MOD, jfq.B2)
    assert (fq.W, fq.W2, fq.W3) == (jfq.W, jfq.W2, jfq.W3)
    for _ in range(20):
        a, b = (fq.Fq2(rng.randrange(fq.Q), rng.randrange(fq.Q))
                for _ in range(2))
        ja, jb = as_jax(a), as_jax(b)
        k = rng.randrange(fq.Q)
        assert [a + b, a - b, -a, a * b, a * k, a.sqr(), a.inv(),
                a.conj()] == [ja + jb, ja - jb, -ja, ja * jb, ja * k,
                              ja.sqr(), ja.inv(), ja.conj()]
        assert a * a.inv() == fq.Fq2.one()
        assert fq.fq_inv(k) == jfq.fq_inv(k)
    for _ in range(4):
        x, y = (fq.Fq12([rng.randrange(fq.Q) for _ in range(12)])
                for _ in range(2))
        jx, jy = as_jax(x), as_jax(y)
        e = rng.randrange(1 << 64)
        assert [x + y, x - y, -x, x * y, x.inv(), x.pow(e)] == \
            [jx + jy, jx - jy, -jx, jx * jy, jx.inv(), jx.pow(e)]
        assert (x * x.inv()).is_one()
        assert fq.Fq12.from_fq2(fq.Fq2(5, 7)) == JFq12.from_fq2(JFq2(5, 7))
        assert pairing._fq12_frob(x) == jpairing._fq12_frob(jx)


def test_generators_and_group_law_match_jax():
    from provekit_tpu.recursion.curve import g1_generator as jg1
    from provekit_tpu.recursion.curve import g2_generator as jg2
    g1, g2 = g1_generator(), g2_generator()
    assert (g1, g2) == (jg1(), jg2())
    assert G1.is_on_curve(g1) and G2.is_on_curve(g2)
    assert G1.mul(g1, F.P) is None and G2.mul(g2, F.P) is None
    rng = random.Random(4)
    for group, jgroup, g in ((G1, JG1, g1), (G2, JG2, g2)):
        p = group.mul(g, rng.randrange(F.P))
        q = group.mul(g, rng.randrange(F.P))
        assert [group.add(p, q), group.double(p), group.neg(p),
                group.add(group.double(g), g)] == \
            [jgroup.add(p, q), jgroup.double(p), jgroup.neg(p),
             group.mul(g, 3)]


def test_fq2_pickles():
    """Keys with G2 points go through pickle (``recursive-verify --keys``).
    The JAX package's Fq2 does not rebuild from its pickle: that cache's
    second run fails there."""
    a = fq.Fq2(3, 5)
    b = pickle.loads(pickle.dumps(a))
    assert b == a and type(b) is fq.Fq2
    g2 = g2_generator()
    assert pickle.loads(pickle.dumps(g2)) == g2
    with pytest.raises(TypeError):
        pickle.loads(pickle.dumps(JFq2(3, 5)))


# -- the engine against the pure-Python code ----------------------------------


@pytest.fixture(scope="module")
def batch():
    """300 seeded scalars and the engine's fixed-base batches of them."""
    rng = random.Random(5)
    scalars = [rng.randrange(F.P) for _ in range(300)]
    scalars[7] = 0  # the point at infinity among the points
    g1s = NC.g1_mul_base_batch(g1_generator(), scalars)
    g2s = NC.g2_mul_base_batch(g2_generator(), scalars)
    return scalars, g1s, g2s


def test_engine_base_batches(batch):
    scalars, g1s, g2s = batch
    assert g1s[7] is None and g2s[7] is None
    assert g1s == JNC.g1_mul_base_batch(g1_generator(), scalars)
    assert g2s == JNC.g2_mul_base_batch(g2_generator(), scalars)
    for i in range(0, 300, 60):  # the pure-Python multiplications
        assert g1s[i] == G1.mul(g1_generator(), scalars[i])
        assert g2s[i] == G2.mul(g2_generator(), scalars[i])


def test_engine_msms(batch):
    scalars, g1s, g2s = batch
    rng = random.Random(6)
    coeffs = [rng.randrange(F.P) for _ in range(200)]
    for group, nc_msm, jnc_msm, pts in (
            (G1, NC.g1_msm, JNC.g1_msm, g1s[:200]),
            (G2, NC.g2_msm, JNC.g2_msm, g2s[:200])):
        got = nc_msm(pts, coeffs)
        assert got == group.msm(pts, coeffs) == jnc_msm(pts, coeffs)
        assert nc_msm([], []) is None
        assert nc_msm(pts[:1], [3]) == group.mul(pts[0], 3)


def test_engine_fr_ntt():
    rng = random.Random(8)
    for log_n in (1, 9, 10):
        vals = [rng.randrange(F.P) for _ in range(1 << log_n)]
        omega = groth16._root_of_unity(log_n)
        fwd = NC.fr_ntt(vals, omega)
        assert fwd == groth16._ntt(vals, omega) == jgroth16._ntt(vals, omega)
        assert fwd == JNC.fr_ntt(vals, omega)
        assert NC.fr_ntt(fwd, omega, invert=True) == vals == \
            groth16._intt(fwd, omega)


def test_engine_has_no_fallback(tmp_path, monkeypatch):
    """A library that cannot be built raises, and says why; Groth16 raises
    with it rather than running in Python.  (The curve engine builds
    through the shared builder, ``native/build.py``.)"""
    monkeypatch.setattr(NC, "_lib", None)
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(NB.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NC.g1_msm([g1_generator()], [1])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        groth16.setup(tiny_r1cs(R1CS), rng=random.Random(1))
    monkeypatch.setattr(NB.shutil, "which", lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="failed"):
        NC.load()
    assert not list(tmp_path.glob("*.so"))


# -- Groth16 on the JAX package's tiny R1CS -----------------------------------


def tiny_r1cs(cls):
    """tests/test_recursion.py's x * y = z, x + y = s with x public, on
    ``cls`` (either package's R1CS); z layout [1, x, y, z, s]."""
    r = cls()
    x, y, z, s = (r.new_witness() for _ in range(4))
    r.add_constraint([(1, x)], [(1, y)], [(1, z)])
    r.add_constraint([(1, x), (1, y)], [(1, 0)], [(1, s)])
    r.num_public_inputs = 1
    return r


@pytest.mark.parametrize("committed", (None, [3]))
def test_groth16_matches_jax(committed):
    z = [1, 3, 7, 21, 10]
    keys = groth16.setup(tiny_r1cs(R1CS), rng=random.Random(42),
                         committed=committed)
    jkeys = jgroth16.setup(tiny_r1cs(JR1CS), rng=random.Random(42),
                           committed=committed)
    assert vars(keys) == vars(jkeys)
    proof = groth16.prove(keys, tiny_r1cs(R1CS), z, rng=random.Random(43))
    jproof = jgroth16.prove(jkeys, tiny_r1cs(JR1CS), z,
                            rng=random.Random(43))
    assert vars(proof) == vars(jproof)
    assert groth16.verify(keys, proof, [3])
    assert not groth16.verify(keys, proof, [4])


# -- the wrapper circuit ------------------------------------------------------


@pytest.fixture(scope="module")
def inner():
    """The inner proof of tests/test_verifier_circuit.py (security 3): the
    port's (R1CS, scheme, proof) and the JAX package's scheme."""
    from tests.test_e2e import build_system
    r1cs, witness = chip_smoke.build_tiny_system(seed=3, n_mults=1)
    scheme = chip_smoke.tiny_scheme(r1cs, CPU, security=3, folding=2,
                                    max_pow=0)
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    scheme.verify(r1cs, proof)
    jr1cs, _ = build_system(seed=3, n_mults=1)
    return r1cs, scheme, proof, jr1cs, jtiny_scheme(jr1cs)


def satisfied(r1cs, values) -> bool:
    return r1cs.is_satisfied(V.pack([F.to_mont(v) for v in values], CPU))


def test_wrapper_matches_jax(inner):
    r1cs, scheme, proof, jr1cs, jscheme = inner
    b = wrap.build_verifier_circuit(scheme, r1cs, proof)
    jb = jwrap.build_verifier_circuit(jscheme, jr1cs, proof)
    assert b.values == jb.values
    assert b.constraints == jb.constraints
    assert b.num_public == jb.num_public
    assert b.lookups.committed == jb.lookups.committed
    scalars, _ = split_transcript(scheme.create_io_pattern(), proof)
    assert b.num_public == len(scalars) + 2
    w, z = b.build()
    jw, jz = jb.build()
    assert z == jz
    assert (w.num_constraints, w.num_witnesses, w.num_public_inputs) == \
        (jw.num_constraints, jw.num_witnesses, jw.num_public_inputs)
    for m, jm in zip((w.a, w.b, w.c), (jw.a, jw.b, jw.c)):
        assert (m.rows, m.cols, m.value_ids, m.num_rows, m.num_cols) == \
            (jm.rows, jm.cols, jm.value_ids, jm.num_rows, jm.num_cols)
    assert w.interner.values == jw.interner.values
    assert satisfied(w, z)


def test_wrapper_rejects_tampered_proof(inner):
    """A flipped byte of the first committed root: the synthesis fails, or
    a row of the wrapper is violated (``debug_assert`` checks each row as
    it is emitted)."""
    r1cs, scheme, proof, _, _ = inner
    bad = bytearray(proof)
    bad[0] ^= 1
    with pytest.raises((WhirError, ValueError, AssertionError)):
        wrap.build_verifier_circuit(scheme, r1cs, bytes(bad),
                                    debug_assert=True)


def test_tampered_claimed_sums_hint(inner):
    """The trailing bytes are the deferred_weight_evaluations hint, which
    the circuit recomputes and ignores: the host verifier rejects the
    proof, and the wrapper either fails at synthesis or stays satisfied,
    every row checked as it is emitted
    (tests/test_verifier_circuit.py::test_tampered_claimed_sums_hint)."""
    r1cs, scheme, proof, _, _ = inner
    bad = bytearray(proof)
    bad[-20] ^= 1
    with pytest.raises((WhirError, ValueError, AssertionError)):
        scheme.verify(r1cs, bytes(bad))
    try:
        b = wrap.build_verifier_circuit(scheme, r1cs, bytes(bad),
                                        debug_assert=True)
    except (WhirError, ValueError):
        return
    assert b.num_constraints > 0


@pytest.mark.slow
def test_wrap_end_to_end_matches_jax(inner):
    """The whole seeded wrap in both packages: equal keys, proof and
    publics; verify accepts, and rejects a changed public input."""
    r1cs, scheme, proof, jr1cs, jscheme = inner
    rk = wrap.setup(scheme, r1cs, proof, rng=random.Random(1))
    jrk = jwrap.setup(jscheme, jr1cs, proof, rng=random.Random(1))
    assert vars(rk.keys) == vars(jrk.keys)
    g16, publics = wrap.prove(rk, scheme, r1cs, proof, rng=random.Random(2))
    jg16, jpublics = jwrap.prove(jrk, jscheme, jr1cs, proof,
                                 rng=random.Random(2))
    assert (vars(g16), publics) == (vars(jg16), jpublics)
    assert wrap.verify(rk, g16, publics)
    bad = list(publics)
    bad[0] = (bad[0] + 1) % JF.P
    assert not wrap.verify(rk, g16, bad)


@pytest.mark.slow
def test_circuit_multi_query_rounds_with_duplicates():
    """tests/test_verifier_circuit.py's duplicates case (security 20: the
    round-0 queries collide) on the port alone: debug_assert checks every
    row against the assignment as it is emitted."""
    r1cs, witness = chip_smoke.build_tiny_system(seed=5, n_mults=8)
    scheme = chip_smoke.tiny_scheme(r1cs, CPU, security=20, folding=2,
                                    max_pow=0)
    proof = scheme.prove(r1cs, witness, rng=random.Random(21))
    scheme.verify(r1cs, proof)
    b = wrap.build_verifier_circuit(scheme, r1cs, proof, debug_assert=True)
    assert b.num_constraints > 0


@pytest.mark.slow
def test_cli_recursive_verify_with_cached_keys(tmp_path, capsys):
    """``recursive-verify --keys`` on the CPU: the first run writes the
    keys, the second loads them; both print OK, and a flipped transcript
    byte fails."""
    from provekit_tpu_torch import cli
    fixture = pathlib.Path(__file__).parent / "fixtures" / "mul_chain.json"
    nps, np_, keys = (tmp_path / n for n in ("s.nps", "p.np", "k.pkl"))
    toml = tmp_path / "Prover.toml"
    toml.write_text(chip_smoke.prover_toml({"x": 6, "y": 7}))
    cpu = ["--device", "cpu"]
    cli.main(["prepare", str(fixture), "-o", str(nps), "--security", "3",
              "--max-pow-bits", "0", *cpu])
    cli.main(["prove", str(nps), str(toml), "-o", str(np_), *cpu])
    argv = ["recursive-verify", str(nps), str(np_), "--keys", str(keys),
            *cpu]
    cli.main(argv)
    assert keys.exists()
    cli.main(argv)
    out = capsys.readouterr().out
    assert out.count("recursive verification: OK") == 2
    assert "groth16_setup" in out and "load_keys" in out
    bad = tmp_path / "bad.np"
    chip_smoke.flip_byte(np_, bad)
    with pytest.raises((AssertionError, ValueError, WhirError, SystemExit)):
        cli.main(["recursive-verify", str(nps), str(bad), "--keys",
                  str(keys), *cpu])
