"""The port's p256 and passport circuits against the JAX package's, exactly.

Each circuit is built by both packages from the same inputs.  Both give the
same program (compared as ``io.files._enc`` documents, whose type tags the
packages share) and the same ACIR values; the port's compiler gives the same
R1CS (COO triplets), ACIR map and witness builders as the JAX package's, and
the port's Python solve the same witness as the JAX package's solve (its
native solver where built, which its own tests hold to its Python solve)
under the same seeded ``rng``; the passport's ``.nps`` body is the JAX
package's bytes.  The port's witness of each p256 circuit satisfies its
R1CS on the CPU, and each rejection case of ``tests/test_p256.py`` and
``tests/test_passport.py`` is rejected by both packages alike.
"""

import random

import pytest
import torch

from provekit_tpu.acir import model as JM
from provekit_tpu.circuits import p256 as JP
from provekit_tpu.circuits import passport as JPP
from provekit_tpu.compiler import NoirProofScheme as JScheme
from provekit_tpu.io import binenc as jbinenc
from provekit_tpu.io import files as jfiles
from provekit_tpu_torch import convert
from provekit_tpu_torch.acir import model as TM
from provekit_tpu_torch.circuits import p256 as TP
from provekit_tpu_torch.circuits import passport as TPP
from provekit_tpu_torch.compiler import NoirProofScheme
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.io import binenc
from provekit_tpu_torch.io import files as tfiles

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
G = (TP.P256_GX, TP.P256_GY)


def wrap(M, b):
    c = M.Circuit(opcodes=b.opcodes, private_parameters=[],
                  return_values=[], current_witness_index=b.next_witness)
    return M.Program(functions=[c])


def same_program(program, jprogram, values, jvalues):
    assert tfiles._enc(program) == jfiles._enc(jprogram)
    assert values == jvalues


def compiles_and_solves_like_jax(program, jprogram, values, seed,
                                 check_satisfied=True):
    """The port's scheme of ``program``, after checking its R1CS, map,
    builders (as their dataclass reprs, which name each class and field)
    and solved witness against the JAX package's; returns both schemes."""
    port = NoirProofScheme.from_program(program, security_level=30,
                                        max_pow_bits=6, device=CPU)
    ref = JScheme.from_program(jprogram, security_level=30, max_pow_bits=6)
    assert convert.r1cs_to_coo(port.r1cs) == convert.r1cs_to_coo(ref.r1cs)
    assert port.acir_map == ref.acir_map
    assert repr(port.witness_builders) == repr(ref.witness_builders)
    witness = port.solve_witness(values, rng=random.Random(seed))
    assert witness == ref.solve_witness(values, rng=random.Random(seed))
    if check_satisfied:
        assert satisfied(port, witness)
    return port, ref


def satisfied(scheme, witness) -> bool:
    z = V.to_mont(V.pack(witness, CPU))
    return scheme.r1cs.check_z0(z) and scheme.r1cs.is_satisfied(z)


def rejected_alike(build):
    """``build(package)`` raises AssertionError in both packages."""
    for pkg in (TP, JP):
        with pytest.raises(AssertionError):
            build(pkg)


# -- p256 ---------------------------------------------------------------------


def test_host_curve_math_matches_jax():
    for name in ("P256_P", "P256_N", "P256_A", "P256_B", "P256_GX",
                 "P256_GY", "K_POINT", "LB", "LIMB_BITS"):
        assert getattr(TP, name) == getattr(JP, name), name
    rng = random.Random(1)
    for k in (1, 2, 3, 5, TP.P256_N - 1, rng.randrange(TP.P256_N)):
        assert TP.ec_mul(k, G) == JP.ec_mul(k, G)
        assert TP.limbs_of(k) == JP.limbs_of(k)
    assert TP.ec_add(TP.ec_mul(2, G), TP.ec_mul(3, G)) == TP.ec_mul(5, G)
    assert TP.ec_mul(TP.P256_N, G) is None
    assert TP.ec_add(G, TP.ec_neg(G)) == JP.ec_add(G, JP.ec_neg(G))
    x, y = TP.K_POINT
    assert (y * y - (x ** 3 + TP.P256_A * x + TP.P256_B)) % TP.P256_P == 0
    assert TP.ecdsa_test_vector(seed=4) == JP.ecdsa_test_vector(seed=4)


def nn_mul(P, M):
    rng = random.Random(1)
    b = P.Builder()
    fp = P.NNContext(b, P.P256_P)
    a_v, b_v = rng.randrange(P.P256_P), rng.randrange(P.P256_P)
    a, bb = fp.witness(a_v), fp.witness(b_v)
    r = fp.mul(a, bb)
    lin = fp.linear([(2, a), (-1, bb)], 7)
    assert fp.value(r) == a_v * b_v % P.P256_P
    assert fp.value(lin) == (2 * a_v - b_v + 7) % P.P256_P
    return wrap(M, b), dict(b.values), r.limbs[0].index


def test_nn_mul_gadget_matches_jax():
    program, values, limb = nn_mul(TP, TM)
    jprogram, jvalues, _ = nn_mul(JP, JM)
    same_program(program, jprogram, values, jvalues)
    port, ref = compiles_and_solves_like_jax(program, jprogram, values, 5)
    # a corrupted product limb solves alike and is unsatisfied
    bad = {**values, limb: (values[limb] + 1) % F.P}
    witness = port.solve_witness(bad, rng=random.Random(6))
    assert witness == ref.solve_witness(bad, rng=random.Random(6))
    assert not satisfied(port, witness)


def canonicalize(P, M):
    b = P.Builder()
    fp = P.NNContext(b, P.P256_P)
    fn = P.NNContext(b, P.P256_N)
    v = P.P256_N + 12345
    ac = fp.canonicalize(fp.witness(v))
    assert fp.value(ac) == v
    rc = fn.canonicalize(fn.witness(v - P.P256_N))
    fp.assert_canonical_eq_mod(ac, rc, P.P256_N)
    return wrap(M, b), dict(b.values)


def test_nn_canonicalize_and_eq_mod_match_jax():
    program, values = canonicalize(TP, TM)
    jprogram, jvalues = canonicalize(JP, JM)
    same_program(program, jprogram, values, jvalues)
    compiles_and_solves_like_jax(program, jprogram, values, 5)


def test_ecdsa_verify_nbits_6_matches_jax():
    vec = TP.ecdsa_test_vector(seed=2, nbits=6)
    assert vec == JP.ecdsa_test_vector(seed=2, nbits=6)
    program, values = TP.ecdsa_verify_circuit(*vec, nbits=6)
    jprogram, jvalues = JP.ecdsa_verify_circuit(*vec, nbits=6)
    same_program(program, jprogram, values, jvalues)
    compiles_and_solves_like_jax(program, jprogram, values, 5)


def test_ecdsa_rejects_bad_signature_like_jax():
    pub, r, s, h = TP.ecdsa_test_vector(seed=3, nbits=6)
    rejected_alike(lambda P: P.ecdsa_verify_circuit(
        pub, r, (s + 1) % P.P256_N, h, nbits=6))


# -- passport -----------------------------------------------------------------


def test_passport_test_vector_matches_jax():
    """seed 1 with its signature: the bytes the card's passport run proves."""
    assert TPP.passport_test_vector(seed=1) == JPP.passport_test_vector(seed=1)


def test_passport_without_signature_matches_jax():
    vec = TPP.passport_test_vector(seed=2, with_signature=False)
    assert vec == JPP.passport_test_vector(seed=2, with_signature=False)
    dg1, sod, off, date, age, _ = vec
    program, values = TPP.passport_circuit(dg1, sod, off, date, age)
    jprogram, jvalues = JPP.passport_circuit(dg1, sod, off, date, age)
    same_program(program, jprogram, values, jvalues)
    # the JAX package's tests/test_passport.py checks that this witness (the
    # same seeds) satisfies its R1CS, which equals the port's
    port, ref = compiles_and_solves_like_jax(program, jprogram, values, 7,
                                             check_satisfied=False)
    # the body of its .nps file is the JAX package's, byte for byte
    assert binenc.encode(tfiles.scheme_to_doc(port)) == \
        jbinenc.encode(jfiles.scheme_to_doc(ref))


@pytest.mark.parametrize("case", ["digest_placement", "underage", "expired"])
def test_passport_rejections_match_jax(case):
    seed = {"digest_placement": 3, "underage": 4, "expired": 5}[case]
    dg1, sod, off, date, age, _ = TPP.passport_test_vector(
        seed=seed, with_signature=False)
    args = {"digest_placement": (dg1, sod, off + 1, date, age),
            "underage": (dg1, sod, off, date, 40),
            "expired": (dg1, sod, off, "20310101", age)}[case]
    rejected_alike(lambda P: (TPP if P is TP else JPP).passport_circuit(
        *args))


def test_century_window_bit_matches_jax():
    for P, PP in ((TP, TPP), (JP, JPP)):
        b = P.Builder()
        for a_v, b_v, expect in [(90, 26, 1), (10, 26, 0), (26, 26, 0)]:
            aw, bw = b.new_witness(a_v), b.new_witness(b_v)
            assert b.val(PP.gt_bit(b, aw, bw, 7)) == expect
