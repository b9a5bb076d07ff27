"""The torch port's compiler, witness solve and R1CS matvecs against the JAX
package's, exactly, on a two-hash Poseidon2 chain."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.circuits import poseidon as JPOS
from provekit_tpu.compiler import NoirProofScheme as JScheme
from provekit_tpu.fields import vector as JV
from provekit_tpu_torch import convert
from provekit_tpu_torch.acir import model as acir
from provekit_tpu_torch.circuits import poseidon
from provekit_tpu_torch.compiler import NoirProofScheme
from provekit_tpu_torch.compiler.noir_to_r1cs import noir_to_r1cs
from provekit_tpu_torch.fields import vector as V

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def schemes():
    program, values, out = poseidon.hash_chain_circuit(2)
    jprogram, jvalues, jout = JPOS.hash_chain_circuit(2)
    assert (values, out) == (jvalues, jout)
    port = NoirProofScheme.from_program(program, device=CPU)
    ref = JScheme.from_program(jprogram)
    return port, ref, values


def test_compile_matches_jax(schemes):
    port, ref, _ = schemes
    assert convert.r1cs_to_coo(port.r1cs) == convert.r1cs_to_coo(ref.r1cs)
    assert port.acir_map == ref.acir_map
    assert (convert.scheme_fields(port.whir_for_witness)
            == convert.scheme_fields(ref.whir_for_witness))


def test_solve_witness_matches_jax(schemes):
    port, ref, values = schemes
    got = port.solve_witness(values, rng=random.Random(1))
    want = ref.solve_witness(values, rng=random.Random(1))
    assert got == want
    z = V.to_mont(V.pack(got, CPU))
    assert port.r1cs.is_satisfied(z) and port.r1cs.check_z0(z)


def test_matvecs_match_jax(schemes):
    port, ref, values = schemes
    w = port.solve_witness(values, rng=random.Random(2))
    rng = np.random.default_rng(3)
    e = rng.integers(0, 1 << 16, size=(16, port.r1cs.num_constraints),
                     dtype=np.int64)
    e[15] %= 0x3064
    e = e.astype(np.uint32)
    z = np.asarray(JV.to_mont(JV.pack(w)))
    for mat, jmat in ((port.r1cs.a, ref.r1cs.a), (port.r1cs.b, ref.r1cs.b),
                      (port.r1cs.c, ref.r1cs.c)):
        right = mat.mul_right(convert.planes_to_torch(z, CPU))
        assert np.array_equal(convert.planes_to_numpy(right),
                              np.asarray(jmat.mul_right(jnp.asarray(z))))
        left = mat.mul_left(convert.planes_to_torch(e, CPU))
        assert np.array_equal(convert.planes_to_numpy(left),
                              np.asarray(jmat.mul_left(jnp.asarray(e))))
    got = port.r1cs.witness_bounds(convert.planes_to_torch(z, CPU))
    want = ref.r1cs.witness_bounds(jnp.asarray(z))
    for g, w_ in zip(got, want):
        assert np.array_equal(convert.planes_to_numpy(g), np.asarray(w_))


def test_unported_opcode_raises():
    # every opcode the JAX package lowers now lowers in the port too; a
    # black box it does not lower raises as there
    circuit = acir.Circuit(
        opcodes=[acir.BlackBoxUnsupported("keccakf1600")],
        current_witness_index=1)
    with pytest.raises(NotImplementedError, match="keccakf1600"):
        noir_to_r1cs(circuit)
