"""The torch port end to end on the CPU.

The tiny scheme of ``tests/test_device_fs.py::test_proof_bytes_regression``
(the JAX package's circuit and parameters, handed over with
``provekit_tpu_torch.convert``) must prove to the JAX package's pinned
digest, and a two-hash Poseidon2 chain proves and verifies through the
port's front door.  A Poseidon2 chain of ``CHAIN_HASHES`` hashes at
security 128 proves to the same bytes in both packages from one seeded
``random.Random``, and each package's verifier accepts the other's proof
and rejects it with one byte flipped (``slow``: ``pytest -m slow
tests/test_torch_e2e.py``).
"""

import hashlib
import random

import pytest
import torch

from provekit_tpu_torch import convert
from provekit_tpu_torch.circuits import poseidon
from provekit_tpu_torch.compiler import NoirProofScheme
from provekit_tpu_torch.whir.verifier import WhirError
from tests.test_e2e import build_system
from tests.test_verifier_circuit import tiny_scheme

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CHAIN_HASHES = 32
PINNED = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    jr1cs, witness = build_system(seed=3, n_mults=1)
    jscheme = tiny_scheme(jr1cs, security=3, folding=2, max_pow=2)
    r1cs = convert.r1cs_from_coo(convert.r1cs_to_coo(jr1cs))
    scheme = convert.scheme_from_fields(convert.scheme_fields(jscheme), CPU)
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    return scheme, r1cs, proof


def test_tiny_proof_matches_pinned_digest(tiny):
    _, _, proof = tiny
    assert hashlib.sha256(proof).hexdigest() == PINNED


def test_tiny_verify_and_tamper(tiny):
    scheme, r1cs, proof = tiny
    scheme.verify(r1cs, proof)
    for pos in [8, len(proof) // 2, len(proof) - 33]:
        bad = bytearray(proof)
        bad[pos] ^= 1
        with pytest.raises((WhirError, ValueError)):
            scheme.verify(r1cs, bytes(bad))


def test_poseidon_chain_front_door():
    program, values, _ = poseidon.hash_chain_circuit(2)
    scheme = NoirProofScheme.from_program(program, security_level=16,
                                          max_pow_bits=4, device=CPU)
    proof = scheme.prove(values, rng=random.Random(5))
    scheme.verify(proof)
    bad = bytearray(proof.transcript)
    bad[len(bad) // 2] ^= 1
    proof.transcript = bytes(bad)
    with pytest.raises((WhirError, ValueError)):
        scheme.verify(proof)


@pytest.mark.slow
def test_poseidon_chain_proof_is_jax_bytes(monkeypatch):
    from provekit_tpu import config
    from provekit_tpu.circuits import poseidon as jposeidon
    from provekit_tpu.compiler import NoirProof as JProof
    from provekit_tpu.compiler import NoirProofScheme as JScheme
    from provekit_tpu.ops import ntt as jntt
    from provekit_tpu.ops import sumcheck as jsumcheck
    from provekit_tpu.parallel import make_mesh
    from provekit_tpu.whir.verifier import WhirError as JWhirError
    from provekit_tpu_torch.compiler import NoirProof

    # the JAX package's CPU proves as tests/test_acir_fixtures.py runs them:
    # host tails and a one-device mesh (the per-round sumcheck path), so
    # that no fused segment compiles for this circuit's geometry
    monkeypatch.setattr(config, "CHEAP_SYNC", True)
    monkeypatch.setattr(jsumcheck, "HOST_TAIL",
                        max(jsumcheck.HOST_TAIL, 1 << 16))
    monkeypatch.setattr(jntt, "HOST_TAIL", max(jntt.HOST_TAIL, 1 << 16))
    program, values, _ = poseidon.hash_chain_circuit(CHAIN_HASHES)
    jprogram, jvalues, _ = jposeidon.hash_chain_circuit(CHAIN_HASHES)
    assert values == jvalues
    port = NoirProofScheme.from_program(program, security_level=128,
                                        device=CPU)
    ref = JScheme.from_program(jprogram, security_level=128)
    proof = port.prove(values, rng=random.Random(17)).transcript
    rng = random.Random(17)
    jwitness = ref.solve_witness(jvalues, rng)
    jproof = ref.whir_for_witness.prove(ref.r1cs, jwitness, rng,
                                        mesh=make_mesh(1))
    assert proof == jproof
    port.verify(NoirProof(transcript=jproof))
    ref.verify(JProof(transcript=proof))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    with pytest.raises((WhirError, ValueError)):
        port.verify(NoirProof(transcript=bytes(bad)))
    with pytest.raises((JWhirError, ValueError)):
        ref.verify(JProof(transcript=bytes(bad)))
