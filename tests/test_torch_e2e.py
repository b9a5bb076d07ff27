"""The torch port end to end on the CPU.

The tiny scheme of ``tests/test_device_fs.py::test_proof_bytes_regression``
(the JAX package's circuit and parameters, handed over with
``provekit_tpu_torch.convert``) must prove to the JAX package's pinned
digest, and a two-hash Poseidon2 chain proves and verifies through the
port's front door.
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
