"""The port's native host library (``provekit_tpu_torch/native``) against
the Python code it replaces and against the JAX package's, exactly.

``native.permute`` and ``compress`` equal both packages' Python Skyscraper
on edge values and seeded pairs; the library's inverse (batched divsteps
on the limbs) equals ``pow(a, -1, P)``; the port's encoder writes the JAX
encoder's bytes for every compiler gadget and for poseidon2 x10, and each
package's library solves the other's bytes; the native solve equals the
port's plain solve and the JAX package's Python solve on every gadget, its
bad inputs included, and on sha256 x1; the Merkle path check equals
``verify_path_plain`` on a CPU tree; the PoW checks equal ``solve_dev`` and
the JAX package's host solver.  The tiny scheme still proves to its pinned
digest and verifies; by default nothing of it reaches the Python solve or
the Python permutation; a library that cannot be built raises, and nothing
falls back.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

import chip_smoke
from provekit_tpu import native as jnative
from provekit_tpu.circuits import poseidon as jposeidon
from provekit_tpu.compiler import NoirProofScheme as JScheme
from provekit_tpu.hash import skyscraper as JS
from provekit_tpu.native.encode import encode_program as jencode_program
from provekit_tpu.ops import pow as jpow
from provekit_tpu_torch import native
from provekit_tpu_torch.circuits import poseidon, sha256
from provekit_tpu_torch.compiler import NoirProofScheme
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.hash import skyscraper as S
from provekit_tpu_torch.native import build as NB
from provekit_tpu_torch.native.encode import encode_program
from provekit_tpu_torch.ops import merkle, pow as pow_ops
from provekit_tpu_torch.r1cs import witness_builder as wb
from tests.test_torch_compiler import GADGETS, RAISES, both

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 20261016
PINNED = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"


def seeded_values(n: int, seed: int = SEED) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]


def schemes(gadget):
    """(port scheme, JAX scheme, values, negative cases) of one gadget."""
    program, jprogram, vals, bad = both(gadget)
    return (NoirProofScheme.from_program(program, security_level=30,
                                         max_pow_bits=6, device=CPU),
            JScheme.from_program(jprogram, security_level=30,
                                 max_pow_bits=6), vals, bad)


# -- Skyscraper and the inverse ----------------------------------------------


def test_permute_and_compress_match_python():
    edge = S.edge_values(SEED)
    pairs = [(l, r) for l in edge for r in edge]
    vals = seeded_values(200)
    pairs += list(zip(vals[0::2], vals[1::2]))
    for l, r in pairs:
        assert native.permute(l, r) == S.permute(l, r) == JS.permute(l, r)
        assert native.compress(l, r) == S.compress(l, r) == JS.compress(l, r)


def inverse(a: int) -> int:
    """The library's inverse of ``a``, through a solve of one Inverse
    builder."""
    prog = encode_program([wb.Constant(0, a), wb.Inverse(1, 0)])
    return native.solve_witness(prog, {}, 2, bytes(32), [])[1]


@pytest.mark.parametrize("a", [1, 2, 3, F.P - 1, F.P - 2, 1 << 253,
                               (1 << 253) - 1, 1 << 64, F.R, F.P // 2],
                         ids=lambda a: hex(a)[:12])
def test_inverse_edge_values(a):
    assert inverse(a) == pow(a, -1, F.P) == F.inv(a)


def test_inverse_seeded_and_zero():
    rng = random.Random(SEED)
    vals = seeded_values(3000) + [1 << k for k in range(254)]
    vals += [rng.randrange(1, 1 << 64) for _ in range(300)]
    vals += [F.P - rng.randrange(1, 1 << 64) for _ in range(300)]
    for a in vals:
        assert inverse(a) == pow(a, -1, F.P), a
    for zero in (0, F.P):
        with pytest.raises(ZeroDivisionError, match="builder 1"):
            inverse(zero)


# -- the program encoding ----------------------------------------------------


@pytest.mark.parametrize("gadget", GADGETS, ids=lambda g: g.__name__)
def test_encoder_matches_jax(gadget):
    port, ref, _, _ = schemes(gadget)
    assert encode_program(port.witness_builders) == \
        jencode_program(ref.witness_builders)


def test_encoder_matches_jax_on_poseidon2_x10():
    from provekit_tpu.compiler import noir_to_r1cs as jnoir_to_r1cs
    from provekit_tpu_torch.compiler import noir_to_r1cs
    program, _, _ = poseidon.hash_chain_circuit(10)
    jprogram, _, _ = jposeidon.hash_chain_circuit(10)
    builders = noir_to_r1cs(program.functions[0])[2]
    jbuilders = jnoir_to_r1cs(jprogram.functions[0])[2]
    assert encode_program(builders) == jencode_program(jbuilders)


def test_encoder_refuses_unknown_builders():
    with pytest.raises(TypeError):
        encode_program([object()])


# -- the native solve --------------------------------------------------------


@pytest.mark.parametrize("gadget", GADGETS, ids=lambda g: g.__name__)
def test_native_solve_matches_plain(gadget):
    port, ref, vals, bad = schemes(gadget)
    cases = [(vals, None)] + [({**vals, **change}, outcome)
                              for change, outcome in bad]
    for values, outcome in cases:
        if outcome == RAISES:
            # the range's multiplicity table has no slot for the value
            with pytest.raises(RuntimeError, match="code 4, range"):
                port.solve_witness(values, rng=random.Random(6))
            with pytest.raises((ValueError, IndexError)):
                port.solve_witness(values, rng=random.Random(6),
                                   use_native=False)
            continue
        got = port.solve_witness(values, rng=random.Random(6))
        assert got == port.solve_witness(values, rng=random.Random(6),
                                         use_native=False)
        assert got == ref.solve_witness(values, rng=random.Random(6),
                                        use_native=False)


def test_native_solve_matches_plain_on_sha256():
    program, values, _ = sha256.chain_circuit(1)
    scheme = NoirProofScheme.from_program(program, device=CPU)
    witness = scheme.solve_witness(values, rng=random.Random(5))
    assert witness == scheme.solve_witness(values, rng=random.Random(5),
                                           use_native=False)


@pytest.mark.parametrize("gadget", GADGETS, ids=lambda g: g.__name__)
def test_libraries_solve_each_others_programs(gadget):
    port, ref, vals, _ = schemes(gadget)
    n = port.r1cs.num_witnesses
    iv = port.create_witness_io_pattern().iv()
    assert iv == ref.create_witness_io_pattern().iv()
    seeds = port._witness_seed_scalars(vals)
    assert seeds == ref._witness_seed_scalars(vals)
    port_bytes = encode_program(port.witness_builders)
    jax_bytes = jencode_program(ref.witness_builders)
    want = jnative.solve_witness(jax_bytes, vals, n, iv, seeds)
    assert native.solve_witness(jax_bytes, vals, n, iv, seeds) == want
    assert jnative.solve_witness(port_bytes, vals, n, iv, seeds) == want


def test_solve_errors_name_their_code_and_builder():
    iv = bytes(32)
    zero_inverse = encode_program([wb.Constant(0, 0), wb.Inverse(1, 0)])
    with pytest.raises(ZeroDivisionError, match="builder 1"):
        native.solve_witness(zero_inverse, {}, 2, iv, [])
    with pytest.raises(ZeroDivisionError):
        wb.solve([wb.Constant(0, 0), wb.Inverse(1, 0)], {}, 2, None)
    cases = [
        (b"\xff", 1, "unknown opcode", 0),
        (encode_program([wb.Constant(0, 1), wb.Constant(5, 1)]), 2,
         "witness index out of range", 1),
        (encode_program([wb.Acir(0, 7)]), 3, "ACIR witness missing", 0),
        (encode_program([wb.Constant(0, 1), wb.Product(1, 0, 0)])[:-2], 9,
         "truncated program", 1),
    ]
    for prog, code, meaning, builder in cases:
        with pytest.raises(RuntimeError) as err:
            native.solve_witness(prog, {}, 2, iv, [])
        assert f"code {code}, {meaning}, at witness builder {builder}" in \
            str(err.value)
    assert native.solve_witness(encode_program([wb.Constant(1, 5)]), {}, 3,
                                iv, []) == [None, 5, None]


# -- Merkle paths and proof of work ------------------------------------------


def test_merkle_verify_matches_plain():
    vals = seeded_values(3 * 16)
    leaves = V.pack(vals, CPU).reshape(16, 16, 3).permute(0, 2, 1)
    tree = merkle.commit_dev(leaves.contiguous())
    root = tree.root()
    paths = tree.open(list(range(16)))
    for i, path in enumerate(paths):
        leaf = vals[3 * i:3 * i + 3]
        assert leaf == V.unpack(leaves[:, :, i])
        assert merkle.verify_path(root, leaf, i, path)
        assert merkle.verify_path_plain(root, leaf, i, path)
        for wrong in ((root, leaf, i ^ 1, path), (root, leaf, i ^ 4, path),
                      (root, leaf, i, path[:1] + [path[1] ^ 1] + path[2:]),
                      (root, [leaf[0] ^ 1] + leaf[1:], i, path),
                      ((root + 1) % F.P, leaf, i, path)):
            assert not merkle.verify_path(*wrong)
            assert not merkle.verify_path_plain(*wrong)


@pytest.mark.parametrize("bits", [1.0, 3.0, 5.5])
def test_pow_host_solver_matches_device_and_jax(bits):
    challenge = seeded_values(1, seed=int(bits * 10))[0]
    nonce = pow_ops.solve_host_sequential(challenge, bits)
    assert nonce == jpow.solve_host_sequential(challenge, bits)
    dev_nonce = pow_ops.solve_dev(V.pack([challenge], CPU), bits)
    assert V.unpack(dev_nonce) == [nonce]
    assert pow_ops.verify(challenge, bits, nonce)
    assert pow_ops.verify(challenge, bits, nonce) == jpow.verify(
        challenge, bits, nonce)
    thresh = pow_ops.threshold(bits)
    for n in range(nonce + 3):
        assert pow_ops.verify(challenge, bits, n) == (
            S.compress(challenge, n) < thresh)
    assert pow_ops.solve_host_sequential(challenge, 0.0) == 0


# -- end to end, the defaults, no fallback -----------------------------------


def test_tiny_scheme_proves_and_verifies_natively(monkeypatch):
    """With the Python solve and the Python permutation (under compress
    too) raising, the tiny scheme proves to its pinned digest, verifies
    through the host library, rejects flipped bytes, and a gadget's witness
    still solves."""
    r1cs, witness = chip_smoke.build_tiny_system(seed=3, n_mults=1)
    scheme = chip_smoke.tiny_scheme(r1cs, CPU)

    def python_ran(*args):
        raise AssertionError("the plain Python version ran")

    monkeypatch.setattr(wb, "solve", python_ran)
    monkeypatch.setattr(S, "permute", python_ran)
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    assert hashlib.sha256(proof).hexdigest() == PINNED
    scheme.verify(r1cs, proof)
    chip_smoke.expect_rejected(scheme, r1cs, proof,
                               [8, len(proof) // 2, len(proof) - 33])
    port, _, vals, _ = schemes(GADGETS[3])
    assert len(port.solve_witness(vals, rng=random.Random(5))) == \
        port.r1cs.num_witnesses
    with pytest.raises(AssertionError, match="plain Python"):
        port.solve_witness(vals, rng=random.Random(5), use_native=False)


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(NB.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.permute(1, 2)
    port, _, vals, _ = schemes(GADGETS[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        port.solve_witness(vals)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        merkle.verify_path(0, [1, 2], 0, [3])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pow_ops.verify(1, 2.0, 3)
    monkeypatch.setattr(NB.shutil, "which", lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
