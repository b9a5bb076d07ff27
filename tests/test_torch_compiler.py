"""The torch port's ACIR compiler gadgets and witness solve against the JAX
package's, exactly.

Each gadget program of ``tests/test_compiler.py`` (assert-zero, several
products, ROM, RAM, predicated memory, range checks: naive, u8 lookup, u16
and u12 mixed-base decomposition) is built identically with both packages'
``acir.model``.  Both compile to the same R1CS (A, B, C as COO triplets),
the same ACIR -> R1CS map and the same witness-builder program, and both
Python solves give the same witness under ``random.Random(5)``.  The port's
solved witness satisfies its R1CS; each negative case of the JAX tests stays
negative.  The sha256 circuit of one block compiles the same in both; its
witness comparison (a 2^16-entry AND/XOR table solved in Python on each
side) is ``slow``.
"""

import dataclasses
import inspect
import random

import pytest
import torch

from provekit_tpu.acir import model as jacir
from provekit_tpu.circuits import sha256 as JSHA
from provekit_tpu.compiler import NoirProofScheme as JScheme
from provekit_tpu.compiler import noir_to_r1cs as jnoir_to_r1cs
from provekit_tpu_torch import convert
from provekit_tpu_torch.acir import model as acir
from provekit_tpu_torch.circuits import sha256
from provekit_tpu_torch.compiler import NoirProofScheme, noir_to_r1cs
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.protocol import WhirR1CSScheme

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
UNSAT = "unsatisfied"
RAISES = "raises"


# -- the gadget programs of tests/test_compiler.py, over either acir module --


def assert_zero(A):
    w = A.Witness
    c = A.Circuit(opcodes=[
        A.AssertZero(A.Expression(mul_terms=[(1, w(0), w(1))],
                                  linear_combinations=[(F.P - 1, w(2))])),
        A.AssertZero(A.Expression(
            linear_combinations=[(1, w(0)), (1, w(1)), (F.P - 1, w(3))])),
    ], private_parameters=[0, 1], return_values=[2, 3])
    return c, {0: 3, 1: 7, 2: 21, 3: 10}, [({2: 22}, UNSAT)]


def assert_zero_multi_mul(A):
    w = A.Witness
    x, y = 5, 4
    zval = -(2 * x * y + x - 9) * pow(3 * y - 5 * x, F.P - 2, F.P) % F.P
    c = A.Circuit(opcodes=[A.AssertZero(A.Expression(
        mul_terms=[(2, w(0), w(1)), (3, w(1), w(2)), (F.P - 5, w(0), w(2))],
        linear_combinations=[(1, w(0))], q_c=F.P - 9))])
    return c, {0: x, 1: y, 2: zval}, []


def rom(A):
    w = A.Witness
    c = A.Circuit(opcodes=[
        A.MemoryInit(block_id=0, init=[w(0), w(1), w(2)]),
        A.MemoryOp(0, A.MemOp(0, A.Expression.from_witness(w(3)),
                              A.Expression.from_witness(w(4)))),
        A.MemoryOp(0, A.MemOp(0, A.Expression.from_witness(w(5)),
                              A.Expression.from_witness(w(6)))),
    ])
    return (c, {0: 10, 1: 20, 2: 30, 3: 2, 4: 30, 5: 0, 6: 10},
            [({4: 31}, UNSAT)])


def ram(A):
    w = A.Witness
    c = A.Circuit(opcodes=[
        A.MemoryInit(block_id=0, init=[w(0), w(1)]),
        A.MemoryOp(0, A.MemOp(1, A.Expression.from_witness(w(2)),
                              A.Expression.from_witness(w(3)))),
        A.MemoryOp(0, A.MemOp(0, A.Expression.from_witness(w(4)),
                              A.Expression.from_witness(w(5)))),
        A.MemoryOp(0, A.MemOp(0, A.Expression.from_witness(w(6)),
                              A.Expression.from_witness(w(7)))),
    ])
    return (c, {0: 5, 1: 6, 2: 0, 3: 7, 4: 0, 5: 7, 6: 1, 7: 6},
            [({5: 5}, UNSAT)])


def memory_predicates(A):
    w = A.Witness
    pred = A.Expression.from_witness
    c = A.Circuit(opcodes=[
        A.MemoryInit(block_id=0, init=[w(0), w(1)]),
        A.MemoryOp(0, A.MemOp(1, pred(w(2)), pred(w(3))),
                   predicate=pred(w(5))),
        A.MemoryOp(0, A.MemOp(1, pred(w(2)), pred(w(4))),
                   predicate=pred(w(6))),
        A.MemoryOp(0, A.MemOp(
            0, A.Expression(linear_combinations=[(1, w(7))], q_c=1),
            pred(w(8)))),
        A.MemoryOp(0, A.MemOp(0, pred(w(2)), pred(w(9))),
                   predicate=pred(w(6))),
        A.MemoryOp(0, A.MemOp(0, pred(w(2)), pred(w(10))),
                   predicate=pred(w(5))),
        # a constant-false predicate collapses at compile time
        A.MemoryOp(0, A.MemOp(0, pred(w(2)), pred(w(11))),
                   predicate=A.Expression.constant(0)),
    ])
    vals = {0: 5, 1: 6, 2: 0, 3: 9, 4: 11, 5: 1, 6: 0, 7: 0, 8: 6, 9: 0,
            10: 9, 11: 0}
    return c, vals, [({9: 5}, UNSAT), ({10: 11}, UNSAT)]


def range_naive(A):
    w = A.Witness
    c = A.Circuit(opcodes=[A.BlackBoxRange(A.FunctionInput(w(i), 2))
                           for i in range(3)])
    return c, {0: 0, 1: 3, 2: 2}, [({1: 4}, UNSAT)]


def range_u8_lookup(A):
    w = A.Witness
    c = A.Circuit(opcodes=[A.BlackBoxRange(A.FunctionInput(w(i), 8))
                           for i in range(6)])
    vals = dict(enumerate([0, 255, 17, 128, 3, 77]))
    return c, vals, [({2: 256}, RAISES)]


def range_u16_decomposition(A):
    w = A.Witness
    c = A.Circuit(opcodes=[A.BlackBoxRange(A.FunctionInput(w(i), 16))
                           for i in range(6)])
    return c, dict(enumerate([0, 65535, 256, 12345, 999, 40000])), []


def range_u12_mixed_bases(A):
    c = A.Circuit(opcodes=[A.BlackBoxRange(A.FunctionInput(A.Witness(0), 12))])
    return c, {0: 4000}, []


GADGETS = [assert_zero, assert_zero_multi_mul, rom, ram, memory_predicates,
           range_naive, range_u8_lookup, range_u16_decomposition,
           range_u12_mixed_bases]


def plain(x):
    """A witness builder of either package (a dataclass, possibly holding a
    list of dataclasses) as plain data; lists of plain values stay as
    they are."""
    if dataclasses.is_dataclass(x):
        return type(x).__name__, {k: plain(v) for k, v in vars(x).items()}
    if isinstance(x, list) and x and dataclasses.is_dataclass(x[0]):
        return [plain(v) for v in x]
    return x


def builders_of(builders) -> list:
    """A witness-builder program of either package as plain data."""
    return [plain(b) for b in builders]


def both(gadget):
    """(port program, JAX program, values, negative cases) of one gadget."""
    circuit, vals, bad = gadget(acir)
    jcircuit, jvals, _ = gadget(jacir)
    assert vals == jvals
    return (acir.Program(functions=[circuit]),
            jacir.Program(functions=[jcircuit]), vals, bad)


def satisfied(scheme, witness) -> bool:
    z = V.to_mont(V.pack(witness, CPU))
    return scheme.r1cs.check_z0(z) and scheme.r1cs.is_satisfied(z)


@pytest.mark.parametrize("gadget", GADGETS, ids=lambda g: g.__name__)
def test_gadget_compiles_like_jax(gadget):
    program, jprogram, _, _ = both(gadget)
    r1cs, amap, builders = noir_to_r1cs(program.functions[0])
    jr1cs, jamap, jbuilders = jnoir_to_r1cs(jprogram.functions[0])
    assert convert.r1cs_to_coo(r1cs) == convert.r1cs_to_coo(jr1cs)
    assert amap == jamap
    assert r1cs.num_witnesses == jr1cs.num_witnesses
    assert builders_of(builders) == builders_of(jbuilders)


@pytest.mark.parametrize("gadget", GADGETS, ids=lambda g: g.__name__)
def test_gadget_solve_matches_jax(gadget):
    program, jprogram, vals, bad = both(gadget)
    port = NoirProofScheme.from_program(program, security_level=30,
                                        max_pow_bits=6, device=CPU)
    ref = JScheme.from_program(jprogram, security_level=30, max_pow_bits=6)
    witness = port.solve_witness(vals, rng=random.Random(5))
    assert witness == ref.solve_witness(vals, rng=random.Random(5),
                                        use_native=False)
    assert satisfied(port, witness)
    for change, outcome in bad:
        wrong = {**vals, **change}
        if outcome == RAISES:
            # multiplicity counting hits an out-of-range index
            with pytest.raises((ValueError, IndexError, RuntimeError)):
                port.solve_witness(wrong, rng=random.Random(6))
            continue
        witness = port.solve_witness(wrong, rng=random.Random(6))
        assert witness == ref.solve_witness(wrong, rng=random.Random(6),
                                            use_native=False)
        assert not satisfied(port, witness)


def test_sha256_circuit_matches_jax():
    program, values, digest = sha256.chain_circuit(1)
    jprogram, jvalues, jdigest = JSHA.chain_circuit(1)
    assert (values, digest) == (jvalues, jdigest)
    r1cs, amap, builders = noir_to_r1cs(program.functions[0])
    jr1cs, jamap, jbuilders = jnoir_to_r1cs(jprogram.functions[0])
    assert (r1cs.num_constraints, r1cs.num_witnesses) == (422185, 567352)
    assert convert.r1cs_to_coo(r1cs) == convert.r1cs_to_coo(jr1cs)
    assert amap == jamap
    assert builders_of(builders) == builders_of(jbuilders)


@pytest.mark.slow
def test_sha256_witness_matches_jax():
    program, values, _ = sha256.chain_circuit(1)
    jprogram, _, _ = JSHA.chain_circuit(1)
    port = NoirProofScheme.from_program(program, device=CPU)
    ref = JScheme.from_program(jprogram)
    witness = port.solve_witness(values, rng=random.Random(5))
    assert witness == ref.solve_witness(values, rng=random.Random(5),
                                        use_native=False)
    assert satisfied(port, witness)


def test_entry_points_default_to_the_card():
    for fn in (NoirProofScheme.from_program, WhirR1CSScheme.new_for_r1cs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # building a scheme allocates nothing, so it needs no card
    program, _, _, _ = both(assert_zero)
    scheme = NoirProofScheme.from_program(program, security_level=30,
                                          max_pow_bits=6)
    assert scheme.whir_for_witness.device == torch.device("cuda")
