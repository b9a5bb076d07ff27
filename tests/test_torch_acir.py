"""The port's ACVM, Brillig VM, artifact parser and encoder against the JAX
package's, on the same inputs, with exact equality.

Every case of ``tests/test_brillig.py`` runs through both packages: the VM's
return data, the executed witness maps, and on a trap, a failed range check,
an unsatisfied constraint or a spent step budget the same exception class
and message.  The four Noir fixtures parse to the same program and ABI,
execute to the same witness map, and the port's encoder writes them byte for
byte.
"""

import json
import pathlib
import sys

import pytest

from provekit_tpu.acir import brillig as JB
from provekit_tpu.acir import execute as JX
from provekit_tpu.acir import model as JM
from provekit_tpu.acir import parse as jparse
from provekit_tpu.fields import bn254 as F
from provekit_tpu.io import files as jfiles
from provekit_tpu_torch.acir import brillig as TB
from provekit_tpu_torch.acir import encode as tencode
from provekit_tpu_torch.acir import execute as TX
from provekit_tpu_torch.acir import model as TM
from provekit_tpu_torch.acir import parse as tparse
from provekit_tpu_torch.io import files as tfiles

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
JAX = (JB, JX, JM)
PORT = (TB, TX, TM)

# the inputs tests/test_acir_fixtures.py gives each fixture, and the witness
# values it asserts
FIXTURE_INPUTS = {
    "mul_chain": ([6, 7], {2: 42, 3: 42 * 42}),
    "range_and_xor": ([0xA5, 0x3C], {2: 0xA5 & 0x3C, 3: 0xA5 ^ 0x3C}),
    "rom_reads": ([11, 13], {2: 11, 3: 13, 4: 143}),
    "brillig_inverse": ([12345], {1: pow(12345, F.P - 2, F.P)}),
}


def stop(B, ptr_slot, size_slot):
    D = B.MemoryAddress.direct
    return B.Stop(B.HeapVector(pointer=D(ptr_slot), size=D(size_slot)))


def run(B, code, calldata=(), handler=None, **kw):
    return B.BrilligVM(list(code), list(calldata), handler, **kw).run()


# ---------------------------------------------------------------------------
# The cases of tests/test_brillig.py, each a function of the package's
# (brillig, execute, model) modules


def field_arithmetic_and_return(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(10), 32, 2), B.Const(D(11), 32, 0),
        B.CalldataCopy(D(1), D(10), D(11)),
        B.BinaryFieldOp(D(3), "Add", D(1), D(2)),
        B.BinaryFieldOp(D(4), "Mul", D(3), D(1)),
        B.Const(D(5), 32, 4), B.Const(D(6), 32, 1),
        stop(B, 5, 6)], [1234, 5678])


def field_div_is_modular(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(10), 32, 2), B.Const(D(11), 32, 0),
        B.CalldataCopy(D(1), D(10), D(11)),
        B.BinaryFieldOp(D(3), "Div", D(1), D(2)),
        B.Const(D(5), 32, 3), B.Const(D(6), 32, 1),
        stop(B, 5, 6)], [7, 3])


def int_ops_wrap_and_compare(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(1), 8, 200), B.Const(D(2), 8, 100),
        B.BinaryIntOp(D(3), "Add", 8, D(1), D(2)),
        B.BinaryIntOp(D(4), "LessThan", 8, D(2), D(1)),
        B.BinaryIntOp(D(5), "Xor", 8, D(1), D(2)),
        B.BinaryIntOp(D(6), "Shl", 8, D(2), D(4)),
        B.Not(D(7), D(4), 1),
        B.Const(D(8), 32, 3), B.Const(D(9), 32, 5),
        stop(B, 8, 9)])


def loop_sum_1_to_10(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(1), 32, 1), B.Const(D(2), 32, 0),
        B.Const(D(3), 32, 11), B.Const(D(4), 32, 1),
        B.BinaryIntOp(D(5), "Equals", 32, D(1), D(3)),
        B.JumpIf(D(5), 9),
        B.BinaryIntOp(D(2), "Add", 32, D(2), D(1)),
        B.BinaryIntOp(D(1), "Add", 32, D(1), D(4)),
        B.Jump(4),
        B.Const(D(6), 32, 2), B.Const(D(7), 32, 1),
        stop(B, 6, 7)])


def call_return_and_relative_addressing(B, X, M):
    D, REL = B.MemoryAddress.direct, B.MemoryAddress.rel
    return run(B, [
        B.Const(D(0), 32, 100), B.Const(D(100), B.FIELD, 7), B.Call(6),
        B.Const(D(2), 32, 101), B.Const(D(3), 32, 1), stop(B, 2, 3),
        B.BinaryFieldOp(REL(1), "Mul", REL(0), REL(0)), B.Return()])


def load_store_indirect(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(1), 32, 50), B.Const(D(2), B.FIELD, 99),
        B.Store(D(1), D(2)), B.Load(D(3), D(1)),
        B.IndirectConst(D(1), B.FIELD, 123), B.Load(D(4), D(1)),
        B.Const(D(5), 32, 3), B.Const(D(6), 32, 2),
        stop(B, 5, 6)])


def conditional_mov_and_cast(B, X, M):
    D = B.MemoryAddress.direct
    vm = B.BrilligVM([
        B.Const(D(1), B.FIELD, 0), B.Const(D(2), B.FIELD, 10),
        B.Const(D(3), B.FIELD, 20),
        B.ConditionalMov(D(4), D(2), D(3), D(1)),
        B.Const(D(5), B.FIELD, 257), B.Cast(D(6), D(5), 8),
        B.Const(D(7), 32, 4), B.Const(D(8), 32, 1),
        stop(B, 7, 8), B.Const(D(9), 32, 0)], [])
    return vm.run(), vm.memory.read(D(6))


def to_radix_big_endian_limbs(B, X, M):
    D = B.MemoryAddress.direct
    return run(B, [
        B.Const(D(1), B.FIELD, 0x1234), B.Const(D(2), 32, 256),
        B.Const(D(3), 32, 10),
        B.ToRadix(D(1), D(2), D(3), num_limbs=2, output_bits=False),
        B.Const(D(4), 32, 10), B.Const(D(5), 32, 2),
        stop(B, 4, 5)])


def trap_raises(B, X, M):
    return run(B, [B.Trap()])


def step_budget(B, X, M):
    return run(B, [B.Jump(0)], max_steps=1000)


def foreign_call_print_ignored_and_handler(B, X, M):
    D = B.MemoryAddress.direct
    calls = []

    def handler(name, inputs):
        calls.append((name, inputs))
        return [] if name == "print" else [[10]]

    out = run(B, [
        B.Const(D(1), B.FIELD, 5),
        B.ForeignCall("print", destinations=[], inputs=[D(1)]),
        B.ForeignCall("get_two", destinations=[D(2)], inputs=[D(1)]),
        B.Const(D(3), 32, 2), B.Const(D(4), 32, 1),
        stop(B, 3, 4)], handler=handler)
    return out, calls


def inverse_program(B, M):
    D = B.MemoryAddress.direct
    w = M.Witness
    inv_code = B.BrilligBytecode(bytecode=[
        B.Const(D(10), 32, 1), B.Const(D(11), 32, 0),
        B.CalldataCopy(D(1), D(10), D(11)),
        B.Const(D(2), B.FIELD, 1),
        B.BinaryFieldOp(D(4), "Div", D(2), D(1)),
        B.Const(D(5), 32, 4), B.Const(D(6), 32, 1),
        stop(B, 5, 6)])
    circuit = M.Circuit(opcodes=[
        M.BrilligCall(
            id=0,
            inputs=[M.BrilligInputSingle(M.Expression.from_witness(w(0)))],
            outputs=[M.BrilligOutputSimple(w(1))]),
        M.AssertZero(M.Expression(mul_terms=[(1, w(0), w(1))], q_c=F.P - 1)),
        M.AssertZero(M.Expression(
            linear_combinations=[(1, w(1)), (F.P - 1, w(2))])),
    ], private_parameters=[0], return_values=[2], current_witness_index=2)
    return M.Program(functions=[circuit], unconstrained_functions=[inv_code])


def acvm_brillig_inverse_circuit(B, X, M):
    return X.execute_program(inverse_program(B, M), {0: 987654321})


def acvm_assert_zero_solving_chain(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.AssertZero(M.Expression(
            linear_combinations=[(3, w(0)), (F.P - 1, w(1))], q_c=5)),
        M.AssertZero(M.Expression(
            mul_terms=[(1, w(1), w(1))],
            linear_combinations=[(F.P - 1, w(2))])),
    ], private_parameters=[0])
    return X.execute_program(M.Program(functions=[circuit]), {0: 4})


def acvm_unsatisfied_constraint(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.AssertZero(M.Expression(
            linear_combinations=[(1, w(0))], q_c=F.P - 7)),
    ], private_parameters=[0])
    return X.execute_program(M.Program(functions=[circuit]), {0: 8})


def acvm_two_unknowns(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.AssertZero(M.Expression(mul_terms=[(1, w(1), w(2))])),
    ], private_parameters=[0])
    return X.execute_program(M.Program(functions=[circuit]), {0: 8})


def acvm_memory_read_write(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.MemoryInit(block_id=0, init=[w(0), w(1)]),
        M.MemoryOp(0, M.MemOp(1, M.Expression.constant(0),
                              M.Expression.from_witness(w(2)))),
        M.MemoryOp(0, M.MemOp(0, M.Expression.constant(0),
                              M.Expression.from_witness(w(3)))),
        M.MemoryOp(0, M.MemOp(0, M.Expression.constant(1),
                              M.Expression.from_witness(w(4))),
                   predicate=M.Expression.constant(0)),
    ])
    return X.execute_program(M.Program(functions=[circuit]),
                             {0: 5, 1: 6, 2: 42})


def acvm_memory_out_of_bounds(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.MemoryInit(block_id=0, init=[w(0), w(1)]),
        M.MemoryOp(0, M.MemOp(0, M.Expression.constant(2),
                              M.Expression.from_witness(w(3)))),
    ])
    return X.execute_program(M.Program(functions=[circuit]), {0: 5, 1: 6})


def acvm_blackbox_and_xor_range(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.BlackBoxAnd(M.FunctionInput(w(0), 8), M.FunctionInput(w(1), 8),
                      w(2)),
        M.BlackBoxXor(M.FunctionInput(w(0), 8), M.FunctionInput(w(1), 8),
                      w(3)),
        M.BlackBoxRange(M.FunctionInput(w(2), 8)),
    ])
    return X.execute_program(M.Program(functions=[circuit]),
                             {0: 0xF0, 1: 0x3C})


def acvm_range_failure(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[M.BlackBoxRange(M.FunctionInput(w(0), 4))])
    return X.execute_program(M.Program(functions=[circuit]), {0: 16})


def acvm_brillig_trap_in_call(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.BrilligCall(id=0, inputs=[],
                      outputs=[M.BrilligOutputSimple(w(1))])])
    program = M.Program(functions=[circuit], unconstrained_functions=[
        B.BrilligBytecode(bytecode=[B.Trap()])])
    return X.execute_program(program, {0: 1})


def acvm_brillig_predicate_false_zeroes_outputs(B, X, M):
    w = M.Witness
    circuit = M.Circuit(opcodes=[
        M.BrilligCall(id=0, inputs=[], outputs=[
            M.BrilligOutputArray([w(1), w(2)])],
            predicate=M.Expression.constant(0)),
    ])
    program = M.Program(functions=[circuit], unconstrained_functions=[
        B.BrilligBytecode(bytecode=[B.Trap()])])
    return X.execute_program(program, {0: 1})


def acvm_initial_witness_from_abi_inputs(B, X, M):
    circuit = M.Circuit(private_parameters=[0, 2], public_parameters=[1])
    return X.initial_witness_from_inputs(circuit, [10, 20, 30])


def acvm_wrong_input_count(B, X, M):
    circuit = M.Circuit(private_parameters=[0, 2], public_parameters=[1])
    return X.initial_witness_from_inputs(circuit, [10, 20])


CASES = {f.__name__: f for f in (
    field_arithmetic_and_return, field_div_is_modular,
    int_ops_wrap_and_compare, loop_sum_1_to_10,
    call_return_and_relative_addressing, load_store_indirect,
    conditional_mov_and_cast, to_radix_big_endian_limbs, trap_raises,
    step_budget, foreign_call_print_ignored_and_handler,
    acvm_brillig_inverse_circuit, acvm_assert_zero_solving_chain,
    acvm_unsatisfied_constraint, acvm_two_unknowns, acvm_memory_read_write,
    acvm_memory_out_of_bounds, acvm_blackbox_and_xor_range,
    acvm_range_failure, acvm_brillig_trap_in_call,
    acvm_brillig_predicate_false_zeroes_outputs,
    acvm_initial_witness_from_abi_inputs, acvm_wrong_input_count)}

# the cases that must raise, and what their message says
RAISES = {
    "trap_raises": "Brillig trap", "step_budget": "step budget",
    "acvm_unsatisfied_constraint": "unsatisfied",
    "acvm_two_unknowns": "two unknowns",
    "acvm_memory_out_of_bounds": "out of bounds",
    "acvm_range_failure": "range check failed",
    "acvm_brillig_trap_in_call": "assertion failed",
    "acvm_wrong_input_count": "parameter witnesses",
}


def outcome(case, modules):
    try:
        return "returned", case(*modules)
    except Exception as e:  # the class and message are what is compared
        return "raised", type(e).__name__, str(e)


@pytest.mark.parametrize("name", sorted(CASES))
def test_brillig_and_acvm_match_jax(name):
    want = outcome(CASES[name], JAX)
    got = outcome(CASES[name], PORT)
    assert got == want
    if name in RAISES:
        assert got[0] == "raised" and RAISES[name] in got[2], got
    else:
        assert got[0] == "returned", got


def test_brillig_values_are_right():
    """The port's values, checked against the expectations of
    tests/test_brillig.py (the comparison above holds them to JAX)."""
    assert field_arithmetic_and_return(*PORT)[0] == (1234 + 5678) * 1234
    assert int_ops_wrap_and_compare(*PORT) == [44, 1, 200 ^ 100, 200, 0]
    assert loop_sum_1_to_10(*PORT) == [55]
    assert call_return_and_relative_addressing(*PORT) == [49]
    assert to_radix_big_endian_limbs(*PORT) == [0x12, 0x34]
    wmap = acvm_brillig_inverse_circuit(*PORT)
    assert wmap[1] == pow(987654321, F.P - 2, F.P) == wmap[2]
    wmap = acvm_memory_read_write(*PORT)
    assert wmap[3] == 42 and wmap[4] == 0


# ---------------------------------------------------------------------------
# The Noir fixtures


@pytest.mark.parametrize("name", sorted(FIXTURE_INPUTS))
def test_fixture_parses_and_executes_as_jax(name):
    path = FIXTURES / f"{name}.json"
    program, abi = tparse.parse_artifact(path), tparse.artifact_abi(path)
    assert tfiles._enc(program) == jfiles._enc(jparse.parse_artifact(path))
    assert tfiles._enc(abi) == jfiles._enc(jparse.artifact_abi(path))
    inputs, expected = FIXTURE_INPUTS[name]
    assert abi.field_count() == len(inputs)
    circuit = program.functions[0]
    wmap = TX.execute_program(
        program, TX.initial_witness_from_inputs(circuit, inputs))
    jprogram = jparse.parse_artifact(path)
    jwmap = JX.execute_program(
        jprogram, JX.initial_witness_from_inputs(jprogram.functions[0],
                                                 inputs))
    assert wmap == jwmap
    assert {k: wmap[k] for k in expected} == expected


def test_fixture_range_failure_matches_jax():
    path = FIXTURES / "range_and_xor.json"
    got = outcome(lambda B, X, M: X.execute_program(
        tparse.parse_artifact(path), {0: 0x1A5, 1: 0x3C}), PORT)
    want = outcome(lambda B, X, M: X.execute_program(
        jparse.parse_artifact(path), {0: 0x1A5, 1: 0x3C}), JAX)
    assert got == want and got[0] == "raised"


def test_encoder_writes_the_fixtures_byte_for_byte(tmp_path):
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_acir_fixtures as gen
    for name, build in gen.FIXTURES.items():
        program_doc, abi_doc = build()
        path = FIXTURES / f"{name}.json"
        assert tencode.artifact_json(program_doc, abi_doc) == \
            json.loads(path.read_text())
        out = tmp_path / f"{name}.json"
        tencode.write_artifact(out, program_doc, abi_doc)
        assert out.read_bytes() == path.read_bytes(), name
