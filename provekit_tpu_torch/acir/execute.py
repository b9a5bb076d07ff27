"""ACVM: execute an ACIR circuit to produce the full witness map.

Port of ``provekit_tpu/acir/execute.py``.

In-tree replacement for the reference's external witness generator
(``nargo::ops::execute_program`` with ``Bn254BlackBoxSolver`` and the default
foreign-call executor, ``provekit/prover/src/noir_proof_scheme.rs:36-62``).
Given the flattened ABI inputs this solves every ACIR opcode in order:

* ``AssertZero``   — partial evaluation + single-unknown linear solve (the
  ACVM ``ExpressionSolver`` algorithm),
* ``BrilligCall``  — evaluate calldata, run the :mod:`brillig` VM, assign the
  returned values to the output witnesses (zeroed under a false predicate),
* ``MemoryInit/Op``— replay the block; reads assign the value witness,
* black-box ``RANGE`` (check), ``AND``/``XOR`` (compute output witness).

The executor is deliberately host-side: witness generation is sequential,
branchy, and integer-exact; the solved vector is then packed to limb planes
for the device-side prover.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..fields import bn254 as F
from . import model as acir
from .brillig import BrilligTrap, BrilligVM


class ExecutionError(Exception):
    pass


class UnsolvableOpcode(ExecutionError):
    """An opcode references witnesses that are not yet known."""


def _eval_expression(expr: acir.Expression, wmap: dict[int, int]):
    """Partially evaluate: returns (constant, {witness_index: coeff}).

    Mul terms with one known factor become linear; with both known they fold
    into the constant; with both unknown the expression is not solvable yet.
    """
    const = expr.q_c % F.P
    linear: dict[int, int] = {}

    def add_lin(i: int, c: int):
        linear[i] = (linear.get(i, 0) + c) % F.P

    for c, wa, wb in expr.mul_terms:
        a = wmap.get(wa.index)
        b = wmap.get(wb.index)
        if a is not None and b is not None:
            const = (const + c * a * b) % F.P
        elif a is not None:
            add_lin(wb.index, c * a % F.P)
        elif b is not None:
            add_lin(wa.index, c * b % F.P)
        else:
            raise UnsolvableOpcode(
                f"mul term with two unknowns: w{wa.index} * w{wb.index}")
    for c, w in expr.linear_combinations:
        v = wmap.get(w.index)
        if v is not None:
            const = (const + c * v) % F.P
        else:
            add_lin(w.index, c % F.P)
    linear = {i: c for i, c in linear.items() if c != 0}
    return const, linear


def evaluate(expr: acir.Expression, wmap: dict[int, int]) -> int:
    """Fully evaluate an expression; raises if any witness is unknown."""
    const, linear = _eval_expression(expr, wmap)
    if linear:
        missing = ", ".join(f"w{i}" for i in linear)
        raise UnsolvableOpcode(f"expression has unknowns: {missing}")
    return const


def solve_assert_zero(expr: acir.Expression, wmap: dict[int, int]) -> None:
    const, linear = _eval_expression(expr, wmap)
    if not linear:
        if const != 0:
            raise ExecutionError(
                f"unsatisfied constraint: expression == {const} != 0")
        return
    if len(linear) > 1:
        missing = ", ".join(f"w{i}" for i in linear)
        raise UnsolvableOpcode(f"cannot solve for multiple unknowns: {missing}")
    (idx, coeff), = linear.items()
    wmap[idx] = (-const) * pow(coeff, F.P - 2, F.P) % F.P


def _predicate_active(pred: Optional[acir.Expression],
                      wmap: dict[int, int]) -> bool:
    if pred is None:
        return True
    return evaluate(pred, wmap) != 0


def _assign(wmap: dict[int, int], idx: int, value: int) -> None:
    value %= F.P
    prev = wmap.get(idx)
    if prev is not None and prev != value:
        raise ExecutionError(
            f"witness w{idx} reassigned: {prev} -> {value}")
    wmap[idx] = value


class CircuitExecutor:
    """Executes one ACIR function over a witness map (mutated in place)."""

    def __init__(self, program: acir.Program, function_index: int = 0,
                 foreign_handler: Optional[Callable] = None):
        self.program = program
        self.circuit = program.functions[function_index]
        self.foreign_handler = foreign_handler
        self.blocks: dict[int, list[int]] = {}

    # -- brillig -----------------------------------------------------------

    def _brillig_calldata(self, inputs: list, wmap: dict[int, int]) -> list[int]:
        data: list[int] = []
        for inp in inputs:
            if isinstance(inp, acir.BrilligInputSingle):
                data.append(evaluate(inp.expr, wmap))
            elif isinstance(inp, acir.BrilligInputArray):
                data.extend(evaluate(e, wmap) for e in inp.exprs)
            elif isinstance(inp, acir.BrilligInputMemoryArray):
                block = self.blocks.get(inp.block_id)
                if block is None:
                    raise ExecutionError(
                        f"Brillig input references uninitialized memory "
                        f"block {inp.block_id}")
                data.extend(block)
            else:
                raise ExecutionError(f"bad Brillig input {inp!r}")
        return data

    def _run_brillig(self, op: acir.BrilligCall, wmap: dict[int, int]) -> None:
        out_witnesses: list[int] = []
        for out in op.outputs:
            if isinstance(out, acir.BrilligOutputSimple):
                out_witnesses.append(out.witness.index)
            elif isinstance(out, acir.BrilligOutputArray):
                out_witnesses.extend(w.index for w in out.witnesses)
            else:
                raise ExecutionError(f"bad Brillig output {out!r}")

        if not _predicate_active(op.predicate, wmap):
            for idx in out_witnesses:
                _assign(wmap, idx, 0)
            return

        funcs = self.program.unconstrained_functions
        if not (0 <= op.id < len(funcs)):
            raise ExecutionError(f"BrilligCall id {op.id} out of range "
                                 f"({len(funcs)} unconstrained functions)")
        bytecode = funcs[op.id]
        bytecode = getattr(bytecode, "bytecode", bytecode)
        calldata = self._brillig_calldata(op.inputs, wmap)
        try:
            ret = BrilligVM(bytecode, calldata, self.foreign_handler).run()
        except BrilligTrap as e:
            raise ExecutionError(
                f"assertion failed in unconstrained function {op.id}: {e}"
            ) from e
        if len(ret) != len(out_witnesses):
            raise ExecutionError(
                f"Brillig function {op.id} returned {len(ret)} values for "
                f"{len(out_witnesses)} output witnesses")
        for idx, v in zip(out_witnesses, ret):
            _assign(wmap, idx, v)

    # -- memory --------------------------------------------------------------

    def _memory_init(self, op: acir.MemoryInit, wmap: dict[int, int]) -> None:
        vals = []
        for w in op.init:
            v = wmap.get(w.index)
            if v is None:
                raise UnsolvableOpcode(f"MemoryInit with unknown w{w.index}")
            vals.append(v)
        self.blocks[op.block_id] = vals

    def _memory_op(self, op: acir.MemoryOp, wmap: dict[int, int]) -> None:
        block = self.blocks.get(op.block_id)
        if block is None:
            raise ExecutionError(f"MemoryOp on uninitialized block "
                                 f"{op.block_id}")
        active = _predicate_active(op.predicate, wmap)
        index = evaluate(op.op.index, wmap) if active else 0
        if active and not (0 <= index < len(block)):
            raise ExecutionError(
                f"memory index {index} out of bounds (len {len(block)})")
        if op.op.operation == 0:  # read
            w = op.op.value.to_witness()
            if w is None:
                # value may already be fully known - then it's just a check
                got = evaluate(op.op.value, wmap)
                want = block[index] if active else 0
                if got != want:
                    raise ExecutionError(
                        f"memory read mismatch at {index}: {got} != {want}")
                return
            _assign(wmap, w.index, block[index] if active else 0)
        else:  # write
            value = evaluate(op.op.value, wmap)
            if active:
                block[index] = value

    # -- black boxes ---------------------------------------------------------

    @staticmethod
    def _input_value(fi: acir.FunctionInput, wmap: dict[int, int]) -> int:
        if fi.is_constant():
            return fi.value % F.P
        v = wmap.get(fi.value.index)
        if v is None:
            raise UnsolvableOpcode(f"black-box input w{fi.value.index} unknown")
        return v

    def _blackbox(self, op, wmap: dict[int, int]) -> None:
        if isinstance(op, acir.BlackBoxRange):
            v = self._input_value(op.input, wmap)
            if v >= (1 << op.input.num_bits):
                raise ExecutionError(
                    f"range check failed: {v} >= 2^{op.input.num_bits}")
            return
        if isinstance(op, (acir.BlackBoxAnd, acir.BlackBoxXor)):
            a = self._input_value(op.lhs, wmap)
            b = self._input_value(op.rhs, wmap)
            mask = (1 << op.lhs.num_bits) - 1
            r = (a & b) if isinstance(op, acir.BlackBoxAnd) else (a ^ b)
            _assign(wmap, op.output.index, r & mask)
            return
        raise ExecutionError(
            f"unsupported black-box '{getattr(op, 'name', type(op).__name__)}'")

    # -- main loop -------------------------------------------------------------

    def execute(self, initial_witness: dict[int, int]) -> dict[int, int]:
        wmap = {i: v % F.P for i, v in initial_witness.items()}
        for k, op in enumerate(self.circuit.opcodes):
            try:
                if isinstance(op, acir.AssertZero):
                    solve_assert_zero(op.expr, wmap)
                elif isinstance(op, acir.BrilligCall):
                    self._run_brillig(op, wmap)
                elif isinstance(op, acir.MemoryInit):
                    self._memory_init(op, wmap)
                elif isinstance(op, acir.MemoryOp):
                    self._memory_op(op, wmap)
                elif isinstance(op, (acir.BlackBoxRange, acir.BlackBoxAnd,
                                     acir.BlackBoxXor,
                                     acir.BlackBoxUnsupported)):
                    self._blackbox(op, wmap)
                else:
                    raise ExecutionError(f"unsupported opcode {type(op).__name__}")
            except ExecutionError as e:
                raise type(e)(f"opcode {k}: {e}") from None
        return wmap


def execute_program(program: acir.Program, initial_witness: dict[int, int],
                    foreign_handler: Optional[Callable] = None
                    ) -> dict[int, int]:
    """Solve the main function's witness map from the initial assignments."""
    if len(program.functions) != 1:
        raise ExecutionError(
            f"expected exactly 1 ACIR function, got {len(program.functions)}")
    ex = CircuitExecutor(program, 0, foreign_handler)
    return ex.execute(initial_witness)


def initial_witness_from_inputs(circuit: acir.Circuit,
                                inputs: list[int]) -> dict[int, int]:
    """Map flattened ABI inputs onto the circuit's parameter witnesses.

    Parameter witnesses are the sorted union of private and public parameter
    indices (nargo assigns ABI inputs to the leading witness slots in
    declaration order).
    """
    params = sorted(set(circuit.private_parameters)
                    | set(circuit.public_parameters))
    if len(inputs) != len(params):
        raise ExecutionError(
            f"{len(inputs)} ABI inputs for {len(params)} parameter witnesses")
    return {idx: v % F.P for idx, v in zip(params, inputs)}
