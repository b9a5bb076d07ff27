"""WitnessBuilder IR: deterministic witness-generation program for the prover.

All 15 builder variants of the reference enum
(``provekit/common/src/witness/witness_builder.rs:35-111``), with solver
semantics matching ``provekit/prover/src/witness/witness_builder.rs:27-193``,
``digits.rs`` and ``ram.rs``.  The builder list order IS the solve order and
interleaves Fiat-Shamir ``Challenge`` draws (from the witness sponge) with
computation.

Values are host ints here (the compiler/solve path is control-flow heavy and
small relative to proving); the proving pipeline moves the final witness
vector to the device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from ..fields import bn254 as F

BINOP_ATOMIC_BITS = 8  # reference common/src/witness/binops.rs:1-9


@dataclass
class Constant:
    witness_idx: int
    value: int


@dataclass
class Acir:
    witness_idx: int
    acir_witness_idx: int


@dataclass
class Sum:
    witness_idx: int
    terms: list  # [(coeff | None, witness_idx)]


@dataclass
class Product:
    witness_idx: int
    a: int
    b: int


@dataclass
class MultiplicitiesForRange:
    start_idx: int
    range_size: int
    value_witnesses: list


@dataclass
class Challenge:
    witness_idx: int


@dataclass
class IndexedLogUpDenominator:
    witness_idx: int
    sz_challenge: int
    index_coeff: int
    index: int
    rs_challenge: int
    value: int


@dataclass
class Inverse:
    witness_idx: int
    operand: int


@dataclass
class ProductLinearOperation:
    """(a*x + b) * (c*y + d)"""
    witness_idx: int
    x: int
    a: int
    b: int
    y: int
    c: int
    d: int


@dataclass
class LogUpDenominator:
    witness_idx: int
    sz_challenge: int
    value_coeff: int
    value: int


@dataclass
class DigitalDecomposition:
    log_bases: list          # little-endian log2 of each base
    witnesses_to_decompose: list
    first_witness_idx: int

    @property
    def num_witnesses_to_decompose(self) -> int:
        return len(self.witnesses_to_decompose)

    @property
    def num_witnesses(self) -> int:
        return len(self.log_bases) * len(self.witnesses_to_decompose)


@dataclass
class SpiceLoad:
    addr: int
    value: int
    read_timestamp: int


@dataclass
class SpiceStore:
    addr: int
    old_value: int
    new_value: int
    read_timestamp: int


@dataclass
class SpiceWitnesses:
    memory_length: int
    initial_values_start: int
    memory_operations: list  # SpiceLoad | SpiceStore
    rv_final_start: int
    rt_final_start: int
    first_witness_idx: int
    num_witnesses: int


@dataclass
class SpiceMultisetFactor:
    witness_idx: int
    sz_challenge: int
    rs_challenge: int
    addr: int            # constant address coefficient
    addr_witness: int
    value: int
    timer: int           # constant timestamp coefficient
    timer_witness: int


# lhs/rhs/output operands: ("const", v) or ("witness", idx)
Operand = tuple


@dataclass
class BinOpLookupDenominator:
    witness_idx: int
    sz_challenge: int
    rs_challenge: int
    rs_challenge_sqrd: int
    lhs: Operand
    rhs: Operand
    output: Operand


@dataclass
class MultiplicitiesForBinOp:
    witness_idx: int
    operands: list  # [(lhs Operand, rhs Operand)]


WitnessBuilder = Union[
    Constant, Acir, Sum, Product, MultiplicitiesForRange, Challenge,
    IndexedLogUpDenominator, Inverse, ProductLinearOperation,
    LogUpDenominator, DigitalDecomposition, SpiceWitnesses,
    SpiceMultisetFactor, BinOpLookupDenominator, MultiplicitiesForBinOp]


def num_witnesses(b: WitnessBuilder) -> int:
    if isinstance(b, MultiplicitiesForRange):
        return b.range_size
    if isinstance(b, DigitalDecomposition):
        return b.num_witnesses
    if isinstance(b, SpiceWitnesses):
        return b.num_witnesses
    if isinstance(b, MultiplicitiesForBinOp):
        return 1 << (2 * BINOP_ATOMIC_BITS)
    return 1


def num_challenges(builders: list) -> int:
    return sum(1 for b in builders if isinstance(b, Challenge))


def _operand_value(op: Operand, w: list) -> int:
    kind, v = op
    if kind == "const":
        return v % F.P
    return w[v]


def _decompose_into_digits(value: int, log_bases: list[int]) -> list[int]:
    digits = []
    rest = value
    for lb in log_bases:
        digits.append(rest & ((1 << lb) - 1))
        rest >>= lb
    if rest:
        raise ValueError("value does not fit in digital decomposition bases")
    return digits


def solve(builders: list, acir_values: dict[int, int], num_total: int,
          transcript) -> list:
    """Run all builders in order; returns witness list (None = unconstrained).

    ``transcript``: the witness sponge (ProverState-like with
    ``challenge_scalars``); Challenge builders squeeze from it.
    """
    w: list = [None] * num_total
    for b in builders:
        if isinstance(b, Constant):
            w[b.witness_idx] = b.value % F.P
        elif isinstance(b, Acir):
            w[b.witness_idx] = acir_values[b.acir_witness_idx] % F.P
        elif isinstance(b, Sum):
            acc = 0
            for coeff, idx in b.terms:
                acc += w[idx] if coeff is None else coeff * w[idx]
            w[b.witness_idx] = acc % F.P
        elif isinstance(b, Product):
            w[b.witness_idx] = w[b.a] * w[b.b] % F.P
        elif isinstance(b, Inverse):
            w[b.witness_idx] = F.inv(w[b.operand])
        elif isinstance(b, Challenge):
            w[b.witness_idx] = transcript.challenge_scalars(1)[0]
        elif isinstance(b, MultiplicitiesForRange):
            counts = [0] * b.range_size
            for idx in b.value_witnesses:
                counts[w[idx]] += 1
            for i, c in enumerate(counts):
                w[b.start_idx + i] = c
        elif isinstance(b, IndexedLogUpDenominator):
            w[b.witness_idx] = (
                w[b.sz_challenge]
                - (b.index_coeff * w[b.index] + w[b.rs_challenge] * w[b.value])
            ) % F.P
        elif isinstance(b, LogUpDenominator):
            w[b.witness_idx] = (
                w[b.sz_challenge] - b.value_coeff * w[b.value]) % F.P
        elif isinstance(b, ProductLinearOperation):
            w[b.witness_idx] = ((b.a * w[b.x] + b.b) % F.P
                                * ((b.c * w[b.y] + b.d) % F.P)) % F.P
        elif isinstance(b, DigitalDecomposition):
            n = len(b.witnesses_to_decompose)
            for i, widx in enumerate(b.witnesses_to_decompose):
                digits = _decompose_into_digits(w[widx], b.log_bases)
                for place, dv in enumerate(digits):
                    w[b.first_witness_idx + place * n + i] = dv
        elif isinstance(b, SpiceWitnesses):
            rv = [w[b.initial_values_start + i] for i in range(b.memory_length)]
            rt = [0] * b.memory_length
            for op_i, op in enumerate(b.memory_operations):
                if isinstance(op, SpiceLoad):
                    addr = w[op.addr]
                    w[op.read_timestamp] = rt[addr]
                    rv[addr] = w[op.value]
                    rt[addr] = op_i + 1
                else:
                    addr = w[op.addr]
                    w[op.old_value] = rv[addr]
                    w[op.read_timestamp] = rt[addr]
                    rv[addr] = w[op.new_value]
                    rt[addr] = op_i + 1
            for i in range(b.memory_length):
                w[b.rv_final_start + i] = rv[i]
                w[b.rt_final_start + i] = rt[i]
        elif isinstance(b, SpiceMultisetFactor):
            rs = w[b.rs_challenge]
            w[b.witness_idx] = (
                w[b.sz_challenge]
                - (b.addr * w[b.addr_witness] + rs * w[b.value]
                   + rs * rs % F.P * b.timer * w[b.timer_witness])) % F.P
        elif isinstance(b, BinOpLookupDenominator):
            lhs = _operand_value(b.lhs, w)
            rhs = _operand_value(b.rhs, w)
            out = _operand_value(b.output, w)
            w[b.witness_idx] = (
                w[b.sz_challenge]
                - (lhs + w[b.rs_challenge] * rhs
                   + w[b.rs_challenge_sqrd] * out)) % F.P
        elif isinstance(b, MultiplicitiesForBinOp):
            counts = [0] * (1 << (2 * BINOP_ATOMIC_BITS))
            for lhs_op, rhs_op in b.operands:
                lhs = _operand_value(lhs_op, w)
                rhs = _operand_value(rhs_op, w)
                counts[(lhs << BINOP_ATOMIC_BITS) + rhs] += 1
            for i, c in enumerate(counts):
                w[b.witness_idx + i] = c
        else:
            raise TypeError(f"unknown builder {type(b)}")
    return w


def fill_witness(w: list, rng) -> list[int]:
    """Unconstrained slots get random values (ZK padding,
    reference prover/src/witness/mod.rs:15-30)."""
    return [rng.randrange(F.P) if v is None else v % F.P for v in w]
