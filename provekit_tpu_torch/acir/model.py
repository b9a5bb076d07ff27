"""ACIR data model: the circuit input format of the compiler front-end.

Python mirror of the ``acir`` crate types the reference consumes
(``acir::circuit::{Circuit, Opcode}``, ``native_types::Expression`` — usage
surface in ``provekit/r1cs-compiler/src/noir_to_r1cs.rs:231-409``):

* ``Expression``: quadratic combination — mul terms (c * w_a * w_b), linear
  combinations (c * w), constant q_c.
* Opcodes: AssertZero, BrilligCall (witness-solving only, no constraints),
  MemoryInit / MemoryOp, black-box RANGE / AND / XOR.

Circuits can be built programmatically (tests, frontends) or parsed from a
Noir build artifact (``acir.parse``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


@dataclass(frozen=True)
class Witness:
    """ACIR witness index."""
    index: int


@dataclass
class Expression:
    """sum(c * w_a * w_b) + sum(c * w) + q_c == 0 (for AssertZero)."""
    mul_terms: list = field(default_factory=list)      # [(coeff, Witness, Witness)]
    linear_combinations: list = field(default_factory=list)  # [(coeff, Witness)]
    q_c: int = 0

    def to_witness(self) -> Optional[Witness]:
        """If the expression is exactly one unit linear term, that witness."""
        if (not self.mul_terms and self.q_c == 0
                and len(self.linear_combinations) == 1
                and self.linear_combinations[0][0] == 1):
            return self.linear_combinations[0][1]
        return None

    @classmethod
    def from_witness(cls, w: Witness) -> "Expression":
        return cls(linear_combinations=[(1, w)])

    @classmethod
    def constant(cls, c: int) -> "Expression":
        return cls(q_c=c)


@dataclass(frozen=True)
class FunctionInput:
    """Either a constant or a witness, with a bit width."""
    value: Union[int, Witness]
    num_bits: int

    def is_constant(self) -> bool:
        return not isinstance(self.value, Witness)


@dataclass
class AssertZero:
    expr: Expression


@dataclass
class BrilligInputSingle:
    expr: Expression


@dataclass
class BrilligInputArray:
    exprs: list  # [Expression]


@dataclass
class BrilligInputMemoryArray:
    block_id: int


BrilligInput = Union[BrilligInputSingle, BrilligInputArray,
                     BrilligInputMemoryArray]


@dataclass
class BrilligOutputSimple:
    witness: Witness


@dataclass
class BrilligOutputArray:
    witnesses: list  # [Witness]


BrilligOutput = Union[BrilligOutputSimple, BrilligOutputArray]


@dataclass
class BrilligCall:
    """Unconstrained function call — witness generation only.

    ``inputs``/``outputs`` are typed (``BrilligInput*``/``BrilligOutput*``)
    when built by the parser or the executor's callers; raw docs are
    tolerated by the compiler (which emits no constraints for this opcode).
    """
    id: int
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    predicate: Optional[Expression] = None


@dataclass
class MemoryInit:
    block_id: int
    init: list = field(default_factory=list)  # [Witness]
    block_type: str = "Memory"


@dataclass
class MemOp:
    """operation: 0 = read, 1 = write; index/value are Expressions."""
    operation: int
    index: Expression
    value: Expression


@dataclass
class MemoryOp:
    block_id: int
    op: MemOp
    predicate: Optional[Expression] = None


@dataclass
class BlackBoxRange:
    input: FunctionInput


@dataclass
class BlackBoxAnd:
    lhs: FunctionInput
    rhs: FunctionInput
    output: Witness


@dataclass
class BlackBoxXor:
    lhs: FunctionInput
    rhs: FunctionInput
    output: Witness


@dataclass
class BlackBoxUnsupported:
    """A black-box function the compiler does not lower (name kept for errors)."""
    name: str
    payload: object = None


Opcode = Union[AssertZero, BrilligCall, MemoryInit, MemoryOp,
               BlackBoxRange, BlackBoxAnd, BlackBoxXor, BlackBoxUnsupported]


@dataclass
class Circuit:
    opcodes: list = field(default_factory=list)
    private_parameters: list = field(default_factory=list)  # [int] acir idxs
    public_parameters: list = field(default_factory=list)   # [int] acir idxs
    return_values: list = field(default_factory=list)       # [int] acir idxs
    current_witness_index: int = 0

    def public_inputs(self) -> list[int]:
        """Ordered public input indices (public params then returns)."""
        return sorted(set(self.public_parameters) | set(self.return_values))


@dataclass
class Program:
    functions: list = field(default_factory=list)       # [Circuit]
    unconstrained_functions: list = field(default_factory=list)
