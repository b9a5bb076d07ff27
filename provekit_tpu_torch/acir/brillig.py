"""Brillig VM: executes Noir's unconstrained functions for witness generation.

Port of ``provekit_tpu/acir/brillig.py`` (the same classes and semantics).

The reference delegates witness generation to the external ACVM/Brillig VM
(``nargo::ops::execute_program`` + ``Bn254BlackBoxSolver``,
``provekit/prover/src/noir_proof_scheme.rs:36-62`` — the ``noir``/``acir``
crates are git dependencies, not vendored).  This module is a from-scratch
Python implementation of the Brillig machine (ACVM ``brillig_vm`` semantics,
msgpack-era opcode set of noir >= 1.0.0-beta.4):

* a flat, growable, tagged memory (field values and U1..U128 integers),
* ``Direct``/``Relative`` addressing (relative resolves against the stack
  pointer held at memory address 0),
* a call stack for ``Call``/``Return``,
* calldata injection (``CalldataCopy``) and return data (``Stop``),
* foreign calls routed to a host handler (``print`` is ignored by default),
* the ``ToRadix`` black-box (digit decomposition used by ``to_le_bytes`` &
  friends); other in-Brillig black-boxes raise descriptively.

The VM is host-side scalar code by design: Brillig traces are tiny,
sequential and data-dependent (the antithesis of a device workload); the solved
witness vector is what moves to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from ..fields import bn254 as F

FIELD = "field"  # bit_size tag for field-typed memory values


class BrilligError(Exception):
    pass


class BrilligTrap(BrilligError):
    """Raised when the program executes ``Trap`` (an assertion failure)."""

    def __init__(self, revert_data: list[int]):
        self.revert_data = revert_data
        super().__init__(f"Brillig trap (revert data: {revert_data})")


# ---------------------------------------------------------------------------
# Addressing


@dataclass(frozen=True)
class MemoryAddress:
    """``Direct(n)`` or ``Relative(n)`` (offset from the stack pointer)."""
    offset: int
    relative: bool = False

    @classmethod
    def direct(cls, n: int) -> "MemoryAddress":
        return cls(n, False)

    @classmethod
    def rel(cls, n: int) -> "MemoryAddress":
        return cls(n, True)


@dataclass(frozen=True)
class HeapArray:
    pointer: MemoryAddress
    size: int


@dataclass(frozen=True)
class HeapVector:
    pointer: MemoryAddress
    size: MemoryAddress


# ---------------------------------------------------------------------------
# Opcodes (mirrors acvm::brillig::Opcode)


@dataclass
class BinaryFieldOp:
    destination: MemoryAddress
    op: str  # Add Sub Mul Div IntegerDiv Equals LessThan LessThanEquals
    lhs: MemoryAddress
    rhs: MemoryAddress


@dataclass
class BinaryIntOp:
    destination: MemoryAddress
    op: str  # Add Sub Mul Div Equals LessThan LessThanEquals And Or Xor Shl Shr
    bit_size: int
    lhs: MemoryAddress
    rhs: MemoryAddress


@dataclass
class Not:
    destination: MemoryAddress
    source: MemoryAddress
    bit_size: int


@dataclass
class Cast:
    destination: MemoryAddress
    source: MemoryAddress
    bit_size: Union[int, str]  # int bits or FIELD


@dataclass
class Jump:
    location: int


@dataclass
class JumpIf:
    condition: MemoryAddress
    location: int


@dataclass
class JumpIfNot:
    condition: MemoryAddress
    location: int


@dataclass
class CalldataCopy:
    destination_address: MemoryAddress
    size_address: MemoryAddress
    offset_address: MemoryAddress


@dataclass
class Call:
    location: int


@dataclass
class Const:
    destination: MemoryAddress
    bit_size: Union[int, str]
    value: int


@dataclass
class IndirectConst:
    destination_pointer: MemoryAddress
    bit_size: Union[int, str]
    value: int


@dataclass
class Return:
    pass


@dataclass
class ForeignCall:
    function: str
    destinations: list = field(default_factory=list)  # ValueOrArray
    destination_value_types: list = field(default_factory=list)
    inputs: list = field(default_factory=list)        # ValueOrArray
    input_value_types: list = field(default_factory=list)


@dataclass
class Mov:
    destination: MemoryAddress
    source: MemoryAddress


@dataclass
class ConditionalMov:
    destination: MemoryAddress
    source_a: MemoryAddress
    source_b: MemoryAddress
    condition: MemoryAddress


@dataclass
class Load:
    destination: MemoryAddress
    source_pointer: MemoryAddress


@dataclass
class Store:
    destination_pointer: MemoryAddress
    source: MemoryAddress


@dataclass
class ToRadix:
    """BlackBox(ToRadix): digit-decompose a field value into memory."""
    input: MemoryAddress
    radix: MemoryAddress
    output_pointer: MemoryAddress
    num_limbs: int
    output_bits: bool  # True -> U1 limbs, False -> U8 limbs


@dataclass
class BlackBoxOther:
    """An in-Brillig black-box this VM does not implement (name kept)."""
    name: str
    payload: object = None


@dataclass
class Trap:
    revert_data: Optional[HeapVector] = None


@dataclass
class Stop:
    return_data: Optional[HeapVector] = None


BrilligOpcode = Union[
    BinaryFieldOp, BinaryIntOp, Not, Cast, Jump, JumpIf, JumpIfNot,
    CalldataCopy, Call, Const, IndirectConst, Return, ForeignCall, Mov,
    ConditionalMov, Load, Store, ToRadix, BlackBoxOther, Trap, Stop,
]


@dataclass
class BrilligBytecode:
    bytecode: list  # [BrilligOpcode]


# ---------------------------------------------------------------------------
# Memory


class Memory:
    """Flat growable memory of (value, bit_size) cells; address 0 holds the
    stack pointer used by Relative addressing."""

    __slots__ = ("vals", "tags")

    def __init__(self):
        self.vals: list[int] = []
        self.tags: list = []

    def _grow(self, n: int) -> None:
        if n >= len(self.vals):
            pad = n + 1 - len(self.vals)
            self.vals.extend([0] * pad)
            self.tags.extend([FIELD] * pad)

    def resolve(self, addr: MemoryAddress) -> int:
        if not addr.relative:
            return addr.offset
        sp = self.vals[0] if self.vals else 0
        return sp + addr.offset

    def read(self, addr: MemoryAddress) -> tuple[int, object]:
        i = self.resolve(addr)
        self._grow(i)
        return self.vals[i], self.tags[i]

    def write(self, addr: MemoryAddress, value: int, tag) -> None:
        i = self.resolve(addr)
        self._grow(i)
        self.vals[i] = value
        self.tags[i] = tag

    def read_slice(self, start: int, size: int) -> list[int]:
        self._grow(start + size)
        return self.vals[start:start + size]

    def write_slice(self, start: int, values: list[int], tag) -> None:
        self._grow(start + len(values))
        for k, v in enumerate(values):
            self.vals[start + k] = v
            self.tags[start + k] = tag


# ---------------------------------------------------------------------------
# VM


def _wrap(v: int, bits: int) -> int:
    return v & ((1 << bits) - 1)


class BrilligVM:
    """One Brillig function activation.

    ``foreign_handler(name, inputs: list[list[int]]) -> list[list[int]]``
    receives flattened input groups and returns one flat value group per
    destination; ``print`` is swallowed when no handler is given.
    """

    def __init__(self, bytecode: list, calldata: list[int],
                 foreign_handler: Optional[Callable] = None,
                 max_steps: int = 10_000_000):
        self.code = bytecode
        self.calldata = [v % F.P for v in calldata]
        self.memory = Memory()
        self.call_stack: list[int] = []
        self.pc = 0
        self.foreign_handler = foreign_handler
        self.max_steps = max_steps
        self.return_data: list[int] = []

    # -- execution ---------------------------------------------------------

    def run(self) -> list[int]:
        steps = 0
        code = self.code
        n = len(code)
        while self.pc < n:
            steps += 1
            if steps > self.max_steps:
                raise BrilligError(
                    f"step budget exceeded ({self.max_steps}) at pc={self.pc}")
            op = code[self.pc]
            handler = _DISPATCH.get(type(op))
            if handler is None:
                raise BrilligError(f"unknown opcode {op!r}")
            jumped = handler(self, op)
            if jumped == "stop":
                return self.return_data
            if not jumped:
                self.pc += 1
        raise BrilligError("fell off the end of bytecode without Stop/Return")

    # -- opcode handlers -----------------------------------------------------

    def _binary_field(self, op: BinaryFieldOp):
        a, _ = self.memory.read(op.lhs)
        b, _ = self.memory.read(op.rhs)
        kind = op.op
        if kind == "Add":
            r, tag = (a + b) % F.P, FIELD
        elif kind == "Sub":
            r, tag = (a - b) % F.P, FIELD
        elif kind == "Mul":
            r, tag = (a * b) % F.P, FIELD
        elif kind == "Div":
            if b % F.P == 0:
                raise BrilligTrap([])
            r, tag = a * pow(b, F.P - 2, F.P) % F.P, FIELD
        elif kind == "IntegerDiv":
            if b == 0:
                raise BrilligTrap([])
            r, tag = a // b, FIELD
        elif kind == "Equals":
            r, tag = int(a % F.P == b % F.P), 1
        elif kind == "LessThan":
            r, tag = int(a < b), 1
        elif kind == "LessThanEquals":
            r, tag = int(a <= b), 1
        else:
            raise BrilligError(f"unknown BinaryFieldOp {kind}")
        self.memory.write(op.destination, r, tag)

    def _binary_int(self, op: BinaryIntOp):
        a, _ = self.memory.read(op.lhs)
        b, _ = self.memory.read(op.rhs)
        bits = op.bit_size
        kind = op.op
        tag = bits
        if kind == "Add":
            r = _wrap(a + b, bits)
        elif kind == "Sub":
            r = _wrap(a - b, bits)
        elif kind == "Mul":
            r = _wrap(a * b, bits)
        elif kind == "Div":
            if b == 0:
                raise BrilligTrap([])
            r = a // b
        elif kind == "Equals":
            r, tag = int(a == b), 1
        elif kind == "LessThan":
            r, tag = int(a < b), 1
        elif kind == "LessThanEquals":
            r, tag = int(a <= b), 1
        elif kind == "And":
            r = a & b
        elif kind == "Or":
            r = a | b
        elif kind == "Xor":
            r = a ^ b
        elif kind == "Shl":
            r = 0 if b >= bits else _wrap(a << b, bits)
        elif kind == "Shr":
            r = 0 if b >= bits else a >> b
        else:
            raise BrilligError(f"unknown BinaryIntOp {kind}")
        self.memory.write(op.destination, r, tag)

    def _not(self, op: Not):
        v, _ = self.memory.read(op.source)
        self.memory.write(op.destination, _wrap(~v, op.bit_size), op.bit_size)

    def _cast(self, op: Cast):
        v, _ = self.memory.read(op.source)
        if op.bit_size == FIELD:
            self.memory.write(op.destination, v % F.P, FIELD)
        else:
            self.memory.write(op.destination, _wrap(v, op.bit_size),
                              op.bit_size)

    def _jump(self, op: Jump):
        self.pc = op.location
        return True

    def _jump_if(self, op: JumpIf):
        v, _ = self.memory.read(op.condition)
        if v != 0:
            self.pc = op.location
            return True

    def _jump_if_not(self, op: JumpIfNot):
        v, _ = self.memory.read(op.condition)
        if v == 0:
            self.pc = op.location
            return True

    def _calldata_copy(self, op: CalldataCopy):
        size, _ = self.memory.read(op.size_address)
        offset, _ = self.memory.read(op.offset_address)
        if offset + size > len(self.calldata):
            raise BrilligError(
                f"CalldataCopy out of range: [{offset}, {offset + size}) of "
                f"{len(self.calldata)}")
        dest = self.memory.resolve(op.destination_address)
        self.memory.write_slice(dest, self.calldata[offset:offset + size],
                                FIELD)

    def _call(self, op: Call):
        self.call_stack.append(self.pc + 1)
        if len(self.call_stack) > 2000:
            raise BrilligError("call stack overflow")
        self.pc = op.location
        return True

    def _const(self, op: Const):
        tag = op.bit_size
        v = op.value % F.P if tag == FIELD else _wrap(op.value, tag)
        self.memory.write(op.destination, v, tag)

    def _indirect_const(self, op: IndirectConst):
        ptr, _ = self.memory.read(op.destination_pointer)
        tag = op.bit_size
        v = op.value % F.P if tag == FIELD else _wrap(op.value, tag)
        self.memory.write(MemoryAddress.direct(ptr), v, tag)

    def _return(self, op: Return):
        if not self.call_stack:
            raise BrilligError("Return with empty call stack")
        self.pc = self.call_stack.pop()
        return True

    def _foreign_call(self, op: ForeignCall):
        inputs = [self._read_value_or_array(v) for v in op.inputs]
        if self.foreign_handler is not None:
            outs = self.foreign_handler(op.function, inputs)
        elif op.function == "print":
            outs = [[] for _ in op.destinations]
        else:
            raise BrilligError(
                f"unhandled foreign call '{op.function}' (no handler)")
        if len(outs) != len(op.destinations):
            raise BrilligError(
                f"foreign call '{op.function}': {len(outs)} outputs for "
                f"{len(op.destinations)} destinations")
        for dest, values in zip(op.destinations, outs):
            self._write_value_or_array(dest, values)

    def _read_value_or_array(self, v) -> list[int]:
        if isinstance(v, MemoryAddress):
            return [self.memory.read(v)[0]]
        if isinstance(v, HeapArray):
            ptr, _ = self.memory.read(v.pointer)
            return self.memory.read_slice(ptr, v.size)
        if isinstance(v, HeapVector):
            ptr, _ = self.memory.read(v.pointer)
            size, _ = self.memory.read(v.size)
            return self.memory.read_slice(ptr, size)
        raise BrilligError(f"bad ValueOrArray {v!r}")

    def _write_value_or_array(self, v, values: list[int]) -> None:
        if isinstance(v, MemoryAddress):
            if len(values) != 1:
                raise BrilligError("scalar destination needs 1 value")
            self.memory.write(v, values[0] % F.P, FIELD)
        elif isinstance(v, HeapArray):
            ptr, _ = self.memory.read(v.pointer)
            if len(values) != v.size:
                raise BrilligError("array destination size mismatch")
            self.memory.write_slice(ptr, [x % F.P for x in values], FIELD)
        elif isinstance(v, HeapVector):
            ptr, _ = self.memory.read(v.pointer)
            self.memory.write(v.size, len(values), 32)
            self.memory.write_slice(ptr, [x % F.P for x in values], FIELD)
        else:
            raise BrilligError(f"bad ValueOrArray {v!r}")

    def _mov(self, op: Mov):
        v, tag = self.memory.read(op.source)
        self.memory.write(op.destination, v, tag)

    def _cmov(self, op: ConditionalMov):
        c, _ = self.memory.read(op.condition)
        src = op.source_a if c != 0 else op.source_b
        v, tag = self.memory.read(src)
        self.memory.write(op.destination, v, tag)

    def _load(self, op: Load):
        ptr, _ = self.memory.read(op.source_pointer)
        v, tag = self.memory.read(MemoryAddress.direct(ptr))
        self.memory.write(op.destination, v, tag)

    def _store(self, op: Store):
        ptr, _ = self.memory.read(op.destination_pointer)
        v, tag = self.memory.read(op.source)
        self.memory.write(MemoryAddress.direct(ptr), v, tag)

    def _to_radix(self, op: ToRadix):
        v, _ = self.memory.read(op.input)
        radix, _ = self.memory.read(op.radix)
        if radix < 2:
            raise BrilligError("ToRadix radix < 2")
        limbs = [0] * op.num_limbs
        x = v % F.P
        for i in range(op.num_limbs - 1, -1, -1):  # big-endian in memory
            limbs[i] = x % radix
            x //= radix
        if x:
            raise BrilligTrap([])  # value does not fit in num_limbs digits
        ptr, _ = self.memory.read(op.output_pointer)
        self.memory.write_slice(ptr, limbs, 1 if op.output_bits else 8)

    def _blackbox_other(self, op: BlackBoxOther):
        raise BrilligError(f"unsupported in-Brillig black-box '{op.name}'")

    def _trap(self, op: Trap):
        data: list[int] = []
        if op.revert_data is not None:
            data = self._read_value_or_array(op.revert_data)
        raise BrilligTrap(data)

    def _stop(self, op: Stop):
        if op.return_data is not None:
            self.return_data = self._read_value_or_array(op.return_data)
        return "stop"


_DISPATCH = {
    BinaryFieldOp: BrilligVM._binary_field,
    BinaryIntOp: BrilligVM._binary_int,
    Not: BrilligVM._not,
    Cast: BrilligVM._cast,
    Jump: BrilligVM._jump,
    JumpIf: BrilligVM._jump_if,
    JumpIfNot: BrilligVM._jump_if_not,
    CalldataCopy: BrilligVM._calldata_copy,
    Call: BrilligVM._call,
    Const: BrilligVM._const,
    IndirectConst: BrilligVM._indirect_const,
    Return: BrilligVM._return,
    ForeignCall: BrilligVM._foreign_call,
    Mov: BrilligVM._mov,
    ConditionalMov: BrilligVM._cmov,
    Load: BrilligVM._load,
    Store: BrilligVM._store,
    ToRadix: BrilligVM._to_radix,
    BlackBoxOther: BrilligVM._blackbox_other,
    Trap: BrilligVM._trap,
    Stop: BrilligVM._stop,
}


def execute(bytecode: list, calldata: list[int],
            foreign_handler: Optional[Callable] = None) -> list[int]:
    """Run one Brillig function to completion; returns its return data."""
    return BrilligVM(bytecode, calldata, foreign_handler).run()
