"""ACIR -> R1CS compiler: opcode lowering and gadget emission.

Behavioral port of ``provekit/r1cs-compiler/src/noir_to_r1cs.rs:28-409``:
single pass over opcodes (AssertZero, BrilligCall, MemoryInit/Op, black-box
RANGE/AND/XOR), then post-passes emitting ROM (indexed LogUp), RAM (Spice
offline memory checking), binop lookup tables, and range checks.  Produces
the R1CS matrices, the ACIR->R1CS witness map, and the ordered
WitnessBuilder program (solve order interleaves Fiat-Shamir challenges).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..acir import model as acir
from ..fields import bn254 as F
from ..r1cs import R1CS
from ..r1cs import witness_builder as wb

ONE = 1


@dataclass
class MemoryBlock:
    initial_value_witnesses: list = field(default_factory=list)
    operations: list = field(default_factory=list)  # [("load"|"store", addr, value)]
    scratch: int | None = None  # table index of the predicate scratch slot

    def is_read_only(self) -> bool:
        return all(op[0] == "load" for op in self.operations)

    def scratch_slot(self, compiler: "NoirToR1CSCompiler") -> int:
        """Index of the always-zero scratch slot (appended on first use).

        Predicated memory ops are lowered onto it: a disabled load reads 0
        from the scratch slot (matching ACVM's disabled-read-returns-zero
        semantics) and a disabled store rewrites it with p*value == 0, so
        the slot provably stays zero."""
        if self.scratch is None:
            self.scratch = len(self.initial_value_witnesses)
            zero = compiler.add_witness_builder(
                wb.Constant(compiler.num_witnesses, 0))
            compiler.r1cs.add_constraint(
                [(1, zero)], [(1, compiler.witness_one)], [])
            self.initial_value_witnesses.append(zero)
        return self.scratch


class NoirToR1CSCompiler:
    def __init__(self):
        self.r1cs = R1CS()
        self.witness_builders: list = [wb.Constant(0, 1)]
        self.acir_to_r1cs: dict[int, int] = {}
        self.initial_memories: dict[int, list[int]] = {}

    # -- infrastructure ----------------------------------------------------

    @property
    def witness_one(self) -> int:
        return 0

    @property
    def num_witnesses(self) -> int:
        return self.r1cs.num_witnesses

    def add_witness_builder(self, builder) -> int:
        start = self.r1cs.num_witnesses
        self.r1cs.new_witnesses(wb.num_witnesses(builder))
        if isinstance(builder, wb.Acir):
            self.acir_to_r1cs[builder.acir_witness_idx] = builder.witness_idx
        self.witness_builders.append(builder)
        return start

    def fetch_r1cs_witness(self, acir_witness: acir.Witness) -> int:
        # hot path: inlined add_witness_builder(Acir) without the
        # num_witnesses dispatch (Acir builders always allocate 1 slot)
        key = acir_witness.index
        idx = self.acir_to_r1cs.get(key)
        if idx is None:
            idx = self.r1cs.num_witnesses
            self.r1cs.new_witnesses(1)
            self.acir_to_r1cs[key] = idx
            self.witness_builders.append(wb.Acir(idx, key))
        return idx

    def fetch_operand(self, fi: acir.FunctionInput) -> wb.Operand:
        if fi.is_constant():
            return ("const", fi.value % F.P)
        return ("witness", self.fetch_r1cs_witness(fi.value))

    def add_product(self, a: int, b: int) -> int:
        prod = self.add_witness_builder(wb.Product(self.num_witnesses, a, b))
        self.r1cs.add_constraint([(1, a)], [(1, b)], [(1, prod)])
        return prod

    def add_sum(self, terms: list) -> int:
        """terms: [(coeff | None, witness_idx)]."""
        s = self.add_witness_builder(wb.Sum(self.num_witnesses, terms))
        az = [(1 if c is None else c, i) for c, i in terms]
        self.r1cs.add_constraint(az, [(1, self.witness_one)], [(1, s)])
        return s

    def witness_for_expression(self, expr: acir.Expression) -> int:
        """R1CS witness constrained to equal a general ACIR expression.

        Goes beyond the reference (noir_to_r1cs.rs:297-305 bails on
        non-witness MemoryOp indices): quadratic terms become Product
        witnesses, the linear tail a Sum witness."""
        w = expr.to_witness()
        if w is not None:
            return self.fetch_r1cs_witness(w)
        terms = []
        for coeff, wa, wb_ in expr.mul_terms:
            prod = self.add_product(self.fetch_r1cs_witness(wa),
                                    self.fetch_r1cs_witness(wb_))
            terms.append((coeff % F.P, prod))
        for coeff, wv in expr.linear_combinations:
            terms.append((coeff % F.P, self.fetch_r1cs_witness(wv)))
        if expr.q_c % F.P or not terms:
            terms.append((expr.q_c % F.P, self.witness_one))
        return self.add_sum(terms)

    # -- AssertZero --------------------------------------------------------

    def add_acir_assert_zero(self, expr: acir.Expression) -> None:
        linear, a, b = [], [], []
        if expr.mul_terms:
            for coeff, wa, wb_ in expr.mul_terms[:-1]:
                ia = self.fetch_r1cs_witness(wa)
                ib = self.fetch_r1cs_witness(wb_)
                linear.append((F.neg(coeff), self.add_product(ia, ib)))
            coeff, wa, wb_ = expr.mul_terms[-1]
            a = [(coeff % F.P, self.fetch_r1cs_witness(wa))]
            b = [(1, self.fetch_r1cs_witness(wb_))]
        for coeff, w in expr.linear_combinations:
            linear.append((F.neg(coeff), self.fetch_r1cs_witness(w)))
        linear.append((F.neg(expr.q_c), self.witness_one))
        self.r1cs.add_constraint(a, b, linear)

    # -- memory ops ----------------------------------------------------------

    def add_memory_op(self, block: MemoryBlock, opcode: acir.MemoryOp) -> None:
        """Lower a (possibly predicated) MemoryOp onto the block's op list.

        Beyond the reference surface (noir_to_r1cs.rs:280-325 asserts
        predicate.is_none() and a single-witness index): general expression
        indices are materialized via ``witness_for_expression``; a
        predicated op is rewritten against an always-zero scratch slot L:

            load  p,addr,v   ->  load(p*addr + (1-p)*L, v)
            store p,addr,v   ->  store(p*addr + (1-p)*L, p*v)

        With p == 1 these are the plain ops; with p == 0 the load reads the
        scratch zero (ACVM assigns 0 to a disabled read's value witness) and
        the store rewrites scratch with 0, so the slot provably stays zero.
        p is boolean-constrained (p*p == p).
        """
        kind = "load" if opcode.op.operation == 0 else "store"
        pred = opcode.predicate
        if pred is not None:
            # constant predicates collapse at compile time
            if not pred.mul_terms and not pred.linear_combinations:
                if pred.q_c % F.P == 0:
                    if kind == "load":
                        # disabled read still pins its value witness to zero
                        v = self.fetch_r1cs_witness(
                            opcode.op.value.to_witness())
                        self.r1cs.add_constraint(
                            [(1, v)], [(1, self.witness_one)], [])
                    return
                pred = None
        addr = self.witness_for_expression(opcode.op.index)
        if pred is None:
            value = self.fetch_r1cs_witness(opcode.op.value.to_witness())
            block.operations.append((kind, addr, value))
            return
        p = self.witness_for_expression(pred)
        self.r1cs.add_constraint([(1, p)], [(1, p)], [(1, p)])  # boolean
        scratch = block.scratch_slot(self)
        t = self.add_product(p, addr)
        if scratch == 0:
            addr_eff = t
        else:
            addr_eff = self.add_sum(
                [(1, t), (F.neg(scratch), p), (scratch, self.witness_one)])
        if kind == "load":
            value = self.fetch_r1cs_witness(opcode.op.value.to_witness())
            block.operations.append(("load", addr_eff, value))
        else:
            v = self.witness_for_expression(opcode.op.value)
            block.operations.append(("store", addr_eff, self.add_product(p, v)))

    # -- opcode pass -------------------------------------------------------

    def add_circuit(self, circuit: acir.Circuit) -> None:
        memory_blocks: dict[int, MemoryBlock] = {}
        range_checks: dict[int, list[int]] = {}
        and_ops, xor_ops = [], []

        for opcode in circuit.opcodes:
            if isinstance(opcode, acir.AssertZero):
                self.add_acir_assert_zero(opcode.expr)
            elif isinstance(opcode, acir.BrilligCall):
                pass  # witness generation only, no constraints
            elif isinstance(opcode, acir.MemoryInit):
                if opcode.block_type != "Memory":
                    raise ValueError("MemoryInit block type must be Memory")
                if opcode.block_id in memory_blocks:
                    raise ValueError(f"memory block {opcode.block_id} reinit")
                self.initial_memories[opcode.block_id] = [
                    w.index for w in opcode.init]
                block = MemoryBlock()
                for w in opcode.init:
                    block.initial_value_witnesses.append(
                        self.fetch_r1cs_witness(w))
                memory_blocks[opcode.block_id] = block
            elif isinstance(opcode, acir.MemoryOp):
                self.add_memory_op(memory_blocks[opcode.block_id], opcode)
            elif isinstance(opcode, acir.BlackBoxRange):
                fi = opcode.input
                if fi.is_constant():
                    raise ValueError("range check of a constant")
                widx = self.fetch_r1cs_witness(fi.value)
                range_checks.setdefault(fi.num_bits, []).append(widx)
            elif isinstance(opcode, acir.BlackBoxAnd):
                and_ops.append((self.fetch_operand(opcode.lhs),
                                self.fetch_operand(opcode.rhs),
                                self.fetch_r1cs_witness(opcode.output)))
            elif isinstance(opcode, acir.BlackBoxXor):
                xor_ops.append((self.fetch_operand(opcode.lhs),
                                self.fetch_operand(opcode.rhs),
                                self.fetch_r1cs_witness(opcode.output)))
            elif isinstance(opcode, acir.BlackBoxUnsupported):
                raise NotImplementedError(
                    f"black box function {opcode.name} not supported")
            else:
                raise NotImplementedError(f"unsupported opcode {opcode}")

        from . import binops, memory, range_check
        for block in memory_blocks.values():
            if block.is_read_only():
                memory.add_rom_checking(self, block)
            else:
                num_bits, to_check = memory.add_ram_checking(self, block)
                range_checks.setdefault(num_bits, []).extend(to_check)

        binops.add_binop(self, "and", and_ops)
        binops.add_binop(self, "xor", xor_ops)
        range_check.add_range_checks(self, range_checks)


def noir_to_r1cs(circuit: acir.Circuit):
    """Returns (r1cs, acir->r1cs witness map, witness builders)."""
    c = NoirToR1CSCompiler()
    c.add_circuit(circuit)
    return c.r1cs, c.acir_to_r1cs, c.witness_builders
