"""ACIR -> R1CS compiler: the AssertZero lowering.

Behavioral port of the AssertZero path of ``provekit_tpu/compiler/
noir_to_r1cs.py`` (reference ``provekit/r1cs-compiler/src/noir_to_r1cs.rs``):
one pass over the opcodes produces the R1CS matrices, the ACIR->R1CS witness
map and the ordered WitnessBuilder program.  Memory, range and binop opcodes
need the compiler gadgets, which the torch port does not carry yet; they
raise ``NotImplementedError``.
"""

from __future__ import annotations

from ..acir import model as acir
from ..fields import bn254 as F
from ..r1cs import R1CS
from ..r1cs import witness_builder as wb

ONE = 1


class NoirToR1CSCompiler:
    def __init__(self):
        self.r1cs = R1CS()
        self.witness_builders: list = [wb.Constant(0, 1)]
        self.acir_to_r1cs: dict[int, int] = {}

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

    def add_product(self, a: int, b: int) -> int:
        prod = self.add_witness_builder(wb.Product(self.num_witnesses, a, b))
        self.r1cs.add_constraint([(1, a)], [(1, b)], [(1, prod)])
        return prod

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

    # -- opcode pass -------------------------------------------------------

    def add_circuit(self, circuit: acir.Circuit) -> None:
        for opcode in circuit.opcodes:
            if isinstance(opcode, acir.AssertZero):
                self.add_acir_assert_zero(opcode.expr)
            elif isinstance(opcode, acir.BrilligCall):
                pass  # witness generation only, no constraints
            else:
                raise NotImplementedError(
                    f"opcode {type(opcode).__name__} is not lowered by the "
                    "torch port yet (ROADMAP queue 1, item 5: compiler "
                    "gadgets); only AssertZero circuits compile")


def noir_to_r1cs(circuit: acir.Circuit):
    """Returns (r1cs, acir->r1cs witness map, witness builders)."""
    c = NoirToR1CSCompiler()
    c.add_circuit(circuit)
    return c.r1cs, c.acir_to_r1cs, c.witness_builders
