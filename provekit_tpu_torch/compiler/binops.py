"""AND/XOR lowering via 8-bit-atom pair lookup tables.

Port of ``r1cs-compiler/src/binops.rs``: 32-bit operands are digitally
decomposed into four 8-bit atoms; each atom triple (lhs, rhs, output) is
checked against a 2^16-entry table via LogUp with challenges rs, rs^2.
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..r1cs import witness_builder as wb
from .digits import add_digital_decomposition, decompose_into_digits

BINOP_BITS = 32
BINOP_ATOMIC_BITS = wb.BINOP_ATOMIC_BITS
NUM_DIGITS = BINOP_BITS // BINOP_ATOMIC_BITS


def _atoms_of(c, dd, operand, witness_dd_counter: int, log_bases):
    """Returns (list of Operand atoms, updated counter)."""
    kind, v = operand
    if kind == "witness":
        n = dd.num_witnesses_to_decompose
        atoms = [("witness", dd.first_witness_idx + place * n + witness_dd_counter)
                 for place in range(NUM_DIGITS)]
        return atoms, witness_dd_counter + 1
    digits = decompose_into_digits(v, log_bases)
    return [("const", d) for d in digits], witness_dd_counter


def add_binop(c, op: str, inputs_and_outputs: list) -> None:
    """op: "and" | "xor"; inputs_and_outputs: [(Operand, Operand, out_widx)]."""
    if not inputs_and_outputs:
        return
    log_bases = [BINOP_ATOMIC_BITS] * NUM_DIGITS

    witnesses_to_decompose = []
    for lh, rh, output in inputs_and_outputs:
        if lh[0] == "witness":
            witnesses_to_decompose.append(lh[1])
        if rh[0] == "witness":
            witnesses_to_decompose.append(rh[1])
        witnesses_to_decompose.append(output)
    dd = add_digital_decomposition(c, log_bases, witnesses_to_decompose)

    atomic = []
    counter = 0
    for lh, rh, output in inputs_and_outputs:
        lh_atoms, counter = _atoms_of(c, dd, lh, counter, log_bases)
        rh_atoms, counter = _atoms_of(c, dd, rh, counter, log_bases)
        n = dd.num_witnesses_to_decompose
        out_atoms = [("witness", dd.first_witness_idx + place * n + counter)
                     for place in range(NUM_DIGITS)]
        counter += 1
        atomic.extend(zip(lh_atoms, rh_atoms, out_atoms))

    mult_start = c.add_witness_builder(wb.MultiplicitiesForBinOp(
        c.num_witnesses, [(lh, rh) for lh, rh, _ in atomic]))

    sz_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))
    rs_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))
    rs_challenge_sqrd = c.add_product(rs_challenge, rs_challenge)

    binop_terms = []
    for lh, rh, out in atomic:
        inv = _add_lookup_summand(c, sz_challenge, rs_challenge,
                                  rs_challenge_sqrd, lh, rh, out)
        binop_terms.append((None, inv))
    sum_for_bin_op = c.add_sum(binop_terms)

    table_terms = []
    for lhs in range(1 << BINOP_ATOMIC_BITS):
        for rhs in range(1 << BINOP_ATOMIC_BITS):
            output = lhs & rhs if op == "and" else lhs ^ rhs
            inv = _add_lookup_summand(
                c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                ("const", lhs), ("const", rhs), ("const", output))
            mult_idx = mult_start + (lhs << BINOP_ATOMIC_BITS) + rhs
            table_terms.append((None, c.add_product(mult_idx, inv)))
    sum_for_table = c.add_sum(table_terms)

    c.r1cs.add_constraint([(1, c.witness_one)], [(1, sum_for_bin_op)],
                          [(1, sum_for_table)])


def _operand_c_term(operand):
    """C-row term for a constant-or-witness operand (coeff, witness)."""
    kind, v = operand
    if kind == "const":
        return (v % F.P, 0)
    return (1, v)


def _add_lookup_summand(c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                        lh, rh, output) -> int:
    denom = c.add_witness_builder(wb.BinOpLookupDenominator(
        c.num_witnesses, sz_challenge, rs_challenge, rs_challenge_sqrd,
        lh, rh, output))
    if output[0] == "const":
        rs2_term = (output[1] % F.P, rs_challenge_sqrd)
    else:
        rs2_term = (1, c.add_product(rs_challenge_sqrd, output[1]))
    c.r1cs.add_constraint(
        [(F.P - 1, rs_challenge)], [_operand_c_term(rh)],
        [(1, denom), (F.P - 1, sz_challenge), _operand_c_term(lh), rs2_term])
    inverse = c.add_witness_builder(wb.Inverse(c.num_witnesses, denom))
    c.r1cs.add_constraint([(1, denom)], [(1, inverse)], [(1, c.witness_one)])
    return inverse
