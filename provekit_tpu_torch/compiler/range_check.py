"""Range-check lowering (port of ``r1cs-compiler/src/range_check.rs``).

* > 8 bits: mixed-base digital decomposition (8-bit digits + remainder digit),
  then the digits are themselves range checked.
* <= 8 bits with > 5 occurrences: LogUp lookup table with multiplicities.
* otherwise: naive product check  prod_{i=0}^{2^k-1} (a - i) = 0.
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..r1cs import witness_builder as wb
from .digits import add_digital_decomposition

NUM_WITNESS_THRESHOLD_FOR_LOOKUP_TABLE = 5
NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP = 8


def add_range_checks(c, range_checks: dict[int, list[int]]) -> None:
    atomic: list[list[int]] = [[] for _ in
                               range(NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP + 1)]
    for num_bits in sorted(range_checks):
        values = range_checks[num_bits]
        if num_bits > NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP:
            num_big = num_bits // NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP
            rem = num_bits % NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP
            log_bases = [NUM_BITS_THRESHOLD_FOR_DIGITAL_DECOMP] * num_big
            if rem:
                log_bases.append(rem)
            dd = add_digital_decomposition(c, log_bases, list(values))
            n = len(values)
            for place, log_base in enumerate(dd.log_bases):
                digit_witnesses = [dd.first_witness_idx + place * n + i
                                   for i in range(n)]
                atomic[log_base].extend(digit_witnesses)
        else:
            atomic[num_bits].extend(values)

    for num_bits, values in enumerate(atomic):
        if not values:
            continue
        if len(values) > NUM_WITNESS_THRESHOLD_FOR_LOOKUP_TABLE:
            _add_range_check_via_lookup(c, num_bits, values)
        else:
            for v in values:
                _add_naive_range_check(c, num_bits, v)


def add_lookup_factor(c, sz_challenge: int, value_coeff: int,
                      value_witness: int) -> int:
    denom = c.add_witness_builder(wb.LogUpDenominator(
        c.num_witnesses, sz_challenge, value_coeff % F.P, value_witness))
    c.r1cs.add_constraint(
        [(1, sz_challenge), (F.neg(value_coeff), value_witness)],
        [(1, c.witness_one)], [(1, denom)])
    inverse = c.add_witness_builder(wb.Inverse(c.num_witnesses, denom))
    c.r1cs.add_constraint([(1, denom)], [(1, inverse)], [(1, c.witness_one)])
    return inverse


def _add_range_check_via_lookup(c, num_bits: int, values: list[int]) -> None:
    counts_start = c.add_witness_builder(wb.MultiplicitiesForRange(
        c.num_witnesses, 1 << num_bits, list(values)))
    sz_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))

    table_terms = []
    for table_value in range(1 << num_bits):
        inv = add_lookup_factor(c, sz_challenge, table_value, c.witness_one)
        table_terms.append((None, c.add_product(inv, counts_start + table_value)))
    sum_for_table = c.add_sum(table_terms)

    witness_terms = []
    for v in values:
        witness_terms.append((None, add_lookup_factor(c, sz_challenge, 1, v)))
    sum_for_witness = c.add_sum(witness_terms)

    c.r1cs.add_constraint(
        [(1, sum_for_table), (F.P - 1, sum_for_witness)],
        [(1, c.witness_one)], [(0, c.witness_one)])


def _add_naive_range_check(c, num_bits: int, index_witness: int) -> None:
    current = index_witness
    for i in range(1, (1 << num_bits) - 1):
        nxt = c.add_witness_builder(wb.ProductLinearOperation(
            c.num_witnesses, current, 1, 0, index_witness, 1, F.neg(i)))
        c.r1cs.add_constraint(
            [(1, current)], [(1, index_witness), (F.neg(i), c.witness_one)],
            [(1, nxt)])
        current = nxt
    c.r1cs.add_constraint(
        [(1, current)],
        [(1, index_witness), (F.neg((1 << num_bits) - 1), c.witness_one)],
        [(0, c.witness_one)])
