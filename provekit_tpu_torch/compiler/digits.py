"""Digital decomposition gadget (port of ``r1cs-compiler/src/digits.rs``).

Allocates digit witnesses grouped by digital place (little-endian mixed
bases) and adds the recomposition constraints.  Digit range checks are left
to the caller.
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..r1cs import witness_builder as wb


def add_digital_decomposition(c, log_bases: list[int],
                              witnesses_to_decompose: list[int]):
    dd = wb.DigitalDecomposition(
        log_bases=list(log_bases),
        witnesses_to_decompose=list(witnesses_to_decompose),
        first_witness_idx=c.num_witnesses)
    c.add_witness_builder(dd)

    multipliers = [1]
    for log_base in log_bases[:-1]:
        multipliers.append(multipliers[-1] * (1 << log_base) % F.P)

    n = len(witnesses_to_decompose)
    for i, value in enumerate(witnesses_to_decompose):
        recomp = [(multipliers[place], dd.first_witness_idx + place * n + i)
                  for place in range(len(log_bases))]
        c.r1cs.add_constraint([(1, c.witness_one)], [(1, value)], recomp)
    return dd


def decompose_into_digits(value: int, log_bases: list[int]) -> list[int]:
    digits = []
    rest = value
    for lb in log_bases:
        digits.append(rest & ((1 << lb) - 1))
        rest >>= lb
    if rest:
        raise ValueError("higher order bits are not zero")
    return digits
