"""ROM / RAM gadget lowering.

Behavioral port of ``provekit/r1cs-compiler/src/memory/{rom.rs,ram.rs}``:
* ROM: indexed-LogUp — multiplicities + two challenges + per-read inverse
  denominators; sum over reads equals multiplicity-weighted sum over table.
* RAM: Spice offline memory checking — read-set/write-set running-product
  multiset hashes over INIT / LOAD / STORE / AUDIT phases, with timestamp
  range checks (two range-checked values per op) returned to the caller.
"""

from __future__ import annotations

from ..fields import bn254 as F
from ..r1cs import witness_builder as wb


def _add_indexed_lookup_factor(c, rs_challenge, sz_challenge, index_coeff,
                               index_witness, value) -> int:
    denom = c.add_witness_builder(wb.IndexedLogUpDenominator(
        c.num_witnesses, sz_challenge, index_coeff, index_witness,
        rs_challenge, value))
    c.r1cs.add_constraint(
        [(1, rs_challenge)], [(1, value)],
        [(F.P - 1, denom), (1, sz_challenge), (F.neg(index_coeff), index_witness)])
    inverse = c.add_witness_builder(wb.Inverse(c.num_witnesses, denom))
    c.r1cs.add_constraint([(1, denom)], [(1, inverse)], [(1, c.witness_one)])
    return inverse


def add_rom_checking(c, block) -> None:
    assert block.is_read_only()
    addr_witnesses = [addr for kind, addr, _ in block.operations]
    memory_length = len(block.initial_value_witnesses)
    counts_start = c.add_witness_builder(wb.MultiplicitiesForRange(
        c.num_witnesses, memory_length, addr_witnesses))

    rs_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))
    sz_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))

    read_terms = []
    for kind, addr, value in block.operations:
        inv = _add_indexed_lookup_factor(c, rs_challenge, sz_challenge,
                                         1, addr, value)
        read_terms.append((None, inv))
    sum_for_reads = c.add_sum(read_terms)

    table_terms = []
    for addr, value in enumerate(block.initial_value_witnesses):
        denom_inv = _add_indexed_lookup_factor(
            c, rs_challenge, sz_challenge, addr, c.witness_one, value)
        table_terms.append((None, c.add_product(counts_start + addr, denom_inv)))
    sum_for_table = c.add_sum(table_terms)

    c.r1cs.add_constraint([(1, c.witness_one)], [(1, sum_for_reads)],
                          [(1, sum_for_table)])


def _add_mem_op_multiset_factor(c, sz_challenge, rs_challenge,
                                rs_challenge_sqrd, addr_pair, value_witness,
                                timer_pair) -> int:
    addr, addr_witness = addr_pair
    timer, timer_witness = timer_pair
    factor = c.add_witness_builder(wb.SpiceMultisetFactor(
        c.num_witnesses, sz_challenge, rs_challenge, addr, addr_witness,
        value_witness, timer, timer_witness))
    intermediate = c.add_product(rs_challenge_sqrd, timer_witness)
    c.r1cs.add_constraint(
        [(1, rs_challenge)], [(F.P - 1, value_witness)],
        [(1, factor), (F.P - 1, sz_challenge), (timer % F.P, intermediate),
         (addr % F.P, addr_witness)])
    return factor


def add_ram_checking(c, block):
    """Returns (range_check_num_bits, witnesses_to_range_check)."""
    rs_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))
    rs_challenge_sqrd = c.add_product(rs_challenge, rs_challenge)
    sz_challenge = c.add_witness_builder(wb.Challenge(c.num_witnesses))

    rs_hash = c.witness_one
    ws_hash = c.witness_one
    memory_length = len(block.initial_value_witnesses)
    mem_op_index_and_rt = []

    # INIT: write-set factors at timestamp 0
    for addr, mem_value in enumerate(block.initial_value_witnesses):
        factor = _add_mem_op_multiset_factor(
            c, sz_challenge, rs_challenge, rs_challenge_sqrd,
            (addr, c.witness_one), mem_value, (0, c.witness_one))
        ws_hash = c.add_product(ws_hash, factor)

    # allocate Spice witnesses (read timestamps, old values, final rv/rt)
    next_idx = c.num_witnesses
    start_idx = next_idx
    spice_ops = []
    for kind, addr, value in block.operations:
        if kind == "load":
            spice_ops.append(wb.SpiceLoad(addr, value, next_idx))
            next_idx += 1
        else:
            spice_ops.append(wb.SpiceStore(addr, next_idx, value, next_idx + 1))
            next_idx += 2
    rv_final_start = next_idx
    next_idx += memory_length
    rt_final_start = next_idx
    next_idx += memory_length
    spice = wb.SpiceWitnesses(
        memory_length=memory_length,
        initial_values_start=block.initial_value_witnesses[0],
        memory_operations=spice_ops,
        rv_final_start=rv_final_start,
        rt_final_start=rt_final_start,
        first_witness_idx=start_idx,
        num_witnesses=next_idx - start_idx)
    c.add_witness_builder(spice)

    for op_i, op in enumerate(spice_ops):
        if isinstance(op, wb.SpiceLoad):
            mem_op_index_and_rt.append((op_i, op.read_timestamp))
            factor = _add_mem_op_multiset_factor(
                c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                (1, op.addr), op.value, (1, op.read_timestamp))
            rs_hash = c.add_product(rs_hash, factor)
            factor = _add_mem_op_multiset_factor(
                c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                (1, op.addr), op.value, (op_i + 1, c.witness_one))
            ws_hash = c.add_product(ws_hash, factor)
        else:
            mem_op_index_and_rt.append((op_i, op.read_timestamp))
            factor = _add_mem_op_multiset_factor(
                c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                (1, op.addr), op.old_value, (1, op.read_timestamp))
            rs_hash = c.add_product(rs_hash, factor)
            factor = _add_mem_op_multiset_factor(
                c, sz_challenge, rs_challenge, rs_challenge_sqrd,
                (1, op.addr), op.new_value, (op_i + 1, c.witness_one))
            ws_hash = c.add_product(ws_hash, factor)

    # AUDIT: read-set factors for final state
    for addr in range(memory_length):
        value_witness = rv_final_start + addr
        rt_witness = rt_final_start + addr
        mem_op_index_and_rt.append((len(block.operations), rt_witness))
        factor = _add_mem_op_multiset_factor(
            c, sz_challenge, rs_challenge, rs_challenge_sqrd,
            (addr, c.witness_one), value_witness, (1, rt_witness))
        rs_hash = c.add_product(rs_hash, factor)

    c.r1cs.add_constraint([(1, c.witness_one)], [(1, rs_hash)], [(1, ws_hash)])

    # ceil(log2(ops+1)) (reference: (ops+1).next_power_of_two().ilog2())
    num_bits = len(block.operations).bit_length()
    to_range_check = []
    for op_i, rt_witness in mem_op_index_and_rt:
        diff = c.add_sum([(op_i % F.P, c.witness_one), (F.P - 1, rt_witness)])
        to_range_check.append(rt_witness)
        to_range_check.append(diff)
    return num_bits, to_range_check
