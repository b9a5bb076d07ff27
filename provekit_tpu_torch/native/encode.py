"""Serialize a witness-builder program to the native solver's encoding.

Port of the JAX package's ``native/encode.py``: the same bytes for the same
program (opcodes and layout in ``solver.cpp``), so either package's encoder
feeds either package's library.  Each builder type has its own encoder,
looked up by type, that packs its fixed fields with one precompiled
``struct``; the pieces are joined once.
"""

from __future__ import annotations

import struct

from ..fields import bn254 as F
from ..r1cs import witness_builder as wb

_P = F.P
_u32 = struct.Struct("<I").pack
_op_u32 = struct.Struct("<BI").pack  # a u8 (an opcode or a flag), a u32
_op_u32x2 = struct.Struct("<BII").pack
_op_u32x3 = struct.Struct("<BIII").pack
_op_u32x4 = struct.Struct("<BIIII").pack


def _fe(v: int) -> bytes:
    return (v % _P).to_bytes(32, "little")


def _u32s(values) -> bytes:
    return struct.pack(f"<{len(values)}I", *values)


def _operand(op) -> bytes:
    kind, v = op
    if kind == "const":
        return b"\x00" + _fe(v)
    return _op_u32(1, v)


def _sum(b, out):
    out.append(_op_u32x2(2, b.witness_idx, len(b.terms)))
    for coeff, idx in b.terms:
        if coeff is None:
            out.append(_op_u32(0, idx))
        else:
            out.append(b"\x01" + _fe(coeff) + _u32(idx))


def _spice(b, out):
    out.append(b"\x0b" + _u32s([b.memory_length, b.initial_values_start,
                                b.rv_final_start, b.rt_final_start,
                                len(b.memory_operations)]))
    for op in b.memory_operations:
        if isinstance(op, wb.SpiceLoad):
            out.append(_op_u32x3(0, op.addr, op.value, op.read_timestamp))
        else:
            out.append(_op_u32x4(1, op.addr, op.old_value, op.new_value,
                                 op.read_timestamp))


def _binop_multiplicities(b, out):
    out.append(_op_u32x2(14, b.witness_idx, len(b.operands)))
    for lhs, rhs in b.operands:
        out.append(_operand(lhs))
        out.append(_operand(rhs))


_ENCODERS = {
    wb.Constant: lambda b, out: out.append(
        _op_u32(0, b.witness_idx) + _fe(b.value)),
    wb.Acir: lambda b, out: out.append(
        _op_u32x2(1, b.witness_idx, b.acir_witness_idx)),
    wb.Sum: _sum,
    wb.Product: lambda b, out: out.append(
        _op_u32x3(3, b.witness_idx, b.a, b.b)),
    wb.MultiplicitiesForRange: lambda b, out: out.append(
        _op_u32x3(4, b.start_idx, b.range_size, len(b.value_witnesses))
        + _u32s(b.value_witnesses)),
    wb.Challenge: lambda b, out: out.append(_op_u32(5, b.witness_idx)),
    wb.IndexedLogUpDenominator: lambda b, out: out.append(
        _op_u32x2(6, b.witness_idx, b.sz_challenge) + _fe(b.index_coeff)
        + _u32s([b.index, b.rs_challenge, b.value])),
    wb.Inverse: lambda b, out: out.append(
        _op_u32x2(7, b.witness_idx, b.operand)),
    wb.ProductLinearOperation: lambda b, out: out.append(
        _op_u32x2(8, b.witness_idx, b.x) + _fe(b.a) + _fe(b.b)
        + _u32(b.y) + _fe(b.c) + _fe(b.d)),
    wb.LogUpDenominator: lambda b, out: out.append(
        _op_u32x2(9, b.witness_idx, b.sz_challenge) + _fe(b.value_coeff)
        + _u32(b.value)),
    wb.DigitalDecomposition: lambda b, out: out.append(
        _op_u32x2(10, b.first_witness_idx, len(b.log_bases))
        + bytes(b.log_bases) + _u32(len(b.witnesses_to_decompose))
        + _u32s(b.witnesses_to_decompose)),
    wb.SpiceWitnesses: _spice,
    wb.SpiceMultisetFactor: lambda b, out: out.append(
        _op_u32x3(12, b.witness_idx, b.sz_challenge, b.rs_challenge)
        + _fe(b.addr) + _u32(b.addr_witness) + _u32(b.value) + _fe(b.timer)
        + _u32(b.timer_witness)),
    wb.BinOpLookupDenominator: lambda b, out: out.append(
        _op_u32x4(13, b.witness_idx, b.sz_challenge, b.rs_challenge,
                  b.rs_challenge_sqrd)
        + _operand(b.lhs) + _operand(b.rhs) + _operand(b.output)),
    wb.MultiplicitiesForBinOp: _binop_multiplicities,
}


def encode_program(builders: list) -> bytes:
    out: list[bytes] = []
    for b in builders:
        enc = _ENCODERS.get(type(b))
        if enc is None:
            raise TypeError(f"cannot encode builder {type(b)}")
        enc(b, out)
    return b"".join(out)
