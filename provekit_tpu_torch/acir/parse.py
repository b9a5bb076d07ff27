"""Noir build-artifact parsing: JSON envelope -> ACIR Program.

Port of ``provekit_tpu/acir/parse.py``.

The artifact is JSON with a base64 ``bytecode`` field
(``tooling/cli/src/cmd/circuit_stats.rs:39-53``); the bytecode is a
gzip-compressed serialized ``Program`` (noir v1.0.0-beta.6 serializes ACIR
with msgpack; older artifacts used bincode).  This module implements the
envelope, gzip, and a self-contained msgpack decoder, then maps the decoded
document onto :mod:`provekit_tpu_torch.acir.model`.

Covered by golden artifact fixtures (tests/fixtures/*.json, generated by
scripts/make_acir_fixtures.py with the in-tree encoder ``acir.encode``):
AssertZero, RANGE/AND/XOR black boxes, ROM memory and Brillig witness
generation run the full parse -> execute -> compile -> prove path from
artifact JSON.  No nargo toolchain exists in this environment, so drift
against a specific nargo release's field names would still surface as
descriptive ``AcirParseError``s rather than silent misparses.
"""

from __future__ import annotations

import base64
import gzip
import json
import struct
from pathlib import Path

from . import brillig
from . import model as acir
from .abi import Abi


class AcirParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Minimal msgpack decoder (spec-complete for the types ACIR uses)


def _msgpack_decode(data: bytes):
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise AcirParseError("msgpack truncated")
        out = data[pos:pos + n]
        pos += n
        return out

    def u(fmt, n):
        return struct.unpack(fmt, take(n))[0]

    def value():
        b = take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {value(): value() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xC4:
            return bytes(take(take(1)[0]))
        if b == 0xC5:
            return bytes(take(u(">H", 2)))
        if b == 0xC6:
            return bytes(take(u(">I", 4)))
        if b == 0xCA:
            return u(">f", 4)
        if b == 0xCB:
            return u(">d", 8)
        if b == 0xCC:
            return take(1)[0]
        if b == 0xCD:
            return u(">H", 2)
        if b == 0xCE:
            return u(">I", 4)
        if b == 0xCF:
            return u(">Q", 8)
        if b == 0xD0:
            return u(">b", 1)
        if b == 0xD1:
            return u(">h", 2)
        if b == 0xD2:
            return u(">i", 4)
        if b == 0xD3:
            return u(">q", 8)
        if b == 0xD9:
            return take(take(1)[0]).decode("utf-8")
        if b == 0xDA:
            return take(u(">H", 2)).decode("utf-8")
        if b == 0xDB:
            return take(u(">I", 4)).decode("utf-8")
        if b == 0xDC:
            return [value() for _ in range(u(">H", 2))]
        if b == 0xDD:
            return [value() for _ in range(u(">I", 4))]
        if b == 0xDE:
            return {value(): value() for _ in range(u(">H", 2))}
        if b == 0xDF:
            return {value(): value() for _ in range(u(">I", 4))}
        raise AcirParseError(f"msgpack: unsupported tag 0x{b:02x}")

    out = value()
    if pos != len(data):
        raise AcirParseError(f"msgpack: {len(data) - pos} trailing bytes")
    return out


# ---------------------------------------------------------------------------
# Document -> model mapping


def _field_int(v) -> int:
    """ACIR field elements serialize as hex/dec strings or byte arrays."""
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    if isinstance(v, bytes):
        return int.from_bytes(v, "big")
    if isinstance(v, int):
        return v
    if isinstance(v, list) and all(isinstance(x, int) for x in v):
        return int.from_bytes(bytes(x & 0xFF for x in v), "big")
    raise AcirParseError(f"cannot interpret field element {v!r}")


def _witness(v) -> acir.Witness:
    if isinstance(v, int):
        return acir.Witness(v)
    if isinstance(v, dict) and len(v) == 1:
        return acir.Witness(next(iter(v.values())))
    if isinstance(v, list) and len(v) == 1:
        return acir.Witness(v[0])
    raise AcirParseError(f"cannot interpret witness {v!r}")


def _variant(v):
    """Enum encodings: {"Name": payload} or "Name"."""
    if isinstance(v, str):
        return v, None
    if isinstance(v, dict) and len(v) == 1:
        k = next(iter(v))
        return k, v[k]
    raise AcirParseError(f"cannot interpret enum {v!r}")


def _expression(doc) -> acir.Expression:
    mul = [(_field_int(c), _witness(a), _witness(b))
           for c, a, b in doc.get("mul_terms", [])]
    lin = [(_field_int(c), _witness(w))
           for c, w in doc.get("linear_combinations", [])]
    return acir.Expression(mul_terms=mul, linear_combinations=lin,
                           q_c=_field_int(doc.get("q_c", 0)))


def _function_input(doc) -> acir.FunctionInput:
    # { "input": {"Witness": n} | {"Constant": field}, "num_bits": k }
    inp = doc.get("input", doc)
    num_bits = doc.get("num_bits", 254)
    kind, payload = _variant(inp) if not isinstance(inp, int) else ("Witness", inp)
    if kind == "Witness":
        return acir.FunctionInput(_witness(payload), num_bits)
    if kind == "Constant":
        return acir.FunctionInput(_field_int(payload), num_bits)
    raise AcirParseError(f"unknown FunctionInput {doc!r}")


def _blackbox(payload) -> acir.Opcode:
    kind, body = _variant(payload)
    if kind == "RANGE":
        return acir.BlackBoxRange(_function_input(body["input"]))
    if kind in ("AND", "XOR"):
        cls = acir.BlackBoxAnd if kind == "AND" else acir.BlackBoxXor
        return cls(_function_input(body["lhs"]), _function_input(body["rhs"]),
                   _witness(body["output"]))
    return acir.BlackBoxUnsupported(kind, body)


def _brillig_input(doc):
    kind, payload = _variant(doc)
    if kind == "Single":
        return acir.BrilligInputSingle(_expression(payload))
    if kind == "Array":
        return acir.BrilligInputArray([_expression(e) for e in payload])
    if kind == "MemoryArray":
        return acir.BrilligInputMemoryArray(_block_id(payload))
    raise AcirParseError(f"unknown BrilligInputs variant {kind}")


def _brillig_output(doc):
    kind, payload = _variant(doc)
    if kind == "Simple":
        return acir.BrilligOutputSimple(_witness(payload))
    if kind == "Array":
        return acir.BrilligOutputArray([_witness(w) for w in payload])
    raise AcirParseError(f"unknown BrilligOutputs variant {kind}")


def _opcode(doc) -> acir.Opcode:
    kind, payload = _variant(doc)
    if kind == "AssertZero":
        return acir.AssertZero(_expression(payload))
    if kind == "BrilligCall":
        return acir.BrilligCall(
            id=payload.get("id", 0),
            inputs=[_brillig_input(i) for i in payload.get("inputs", [])],
            outputs=[_brillig_output(o) for o in payload.get("outputs", [])],
            predicate=None if payload.get("predicate") is None
            else _expression(payload["predicate"]))
    if kind == "MemoryInit":
        bt, _ = _variant(payload.get("block_type", "Memory"))
        return acir.MemoryInit(
            block_id=_block_id(payload["block_id"]),
            init=[_witness(w) for w in payload["init"]],
            block_type=bt)
    if kind == "MemoryOp":
        op = payload["op"]
        return acir.MemoryOp(
            block_id=_block_id(payload["block_id"]),
            op=acir.MemOp(
                operation=_op_flag(op["operation"]),
                index=_expression(op["index"]),
                value=_expression(op["value"])),
            predicate=None if payload.get("predicate") is None
            else _expression(payload["predicate"]))
    if kind == "BlackBoxFuncCall":
        return _blackbox(payload)
    raise AcirParseError(f"unsupported opcode {kind}")


def _block_id(v) -> int:
    if isinstance(v, int):
        return v
    if isinstance(v, (list, dict)) and len(v) == 1:
        return next(iter(v.values())) if isinstance(v, dict) else v[0]
    raise AcirParseError(f"cannot interpret block id {v!r}")


def _op_flag(expr_doc) -> int:
    """MemOp.operation is an Expression equal to constant 0 (read) / 1 (write)."""
    e = _expression(expr_doc)
    if e.mul_terms or e.linear_combinations:
        raise AcirParseError("MemoryOp.operation must be constant")
    return e.q_c


def _public_inputs(v) -> list[int]:
    if isinstance(v, list):
        return [w.index if isinstance(w, acir.Witness) else
                (_witness(w).index) for w in v]
    if isinstance(v, dict) and len(v) == 1:
        return _public_inputs(next(iter(v.values())))
    raise AcirParseError(f"cannot interpret public inputs {v!r}")


def _circuit(doc) -> acir.Circuit:
    return acir.Circuit(
        opcodes=[_opcode(op) for op in doc["opcodes"]],
        private_parameters=_public_inputs(doc.get("private_parameters", [])),
        public_parameters=_public_inputs(doc.get("public_parameters", [])),
        return_values=_public_inputs(doc.get("return_values", [])),
        current_witness_index=doc.get("current_witness_index", 0))


# ---------------------------------------------------------------------------
# Brillig bytecode decoding (unconstrained functions)


_INT_BITS = {"U0": 0, "U1": 1, "U8": 8, "U16": 16, "U32": 32, "U64": 64,
             "U128": 128}


def _brillig_addr(doc) -> brillig.MemoryAddress:
    if isinstance(doc, int):  # pre-relative-addressing era
        return brillig.MemoryAddress.direct(doc)
    kind, payload = _variant(doc)
    if kind == "Direct":
        return brillig.MemoryAddress.direct(payload)
    if kind == "Relative":
        return brillig.MemoryAddress(payload, relative=True)
    raise AcirParseError(f"unknown MemoryAddress {doc!r}")


def _bit_size(doc):
    """BitSize: "Field" | {"Integer": "U32"}; or bare "U32" (IntegerBitSize)."""
    if isinstance(doc, str):
        if doc == "Field":
            return brillig.FIELD
        if doc in _INT_BITS:
            return _INT_BITS[doc]
        raise AcirParseError(f"unknown bit size {doc!r}")
    kind, payload = _variant(doc)
    if kind == "Integer":
        return _INT_BITS[payload]
    raise AcirParseError(f"unknown BitSize {doc!r}")


def _int_bits(doc) -> int:
    bs = _bit_size(doc)
    if bs == brillig.FIELD:
        raise AcirParseError("integer bit size expected, got Field")
    return bs


def _heap_vector(doc) -> brillig.HeapVector:
    return brillig.HeapVector(pointer=_brillig_addr(doc["pointer"]),
                              size=_brillig_addr(doc["size"]))


def _value_or_array(doc):
    kind, payload = _variant(doc)
    if kind == "MemoryAddress":
        return _brillig_addr(payload)
    if kind == "HeapArray":
        return brillig.HeapArray(pointer=_brillig_addr(payload["pointer"]),
                                 size=payload["size"])
    if kind == "HeapVector":
        return _heap_vector(payload)
    raise AcirParseError(f"unknown ValueOrArray {doc!r}")


def _brillig_blackbox(payload):
    kind, body = _variant(payload)
    if kind == "ToRadix":
        return brillig.ToRadix(
            input=_brillig_addr(body["input"]),
            radix=_brillig_addr(body["radix"]),
            output_pointer=_brillig_addr(body["output_pointer"]),
            num_limbs=body["num_limbs"],
            output_bits=bool(body.get("output_bits", False)))
    return brillig.BlackBoxOther(kind, body)


def _brillig_opcode(doc):
    kind, p = _variant(doc)
    B = brillig
    if kind == "BinaryFieldOp":
        op, _ = _variant(p["op"])
        return B.BinaryFieldOp(_brillig_addr(p["destination"]), op,
                               _brillig_addr(p["lhs"]), _brillig_addr(p["rhs"]))
    if kind == "BinaryIntOp":
        op, _ = _variant(p["op"])
        return B.BinaryIntOp(_brillig_addr(p["destination"]), op,
                             _int_bits(p["bit_size"]),
                             _brillig_addr(p["lhs"]), _brillig_addr(p["rhs"]))
    if kind == "Not":
        return B.Not(_brillig_addr(p["destination"]),
                     _brillig_addr(p["source"]), _int_bits(p["bit_size"]))
    if kind == "Cast":
        return B.Cast(_brillig_addr(p["destination"]),
                      _brillig_addr(p["source"]), _bit_size(p["bit_size"]))
    if kind == "Jump":
        return B.Jump(p["location"])
    if kind == "JumpIf":
        return B.JumpIf(_brillig_addr(p["condition"]), p["location"])
    if kind == "JumpIfNot":
        return B.JumpIfNot(_brillig_addr(p["condition"]), p["location"])
    if kind == "CalldataCopy":
        return B.CalldataCopy(_brillig_addr(p["destination_address"]),
                              _brillig_addr(p["size_address"]),
                              _brillig_addr(p["offset_address"]))
    if kind == "Call":
        return B.Call(p["location"])
    if kind == "Const":
        return B.Const(_brillig_addr(p["destination"]),
                       _bit_size(p["bit_size"]), _field_int(p["value"]))
    if kind == "IndirectConst":
        return B.IndirectConst(_brillig_addr(p["destination_pointer"]),
                               _bit_size(p["bit_size"]),
                               _field_int(p["value"]))
    if kind == "Return":
        return B.Return()
    if kind == "ForeignCall":
        return B.ForeignCall(
            function=p["function"],
            destinations=[_value_or_array(d) for d in p.get("destinations", [])],
            destination_value_types=p.get("destination_value_types", []),
            inputs=[_value_or_array(i) for i in p.get("inputs", [])],
            input_value_types=p.get("input_value_types", []))
    if kind == "Mov":
        return B.Mov(_brillig_addr(p["destination"]),
                     _brillig_addr(p["source"]))
    if kind == "ConditionalMov":
        return B.ConditionalMov(_brillig_addr(p["destination"]),
                                _brillig_addr(p["source_a"]),
                                _brillig_addr(p["source_b"]),
                                _brillig_addr(p["condition"]))
    if kind == "Load":
        return B.Load(_brillig_addr(p["destination"]),
                      _brillig_addr(p["source_pointer"]))
    if kind == "Store":
        return B.Store(_brillig_addr(p["destination_pointer"]),
                       _brillig_addr(p["source"]))
    if kind == "BlackBox":
        return _brillig_blackbox(p)
    if kind == "Trap":
        rd = p.get("revert_data") if isinstance(p, dict) else None
        return B.Trap(None if rd is None else _heap_vector(rd))
    if kind == "Stop":
        rd = p.get("return_data") if isinstance(p, dict) else None
        return B.Stop(None if rd is None else _heap_vector(rd))
    raise AcirParseError(f"unknown Brillig opcode {kind}")


def _unconstrained_function(doc) -> brillig.BrilligBytecode:
    body = doc.get("bytecode", doc) if isinstance(doc, dict) else doc
    return brillig.BrilligBytecode(
        bytecode=[_brillig_opcode(op) for op in body])


def program_from_doc(doc) -> acir.Program:
    return acir.Program(
        functions=[_circuit(f) for f in doc["functions"]],
        unconstrained_functions=[
            _unconstrained_function(f)
            for f in doc.get("unconstrained_functions", [])])


def parse_bytecode(bytecode: bytes) -> acir.Program:
    if bytecode[:2] == b"\x1f\x8b":
        bytecode = gzip.decompress(bytecode)
    try:
        doc = _msgpack_decode(bytecode)
    except AcirParseError as e:
        raise AcirParseError(
            f"could not decode ACIR bytecode as msgpack ({e}); bincode-era "
            "artifacts are not yet supported — recompile with nargo >= "
            "1.0.0-beta.4 or supply provekit-tpu circuit JSON") from e
    return program_from_doc(doc)


def parse_artifact(doc_or_path) -> acir.Program:
    """Parse a Noir build artifact (dict or path to JSON)."""
    if isinstance(doc_or_path, (str, Path)):
        doc = json.loads(Path(doc_or_path).read_text())
    else:
        doc = doc_or_path
    if "bytecode" not in doc:
        raise AcirParseError("artifact has no bytecode field")
    return parse_bytecode(base64.b64decode(doc["bytecode"]))


def artifact_abi(doc_or_path) -> Abi:
    if isinstance(doc_or_path, (str, Path)):
        doc = json.loads(Path(doc_or_path).read_text())
    else:
        doc = doc_or_path
    return Abi.from_json(doc.get("abi", {}))
