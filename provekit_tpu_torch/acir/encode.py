"""Noir build-artifact encoding: Program doc -> msgpack -> gzip -> JSON.

Port of ``provekit_tpu/acir/encode.py``.

Inverse of :mod:`provekit_tpu_torch.acir.parse` for the document shapes that
module understands (noir >= 1.0.0-beta.6 serializes ACIR Programs with
msgpack inside a gzip-compressed base64 ``bytecode`` field of the build
JSON — reference surface ``tooling/cli/src/cmd/circuit_stats.rs:39-53``).

Two uses:

* producing golden artifact fixtures for the parse -> execute -> compile ->
  prove pipeline tests (``tests/fixtures/``), and
* re-emitting circuits built with the in-tree builders as standard Noir
  artifact JSON.
"""

from __future__ import annotations

import base64
import gzip
import json
import struct


def msgpack_encode(obj) -> bytes:
    """Spec-compliant msgpack for the types ACIR documents use."""
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _enc_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n <= 0x1F:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes([0xD9, n])
        elif n <= 0xFFFF:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n <= 0xFF:
            out += bytes([0xC4, n])
        elif n <= 0xFFFF:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += bytes(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n <= 0x0F:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n <= 0x0F:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _enc_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += bytes([0xCC, v])
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(
            "field elements must be encoded as hex strings, not raw ints")


def field_hex(v: int) -> str:
    """Field-element wire form: 0x-hex string (parse._field_int accepts it)."""
    return hex(v)


def encode_bytecode(program_doc: dict) -> bytes:
    """Program document -> gzip(msgpack(doc)) bytes."""
    return gzip.compress(msgpack_encode(program_doc), mtime=0)


def artifact_json(program_doc: dict, abi_doc: dict,
                  noir_version: str = "1.0.0-beta.6") -> dict:
    """Full build-artifact JSON envelope (what ``parse_artifact`` reads)."""
    return {
        "noir_version": noir_version,
        "hash": 0,
        "abi": abi_doc,
        "bytecode": base64.b64encode(encode_bytecode(program_doc)).decode(),
        "debug_symbols": "",
        "file_map": {},
        "names": ["main"],
    }


def write_artifact(path, program_doc: dict, abi_doc: dict) -> None:
    import pathlib
    pathlib.Path(path).write_text(
        json.dumps(artifact_json(program_doc, abi_doc), indent=1))
