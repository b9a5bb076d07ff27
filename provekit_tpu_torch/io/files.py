"""Artifact file formats: .nps (compiled scheme) and .np (proof).

Port of ``provekit_tpu/io/files.py`` (the gnark export is ``gnark.py``).  It mirrors
the reference's checkpoint/artifact design
(``provekit/common/src/file/{mod.rs,bin.rs}``): versioned header
``MAGIC || format-tag || (major, minor)`` followed by a compressed body,
with a pretty-JSON alternative selected by file extension.  The binary body
uses the in-tree postcard-discipline encoding (``binenc.py``: LEB128
varints, length-prefixed sequences, raw u32-array fast path); the framing,
version gate (major must match, minor newer-or-equal) and compression
behavior match the reference.  Pre-binary (JSON-body) artifacts still read.

The body is zstd-compressed where the ``zstandard`` module is installed and
zlib-compressed where it is not; the reader tells the two apart by the
frame magic, so the file bytes of the two packages may differ while the
decompressed bodies do not.  A scheme is read for a torch ``device``: the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import base64
import gc
import json
import zlib
from contextlib import contextmanager
from dataclasses import fields, is_dataclass
from pathlib import Path

import torch

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None

# Reference header framing (file/bin.rs:17-38): 8-byte MAGIC, 8-byte ASCII
# format tag, u16le major, u16le minor — 20 bytes total, then the
# compressed body.  MAGIC matches the reference byte-for-byte; the body
# encoding is the in-tree postcard-discipline binary (binenc.py), so
# major=1 marks the provekit-tpu body revision (reference postcard bodies
# are major=0).
MAGIC = b"\xDC\xDFOZkp\x01\x00"
VERSION = (1, 0)
_LEGACY_MAGIC = b"PKTPU\x00"  # pre-round-4 artifacts (10-byte header)
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

from ..acir import abi as acir_abi
from ..acir import brillig
from ..acir import model as acir
from ..compiler.scheme import NoirProof, NoirProofScheme
from ..protocol import WhirR1CSScheme
from ..r1cs import R1CS
from ..r1cs import witness_builder as wb
from . import binenc
from .binenc import U32Array

# registry of dataclass types allowed in artifacts (witness builders, ACIR,
# Brillig bytecode, ABI); the tags are the JAX package's, so that each
# package reads the other's files
_TYPES = {}
for _mod in (wb, acir, brillig, acir_abi):
    for _name in dir(_mod):
        _obj = getattr(_mod, _name)
        if is_dataclass(_obj) and isinstance(_obj, type):
            _TYPES[f"{_mod.__name__.split('.')[-1]}.{_name}"] = _obj


def _compress(data: bytes) -> bytes:
    if _zstd is not None:
        return _zstd.ZstdCompressor(level=10).compress(data)
    return zlib.compress(data, 6)


def _decompress_body(blob: bytes) -> bytes:
    """Sniff the compressor from the frame magic (zstd vs zlib fallback)."""
    if blob[:4] == _ZSTD_MAGIC:
        if _zstd is None:
            raise ValueError(
                "the artifact body is zstd-compressed and the zstandard "
                "module is not installed; rewrite the file where it is, or "
                "with this package (zlib)")
        # streamed frames (the Rust writer's ZstdEncoder) carry no
        # content-size header; cap output rather than trusting the frame
        return _zstd.ZstdDecompressor().decompress(
            blob, max_output_size=1 << 31)
    return zlib.decompress(blob)


def require_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device needs a card (no
    fallback to the CPU: the caller asks for it with ``"cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return device


# dataclass type -> (its artifact tag, its field names in order)
_FIELD_NAMES: dict = {}


def _enc(obj):
    names = _FIELD_NAMES.get(type(obj))
    if names is None and is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        names = _FIELD_NAMES[cls] = (
            f"{cls.__module__.split('.')[-1]}.{cls.__name__}",
            tuple(f.name for f in fields(cls)))
    if names is not None:
        tag, field_names = names
        d = {"__t": tag}
        for name in field_names:
            d[name] = _enc(getattr(obj, name))
        return d
    if isinstance(obj, int) and abs(obj) >= 1 << 62:
        return {"__big": hex(obj)}
    if isinstance(obj, tuple):
        return {"__tup": [_enc(v) for v in obj]}
    if isinstance(obj, list):
        return [_enc(v) for v in obj]
    if isinstance(obj, dict):
        return {"__d": [[_enc(k), _enc(v)] for k, v in obj.items()]}
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode()}
    return obj


def _dec(obj):
    # ints and strings decode to themselves: they take no call
    if isinstance(obj, dict):
        if "__t" in obj:
            cls = _TYPES[obj["__t"]]
            kwargs = {k: v if type(v) is int else _dec(v)
                      for k, v in obj.items() if k != "__t"}
            return cls(**kwargs)
        if "__big" in obj:
            return int(obj["__big"], 16)
        if "__d" in obj:
            return {_dec(k): _dec(v) for k, v in obj["__d"]}
        if "__tup" in obj:
            return tuple(v if type(v) is int else _dec(v)
                         for v in obj["__tup"])
        if "__b" in obj:
            return base64.b64decode(obj["__b"])
        return obj
    if isinstance(obj, list):
        return [v if type(v) is int else _dec(v) for v in obj]
    return obj


@contextmanager
def _no_gc():
    """The cyclic collector off while a document of millions of containers
    (and no cycles) is built or taken apart: each of its passes would walk
    every container made so far."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _u32s_from_doc(v) -> list[int]:
    import numpy as np
    if isinstance(v, U32Array):
        return v.tolist()
    return np.frombuffer(base64.b64decode(v), dtype="<u4").tolist()


def _r1cs_to_doc(r1cs: R1CS) -> dict:
    return {
        "num_public_inputs": r1cs.num_public_inputs,
        "num_witnesses": r1cs.num_witnesses,
        "interner": [hex(v) for v in r1cs.interner.values],
        "matrices": {
            name: {
                "num_rows": m.num_rows,
                "num_cols": m.num_cols,
                "rows": U32Array(m.rows),
                "cols": U32Array(m.cols),
                "value_ids": U32Array(m.value_ids),
            } for name, m in (("a", r1cs.a), ("b", r1cs.b), ("c", r1cs.c))
        },
    }


def _jsonify(obj):
    """Replace binary-only nodes (U32Array, bytes) with JSON-safe forms."""
    if isinstance(obj, U32Array):
        return base64.b64encode(obj.raw).decode()
    if isinstance(obj, (bytes, bytearray)):
        return {"__b": base64.b64encode(obj).decode()}
    if isinstance(obj, list):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    return obj


def _r1cs_from_doc(doc: dict) -> R1CS:
    r = R1CS()
    r.num_public_inputs = doc["num_public_inputs"]
    r.num_witnesses = doc["num_witnesses"]
    for v in doc["interner"]:
        r.interner.intern(int(v, 16))
    for name in ("a", "b", "c"):
        m = getattr(r, name)
        md = doc["matrices"][name]
        m.num_rows = md["num_rows"]
        m.num_cols = md["num_cols"]
        m.rows = _u32s_from_doc(md["rows"])
        m.cols = _u32s_from_doc(md["cols"])
        m.value_ids = _u32s_from_doc(md["value_ids"])
    return r


def scheme_to_doc(scheme: NoirProofScheme) -> dict:
    return {
        "format": "NrProScm",
        "program": _enc(scheme.program),
        "r1cs": _r1cs_to_doc(scheme.r1cs),
        "acir_map": {str(k): v for k, v in scheme.acir_map.items()},
        "witness_builders": [_enc(b) for b in scheme.witness_builders],
        "whir": {
            "security_level": scheme.whir_for_witness.security_level,
            # -1 encodes "reference default" (per-config default_max_pow)
            "max_pow_bits": (-1 if scheme.whir_for_witness.max_pow_bits
                             is None else scheme.whir_for_witness.max_pow_bits),
        },
        "abi": _enc(scheme.abi),
    }


def scheme_from_doc(doc: dict, device="cuda") -> NoirProofScheme:
    assert doc["format"] == "NrProScm", "not a proof scheme file"
    device = require_device(device)
    program = _dec(doc["program"])
    r1cs = _r1cs_from_doc(doc["r1cs"])
    builders = [_dec(b) for b in doc["witness_builders"]]
    mp = doc["whir"]["max_pow_bits"]
    scheme = WhirR1CSScheme.new_for_r1cs(
        r1cs, security_level=doc["whir"]["security_level"],
        max_pow_bits=None if mp == -1 else mp, device=device)
    return NoirProofScheme(
        program=program, r1cs=r1cs,
        acir_map={int(k): v for k, v in doc["acir_map"].items()},
        witness_builders=builders, whir_for_witness=scheme,
        abi=_dec(doc.get("abi")))


def proof_to_doc(proof: NoirProof) -> dict:
    return {"format": "NPSProof", "transcript": proof.transcript}


def proof_from_doc(doc: dict) -> NoirProof:
    assert doc["format"] == "NPSProof", "not a proof file"
    t = doc["transcript"]
    if isinstance(t, dict) and "__b" in t:  # JSON form
        t = base64.b64decode(t["__b"])
    elif isinstance(t, str):  # legacy hex form
        t = bytes.fromhex(t)
    return NoirProof(transcript=t)


_FORMAT_TAGS = {"NrProScm": b"NrProScm", "NPSProof": b"NPSProof"}
_LEGACY_TAGS = {b"\x01": "NrProScm", b"\x02": "NPSProof"}


def _read_postcard_varint(data: bytes, pos: int) -> tuple[int, int]:
    """Postcard LEB128 varint (serde seq length prefix)."""
    shift = val = 0
    while True:
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


@_no_gc()
def write(path, obj) -> None:
    """Write a scheme (.nps) or proof (.np); .json extension = plain JSON."""
    path = Path(path)
    if isinstance(obj, NoirProofScheme):
        doc = scheme_to_doc(obj)
    elif isinstance(obj, NoirProof):
        doc = proof_to_doc(obj)
    else:
        raise TypeError(type(obj))
    if path.suffix == ".json":
        path.write_text(json.dumps(_jsonify(doc), indent=1))
        return
    body = binenc.encode(doc)
    header = (MAGIC + _FORMAT_TAGS[doc["format"]]
              + VERSION[0].to_bytes(2, "little")
              + VERSION[1].to_bytes(2, "little"))
    path.write_bytes(header + _compress(body))


@_no_gc()
def read(path, device="cuda"):
    """A scheme (built for ``device``) or a proof from ``path``."""
    path = Path(path)
    if path.suffix == ".json":
        doc = json.loads(path.read_text())
    else:
        blob = path.read_bytes()
        if blob[:8] == MAGIC:
            fmt = blob[8:16].decode("ascii", "replace")
            major = int.from_bytes(blob[16:18], "little")
            minor = int.from_bytes(blob[18:20], "little")
            if fmt not in _FORMAT_TAGS:
                raise ValueError(f"unknown format tag {fmt!r}")
            if major == 0:
                # A file written by the reference Rust toolchain (its
                # checked-in artifacts carry version 0.0).  Proof bodies are
                # postcard NoirProof { transcript: Vec<u8> } — one varint
                # length + raw bytes — and decode directly; scheme bodies
                # embed unvendored whir/acir struct layouts and cannot.
                body = _decompress_body(blob[20:])
                if fmt.startswith("NPSProof"):
                    n, off = _read_postcard_varint(body, 0)
                    if off + n != len(body):
                        raise ValueError(
                            "malformed Rust-postcard proof body")
                    return NoirProof(transcript=body[off:off + n])
                raise ValueError(
                    "Rust-postcard scheme bodies are not readable "
                    "(unvendored struct layouts); re-prepare instead")
            # reference gate (file/bin.rs:92-99): major must match, the
            # file's minor must be >= ours (files carry forward)
            if major != VERSION[0] or minor < VERSION[1]:
                raise ValueError(
                    f"unsupported artifact version {major}.{minor}")
            body = _decompress_body(blob[20:])
        elif blob[:6] == _LEGACY_MAGIC:  # pre-round-4 10-byte header
            fmt = _LEGACY_TAGS.get(blob[6:7])
            if fmt is None:
                raise ValueError("unknown legacy format tag")
            major, minor = blob[8], blob[9]
            if major > 1:
                raise ValueError(
                    f"unsupported artifact version {major}.{minor}")
            body = _decompress_body(blob[10:])
        else:
            raise ValueError("bad magic: not a provekit artifact")
        if body[:4] == binenc.MAGIC:
            doc = binenc.decode(body)
        else:  # pre-binary artifacts: JSON body
            doc = json.loads(body)
    if doc["format"] == "NrProScm":
        return scheme_from_doc(doc, device)
    if doc["format"] == "NPSProof":
        return proof_from_doc(doc)
    raise ValueError(f"unknown format {doc['format']}")
