"""Compact binary body encoding for artifacts (postcard-discipline).

The reference serializes ``.nps``/``.np`` bodies with Rust ``postcard``
(LEB128 varints, length-prefixed sequences, no self-description beyond the
schema — ``provekit/common/src/file/bin.rs:16-111``).  This is the same
encoding discipline applied to the provekit-tpu document tree: tagged nodes,
zigzag LEB128 varints, length-prefixed strings/bytes/sequences, and a raw
little-endian u32-array fast path for the sparse-matrix index vectors.

Byte-compatibility with Rust postcard is not claimed (the Rust struct
layouts belong to external git dependencies that are not vendored in the
reference); the format here is versioned independently (header byte 'B1').
"""

from __future__ import annotations

import struct

MAGIC = b"PKB1"

_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03      # zigzag LEB128
_T_BIGINT = 0x04   # sign byte + length + LE magnitude
_T_STR = 0x05
_T_BYTES = 0x06
_T_LIST = 0x07
_T_MAP = 0x08
_T_U32S = 0x09     # count + raw LE u32 payload
_T_FLOAT = 0x0A    # f64 BE (WHIR pow_bits are floats)


def _uvarint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1 | 1


def _unzigzag(z: int) -> int:
    return (z >> 1) ^ -(z & 1)


def _enc_node(obj, out: bytearray, strs: dict) -> None:
    # the node kinds are disjoint (bool before int), so testing the common
    # ones first changes no byte; ``strs`` holds the encodings of short
    # strings (the field names) already written
    if obj is None:
        out.append(_T_NONE)
    elif obj is False:
        out.append(_T_FALSE)
    elif obj is True:
        out.append(_T_TRUE)
    elif isinstance(obj, int):
        if 0 <= obj < 0x40:
            out += bytes((_T_INT, obj << 1))
        elif -(1 << 62) <= obj < (1 << 62):
            out.append(_T_INT)
            _uvarint(_zigzag(obj), out)
        else:
            out.append(_T_BIGINT)
            mag = abs(obj)
            raw = mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "little")
            out.append(1 if obj < 0 else 0)
            _uvarint(len(raw), out)
            out.extend(raw)
    elif isinstance(obj, str):
        node = strs.get(obj)
        if node is None:
            raw = obj.encode("utf-8")
            node = bytearray((_T_STR,))
            _uvarint(len(raw), node)
            node += raw
            if len(obj) < 64:
                strs[obj] = node
        out += node
    elif isinstance(obj, dict):
        out.append(_T_MAP)
        _uvarint(len(obj), out)
        for k, v in obj.items():
            _enc_node(k, out, strs)
            _enc_node(v, out, strs)
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST)
        _uvarint(len(obj), out)
        for v in obj:
            _enc_node(v, out, strs)
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack(">d", obj))
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        _uvarint(len(obj), out)
        out.extend(obj)
    elif isinstance(obj, U32Array):
        out.append(_T_U32S)
        _uvarint(len(obj.raw) // 4, out)
        out.extend(obj.raw)
    else:
        raise TypeError(f"cannot binary-encode {type(obj).__name__}")


class U32Array:
    """Marker wrapper: a u32 vector stored as raw LE bytes."""

    __slots__ = ("raw",)

    def __init__(self, values=None, raw: bytes = b""):
        if values is not None:
            import numpy as np
            self.raw = np.asarray(values, dtype="<u4").tobytes()
        else:
            self.raw = raw

    def tolist(self) -> list[int]:
        import numpy as np
        return np.frombuffer(self.raw, dtype="<u4").tolist()


def encode(doc) -> bytes:
    out = bytearray(MAGIC)
    _enc_node(doc, out, {})
    return bytes(out)


def decode(buf: bytes):
    """The document of an encoded body.  One recursive function over the
    buffer: a node's bytes are read in place, one-byte varints take no
    loop, and short strings are decoded once and shared."""
    if buf[:4] != MAGIC:
        raise ValueError("not a provekit-tpu binary body")
    n = len(buf)
    strs = {}

    def uvarint(pos):
        b = buf[pos]
        if b < 0x80:
            return b, pos + 1
        val, shift = b & 0x7F, 7
        while True:
            if shift > 91:
                raise ValueError("varint too long")
            pos += 1
            b = buf[pos]
            val |= (b & 0x7F) << shift
            if b < 0x80:
                return val, pos + 1
            shift += 7

    def take(pos, size):
        end = pos + size
        if end > n:
            raise ValueError("binary body truncated")
        return buf[pos:end], end

    def node(pos):
        t = buf[pos]
        pos += 1
        if t == _T_INT:
            z = buf[pos]
            if z < 0x80:
                return (z >> 1) ^ -(z & 1), pos + 1
            z, pos = uvarint(pos)
            return _unzigzag(z), pos
        if t == _T_STR:
            size = buf[pos]
            if size < 0x80:
                pos += 1
            else:
                size, pos = uvarint(pos)
            raw, pos = take(pos, size)
            s = strs.get(raw)
            if s is None:
                s = raw.decode("utf-8")
                if size < 64:
                    strs[raw] = s
            return s, pos
        if t == _T_MAP:
            count, pos = uvarint(pos)
            out = {}
            for _ in range(count):
                k, pos = node(pos)
                out[k], pos = node(pos)
            return out, pos
        if t == _T_LIST:
            count, pos = uvarint(pos)
            out = []
            append = out.append
            for _ in range(count):
                v, pos = node(pos)
                append(v)
            return out, pos
        if t == _T_NONE:
            return None, pos
        if t == _T_FALSE:
            return False, pos
        if t == _T_TRUE:
            return True, pos
        if t == _T_BIGINT:
            neg = buf[pos]
            size, pos = uvarint(pos + 1)
            raw, pos = take(pos, size)
            mag = int.from_bytes(raw, "little")
            return (-mag if neg else mag), pos
        if t == _T_FLOAT:
            raw, pos = take(pos, 8)
            return struct.unpack(">d", raw)[0], pos
        if t == _T_BYTES:
            size, pos = uvarint(pos)
            return take(pos, size)
        if t == _T_U32S:
            size, pos = uvarint(pos)
            raw, pos = take(pos, 4 * size)
            return U32Array(raw=raw), pos
        raise ValueError(f"unknown binary tag 0x{t:02x}")

    try:
        doc, pos = node(4)
    except IndexError:
        raise ValueError("binary body truncated") from None
    if pos != n:
        raise ValueError(f"{n - pos} trailing bytes in binary body")
    return doc
