"""The port's binary body encoding (``provekit_tpu_torch.io.binenc``)
against the JAX package's, byte for byte.

The port's encoder and decoder take shortcuts of their own (one-byte
integers, shared encodings of repeated short strings, one-byte varints read
in place), so every kind of node, at the edges of each shortcut, must
encode to the JAX package's bytes and decode back to itself, and a
malformed body must be refused with the JAX package's message.
"""

import random

import pytest

from provekit_tpu.io import binenc as JB
from provekit_tpu_torch.io import binenc as B

# name -> a document of that kind of node
DOCS = {
    "none_and_bools": [None, False, True, [None, [False, True]]],
    "small_ints": list(range(-3, 70)),
    "varint_ints": [64, 127, 128, 255, 16383, 16384, -65, -(1 << 40),
                    (1 << 62) - 1, -(1 << 62)],
    "big_ints": [1 << 62, -(1 << 62) - 1, 1 << 255, -(1 << 300), 2 ** 64],
    "strings": ["", "a", "x" * 63, "y" * 64, "z" * 200, "πρόοδος",
                "a", "x" * 63, "y" * 64],
    "bytes": [b"", b"\0", bytes(range(256)), bytearray(b"abc")],
    "floats": [0.0, -0.0, 1.5, 2.0 ** -40, 1e300, 24.0],
    "u32_arrays": [B.U32Array([]), B.U32Array([0, 1, 0xFFFFFFFF]),
                   B.U32Array(list(range(1000)))],
    "nested_maps": {"name": "scheme", "rounds": [{"k": i, "pow": i / 3}
                                                 for i in range(5)],
                    "empty": {}, "": [], "n": -1},
}


def _jax_doc(doc):
    """The same document with the JAX package's U32Array marker."""
    if isinstance(doc, B.U32Array):
        return JB.U32Array(raw=doc.raw)
    if isinstance(doc, dict):
        return {k: _jax_doc(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_jax_doc(v) for v in doc]
    return doc


def _plain(doc):
    """A decoded document with its u32 arrays as lists, for comparing."""
    if isinstance(doc, (B.U32Array, JB.U32Array)):
        return ("u32", doc.tolist())
    if isinstance(doc, dict):
        return {k: _plain(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_plain(v) for v in doc]
    if isinstance(doc, bytearray):
        return bytes(doc)
    return doc


@pytest.mark.parametrize("kind", sorted(DOCS))
def test_body_bytes_are_jax_bytes(kind):
    doc = DOCS[kind]
    body = B.encode(doc)
    assert body == JB.encode(_jax_doc(doc))
    assert _plain(B.decode(body)) == _plain(doc)
    assert _plain(B.decode(body)) == _plain(JB.decode(body))


def test_random_documents_are_jax_bytes():
    rng = random.Random(12)

    def leaf():
        return rng.choice([
            rng.randrange(-(1 << 70), 1 << 70), rng.randrange(64), None,
            rng.random() < 0.5, f"f{rng.randrange(8)}", rng.random(),
            bytes(rng.randrange(256) for _ in range(rng.randrange(5)))])

    def tree(depth):
        if depth == 0 or rng.random() < 0.3:
            return leaf()
        if rng.random() < 0.5:
            return [tree(depth - 1) for _ in range(rng.randrange(4))]
        return {f"k{rng.randrange(6)}": tree(depth - 1)
                for _ in range(rng.randrange(4))}

    for _ in range(50):
        doc = tree(4)
        body = B.encode(doc)
        assert body == JB.encode(doc)
        assert B.decode(body) == JB.decode(body) == doc


def _long_varint_body() -> bytes:
    return B.MAGIC + bytes([0x07]) + bytes([0xFF] * 20) + bytes([0x01])


# name -> a malformed body
MALFORMED = {
    "magic": lambda: b"PKB0" + B.encode(1)[4:],
    "truncated_string": lambda: B.encode("abcdef")[:-2],
    "truncated_list": lambda: B.encode([1, 2, 3])[:-1],
    "trailing": lambda: B.encode({"a": 1}) + b"\0\0",
    "unknown_tag": lambda: B.MAGIC + bytes([0x42]),
    "long_varint": _long_varint_body,
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_bodies_are_refused_as_jax_refuses_them(case):
    body = MALFORMED[case]()
    with pytest.raises(ValueError) as want:
        JB.decode(body)
    with pytest.raises(ValueError) as got:
        B.decode(body)
    assert str(got.value) == str(want.value)


def test_unencodable_values_are_refused_as_jax_refuses_them():
    for value in (object(), {1.5j}, complex(1, 2)):
        with pytest.raises(TypeError) as want:
            JB.encode(value)
        with pytest.raises(TypeError) as got:
            B.encode(value)
        assert str(got.value) == str(want.value)
