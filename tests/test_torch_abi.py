"""The port's Noir ABI input encoding (``provekit_tpu_torch.acir.abi``)
against the JAX package's, exactly.

A ``Prover.toml`` and the circuit's ABI give the leading witnesses of a
proof, flattened depth first.  Each ABI below, with its inputs, must give
the JAX package's field elements and field count, and an input that does
not fit its ABI must be refused with the JAX package's message.
"""

import pytest

from provekit_tpu.acir import abi as JA
from provekit_tpu_torch.acir import abi as A
from provekit_tpu_torch.fields import bn254 as F

FIELD = {"kind": "field"}
U8 = {"kind": "integer", "sign": "unsigned", "width": 8}
BOOL = {"kind": "boolean"}


def param(name, typ, visibility="private"):
    return {"name": name, "type": typ, "visibility": visibility}


# name -> (ABI parameters, Prover.toml text)
CASES = {
    "scalars": ([param("x", FIELD), param("y", U8, "public"),
                 param("ok", BOOL)],
                f'x = "{F.P - 1}"\ny = 255\nok = true\n'),
    "arrays_and_strings": (
        [param("xs", {"kind": "array", "length": 3, "type": FIELD}),
         param("s", {"kind": "string", "length": 5})],
        'xs = ["0x10", "17", 18]\ns = "hello"\n'),
    "tuples_and_structs": (
        [param("t", {"kind": "tuple", "fields": [FIELD, U8]}),
         param("p", {"kind": "struct", "path": "Point", "fields": [
             {"name": "x", "type": FIELD}, {"name": "y", "type": FIELD}]})],
        't = ["1", 2]\n[p]\ny = "4"\nx = "3"\n'),
    "nested": (
        [param("rows", {"kind": "array", "length": 2, "type": {
            "kind": "struct", "path": "Row", "fields": [
                {"name": "id", "type": U8},
                {"name": "vals", "type": {"kind": "array", "length": 2,
                                          "type": FIELD}}]}})],
        '[[rows]]\nid = 1\nvals = ["5", "6"]\n'
        '[[rows]]\nid = 2\nvals = ["7", "-1"]\n'),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_inputs_are_the_jax_inputs(name):
    params, toml = CASES[name]
    doc = {"parameters": params}
    abi, jabi = A.Abi.from_json(doc), JA.Abi.from_json(doc)
    got = A.input_from_toml(abi, toml)
    assert got == JA.input_from_toml(jabi, toml)
    assert len(got) == abi.field_count() == jabi.field_count()
    assert all(0 <= v < F.P for v in got)


# name -> (ABI parameters, Prover.toml text) that do not fit
REFUSED = {
    "array_length": ([param("xs", {"kind": "array", "length": 3,
                                   "type": FIELD})], 'xs = ["1", "2"]\n'),
    "tuple_arity": ([param("t", {"kind": "tuple", "fields": [FIELD]})],
                    't = ["1", "2"]\n'),
    "string_length": ([param("s", {"kind": "string", "length": 2})],
                      's = "abc"\n'),
    "missing_struct_field": (
        [param("p", {"kind": "struct", "fields": [
            {"name": "x", "type": FIELD}, {"name": "y", "type": FIELD}]})],
        '[p]\nx = "1"\n'),
    "extra_struct_field": (
        [param("p", {"kind": "struct", "fields": [
            {"name": "x", "type": FIELD}]})],
        '[p]\nx = "1"\nz = "2"\n'),
    "missing_input": ([param("x", FIELD), param("y", FIELD)], 'x = "1"\n'),
    "extra_input": ([param("x", FIELD)], 'x = "1"\ny = "2"\n'),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_inputs_that_do_not_fit_are_refused_as_jax_refuses_them(name):
    params, toml = REFUSED[name]
    doc = {"parameters": params}
    with pytest.raises(ValueError) as want:
        JA.input_from_toml(JA.Abi.from_json(doc), toml)
    with pytest.raises(ValueError) as got:
        A.input_from_toml(A.Abi.from_json(doc), toml)
    assert str(got.value) == str(want.value)
