"""Noir ABI input encoding: Prover.toml -> ordered field-element inputs.

Port of ``provekit_tpu/acir/abi.py``, itself a port of
``provekit/r1cs-compiler/src/witness_generator.rs:28-128`` and the relevant
subset of the ``noirc_abi`` specification: ABI parameters are
flattened depth-first (Field, Array, Tuple, String, Struct, and integer
types) into the leading ACIR witness slots.

The ABI is carried in the Noir build artifact's ``abi`` JSON; the same
structure can be written by hand for programmatic circuits.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass

from ..fields import bn254 as F


@dataclass
class AbiParameter:
    name: str
    typ: dict  # {"kind": "field" | "integer" | "array" | "tuple" | "string" | "struct" | "boolean", ...}
    visibility: str = "private"


@dataclass
class Abi:
    parameters: list  # [AbiParameter]

    @classmethod
    def from_json(cls, doc: dict) -> "Abi":
        return cls(parameters=[
            AbiParameter(name=p["name"], typ=p["type"],
                         visibility=p.get("visibility", "private"))
            for p in doc.get("parameters", [])])

    def field_count(self) -> int:
        return sum(_type_field_count(p.typ) for p in self.parameters)


def _type_field_count(typ: dict) -> int:
    kind = typ["kind"]
    if kind in ("field", "integer", "boolean"):
        return 1
    if kind == "array":
        return typ["length"] * _type_field_count(typ["type"])
    if kind == "string":
        return typ["length"]
    if kind == "tuple":
        return sum(_type_field_count(t) for t in typ["fields"])
    if kind == "struct":
        return sum(_type_field_count(f["type"]) for f in typ["fields"])
    raise ValueError(f"unknown ABI type {kind}")


def _to_int(v) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v % F.P
    if isinstance(v, str):
        return int(v, 0) % F.P
    raise TypeError(f"cannot convert {v!r} to a field element")


def encode_input(out: list[int], value, typ: dict) -> None:
    kind = typ["kind"]
    if kind in ("field", "integer", "boolean"):
        out.append(_to_int(value))
    elif kind == "array":
        if len(value) != typ["length"]:
            raise ValueError(f"array length {len(value)} != {typ['length']}")
        for elem in value:
            encode_input(out, elem, typ["type"])
    elif kind == "tuple":
        if len(value) != len(typ["fields"]):
            raise ValueError("tuple arity mismatch")
        for elem, t in zip(value, typ["fields"]):
            encode_input(out, elem, t)
    elif kind == "string":
        if len(value) != typ["length"]:
            raise ValueError(
                f"string length {len(value)} != {typ['length']}")
        out.extend(b % F.P for b in value.encode())
    elif kind == "struct":
        obj = dict(value)
        for f in typ["fields"]:
            name = f["name"]
            if name not in obj:
                raise ValueError(f"missing struct field {name}")
            encode_input(out, obj.pop(name), f["type"])
        if obj:
            raise ValueError(f"extra struct field {next(iter(obj))}")
    else:
        raise ValueError(f"unknown ABI type {kind}")


def input_from_toml(abi: Abi, toml_text: str) -> list[int]:
    """Flattened inputs in ABI parameter order (the leading ACIR witnesses)."""
    data = tomllib.loads(toml_text)
    out: list[int] = []
    for param in abi.parameters:
        if param.name not in data:
            raise ValueError(f"missing input {param.name}")
        encode_input(out, data.pop(param.name), param.typ)
    if data:
        raise ValueError(f"extra input {next(iter(data))}")
    return out
