"""ctypes binding for the port's host library (``native/solver.cpp``).

The port's native host code is two libraries that ``build.py`` compiles
with ``g++`` from this package's own sources at first use: the curve engine
(``curve.py``) and the host library bound here, the counterpart of the JAX
package's native binding.  ``solve_witness`` runs a witness program
(``encode.py``) with its witness sponge; ``permute`` and ``compress`` are
the Skyscraper permutation and 2-to-1 compression on canonical ints, which
the host sponge (``fs/sponge.py``) and proof-of-work checks (``ops/pow.py``)
call; ``merkle_verify`` checks a Merkle path (``ops/merkle.py``).  There
is no fallback: a library that cannot be built raises, and says why.  The
plain versions stay in Python (``hash/skyscraper.py``,
``merkle.verify_path_plain``, ``witness_builder.solve``) for the tests to
hold these to.
"""

from __future__ import annotations

import ctypes
import threading
from itertools import repeat

import numpy as np

from ..fields import bn254 as F

_P = F.P
# pk_solve_witness's error codes (solver.cpp)
ERRORS = {
    1: "unknown opcode",
    2: "witness index out of range",
    3: "ACIR witness missing",
    4: "range-checked value out of its range",
    5: "inverse of zero",
    6: "value does not fit its digital decomposition",
    7: "memory address out of range",
    8: "binary-op operand out of range",
    9: "truncated program",
}

_lock = threading.Lock()
_lib = None


def load():
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            from . import build
            lib = ctypes.CDLL(str(build.make(build.HOST)))
            p, size, u32 = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32
            lib.pk_solve_witness.restype = ctypes.c_int
            lib.pk_solve_witness.argtypes = [
                p, size,                # program
                ctypes.c_void_p, p, size,  # ACIR indices (u32), values (fe)
                u32,                    # number of witnesses
                p,                      # the witness sponge's iv[32]
                p, size,                # seed scalars
                p, p,                   # out: witnesses, solved mask
                ctypes.POINTER(ctypes.c_uint64)]  # out: failing builder
            lib.pk_compress.restype = None
            lib.pk_compress.argtypes = [p, p, p]
            lib.pk_permute.restype = None
            lib.pk_permute.argtypes = [p]
            lib.pk_merkle_verify.restype = ctypes.c_int
            lib.pk_merkle_verify.argtypes = [p, u32, p, u32,
                                             ctypes.c_uint64, p]
            _lib = lib
    return _lib


def _fe(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _fes(values) -> bytes:
    return b"".join(map(int.to_bytes, values, repeat(32), repeat("little")))


def compress(l: int, r: int) -> int:
    """Skyscraper's 2-to-1 compression of canonical ``l`` and ``r``."""
    out = ctypes.create_string_buffer(32)
    load().pk_compress(_fe(l), _fe(r), out)
    return int.from_bytes(out.raw, "little")


def permute(l: int, r: int) -> tuple[int, int]:
    """The Skyscraper permutation of the canonical state ``(l, r)``."""
    buf = ctypes.create_string_buffer(_fe(l) + _fe(r), 64)
    load().pk_permute(buf)
    raw = buf.raw
    return (int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:], "little"))


def merkle_verify(leaf_values: list[int], path: list[int], index: int,
                  root: int) -> bool:
    """Whether the leaf's values, folded left to right, climb ``path``
    (siblings bottom-up) from ``index`` to ``root``."""
    return bool(load().pk_merkle_verify(
        _fes(leaf_values), len(leaf_values), _fes(path), len(path), index,
        _fe(root)))


def solve_witness(program: bytes, acir_values: dict[int, int],
                  num_witnesses: int, iv: bytes,
                  seed_scalars: list[int]) -> list:
    """Run an encoded witness program: the witness list, ``None`` where no
    builder wrote.  The witness sponge starts from ``iv`` and absorbs
    ``seed_scalars``.  An inverse of zero raises ``ZeroDivisionError``;
    every other failure ``RuntimeError`` naming its code and builder."""
    if len(iv) != 32:
        raise ValueError(f"the witness sponge's iv is 32 bytes, not {len(iv)}")
    lib = load()
    n_acir = len(acir_values)
    indices = np.fromiter(acir_values.keys(), np.uint32, n_acir)
    values = _fes(v % _P for v in acir_values.values())
    out_w = ctypes.create_string_buffer(32 * num_witnesses)
    out_m = ctypes.create_string_buffer(num_witnesses)
    builder = ctypes.c_uint64()
    rc = lib.pk_solve_witness(
        program, len(program), indices.ctypes.data, values, n_acir,
        num_witnesses, iv, _fes(v % _P for v in seed_scalars),
        len(seed_scalars), out_w, out_m, ctypes.byref(builder))
    if rc == 5:
        raise ZeroDivisionError(
            f"inverse of zero in Fr (witness builder {builder.value})")
    if rc != 0:
        raise RuntimeError(
            f"native witness solve failed with code {rc}, "
            f"{ERRORS.get(rc, 'unknown code')}, at witness builder "
            f"{builder.value}")
    witness = list(map(int.from_bytes, np.frombuffer(out_w, "V32").tolist(),
                       repeat("little")))
    for i in np.flatnonzero(np.frombuffer(out_m, np.uint8) == 0).tolist():
        witness[i] = None
    return witness
