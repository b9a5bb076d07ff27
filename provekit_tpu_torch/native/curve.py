"""ctypes binding for the port's host curve engine (``native/curve.cpp``).

Port of the JAX package's binding of the same name: BN254 G1/G2 fixed-base
batches, Pippenger MSMs and the radix-2 Fr NTT, the host work of the
Groth16 wrap (``recursion/groth16.py``). The library builds from this
package's own copy of ``curve.cpp`` at first use (``native/build.py``: with
``g++``, into ``build/provekit_tpu_torch/``). There is no fallback: a
library that cannot be built or loaded raises, and says why.

Marshalling: points travel as canonical little-endian affine bytes
(G1 = x||y, 64 B; G2 = x.c0||x.c1||y.c0||y.c1, 128 B; infinity = zeros),
matching the tuple representation of recursion/curve.py (G1 = (x, y) ints,
G2 = ((c0, c1), (c0, c1)), None = infinity).
"""

from __future__ import annotations

import ctypes
import threading

from . import build as NB

_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

_lock = threading.Lock()
_lib = None


def load():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(NB.make(NB.CURVE)))
            for name in ("pk_g1_mul_base_batch", "pk_g2_mul_base_batch",
                         "pk_g1_msm", "pk_g2_msm"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_size_t, ctypes.c_char_p]
            lib.pk_fr_ntt.restype = ctypes.c_int
            lib.pk_fr_ntt.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_int]
            _lib = lib
    return _lib


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")


# -- marshalling ---------------------------------------------------------------


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    x, y = pt
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def _g1_from(buf: bytes, off: int):
    x = int.from_bytes(buf[off:off + 32], "little")
    y = int.from_bytes(buf[off + 32:off + 64], "little")
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "little") for v in (x0, x1, y0, y1))


def _g2_from(buf: bytes, off: int):
    from ..recursion.fq import Fq2
    vals = [int.from_bytes(buf[off + 32 * i:off + 32 * (i + 1)], "little")
            for i in range(4)]
    if not any(vals):
        return None
    return (Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]))


def _scalars_bytes(scalars) -> bytes:
    return b"".join((s % _R).to_bytes(32, "little") for s in scalars)


# -- API -------------------------------------------------------------------------


def g1_mul_base_batch(base, scalars: list[int]) -> list:
    lib = load()
    out = ctypes.create_string_buffer(64 * len(scalars))
    _check("pk_g1_mul_base_batch", lib.pk_g1_mul_base_batch(
        _g1_bytes(base), _scalars_bytes(scalars), len(scalars), out))
    raw = out.raw  # one copy; .raw per access is O(n) each
    return [_g1_from(raw, 64 * i) for i in range(len(scalars))]


def g2_mul_base_batch(base, scalars: list[int]) -> list:
    lib = load()
    out = ctypes.create_string_buffer(128 * len(scalars))
    _check("pk_g2_mul_base_batch", lib.pk_g2_mul_base_batch(
        _g2_bytes(base), _scalars_bytes(scalars), len(scalars), out))
    raw = out.raw
    return [_g2_from(raw, 128 * i) for i in range(len(scalars))]


def _same_length(points: list, scalars: list[int]) -> None:
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")


def g1_msm(points: list, scalars: list[int]):
    _same_length(points, scalars)
    lib = load()
    out = ctypes.create_string_buffer(64)
    pts = b"".join(_g1_bytes(p) for p in points)
    _check("pk_g1_msm", lib.pk_g1_msm(pts, _scalars_bytes(scalars),
                                      len(points), out))
    return _g1_from(out.raw, 0)


def g2_msm(points: list, scalars: list[int]):
    _same_length(points, scalars)
    lib = load()
    out = ctypes.create_string_buffer(128)
    pts = b"".join(_g2_bytes(p) for p in points)
    _check("pk_g2_msm", lib.pk_g2_msm(pts, _scalars_bytes(scalars),
                                      len(points), out))
    return _g2_from(out.raw, 0)


def fr_ntt(values: list[int], omega: int, invert: bool = False) -> list[int]:
    """Radix-2 NTT over Fr in natural order (``invert``: the inverse,
    scaled by 1/n); ``len(values)`` must be a power of two."""
    lib = load()
    n = len(values)
    buf = ctypes.create_string_buffer(
        b"".join((v % _R).to_bytes(32, "little") for v in values))
    _check("pk_fr_ntt", lib.pk_fr_ntt(buf, n, (omega % _R).to_bytes(
        32, "little"), 1 if invert else 0))
    raw = buf.raw
    return [int.from_bytes(raw[32 * i:32 * (i + 1)], "little")
            for i in range(n)]
