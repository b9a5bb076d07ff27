"""Batched BN254-Fr arithmetic on torch tensors.

Layout (the JAX package's, ``provekit_tpu/fields/vector.py``): a batch of
field elements is a ``(16, *batch)`` tensor of 16-bit digits, limbs first,
little-endian radix 2^16.  The port stores the planes as ``torch.int32``;
the bits equal the JAX package's ``uint32`` arrays, so a numpy ``view``
converts between the two.  Montgomery form uses R = 2^256.

Torch on the CPU has no ``+``, ``-``, ``>>`` or ``<`` for ``uint32``, so the
plain functions here compute in ``int64``: digit pairs are packed into
8 x 32-bit limbs held in ``int64`` lanes, where a signed carry pass
(``_normalize``) settles sums and differences alike.

``mont_mul`` is the one kernel of this module: on a CUDA tensor it launches
``csrc/mont_mul.cu``; on a CPU tensor it runs :func:`mont_mul_plain`, the
same function in plain torch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels as K
from . import bn254
from .bn254 import NLIMBS, P

I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _const_limbs(x: int) -> np.ndarray:
    """Python int -> (16,) uint32 numpy digit vector (host constant)."""
    return np.array(bn254.to_limbs(x), dtype=np.uint32)


P_LIMBS = _const_limbs(P)
NPRIME16 = bn254.NPRIME16
_P32 = tuple((P >> (32 * k)) & _M32 for k in range(8))


# ---------------------------------------------------------------------------
# Packing and constants


def pack(values, device, batch_shape=None) -> torch.Tensor:
    """Iterable of ints -> (16, n) int32 planes on ``device``."""
    vals = list(values)
    blob = b"".join((v % P).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(blob, dtype="<u2").reshape(len(vals), NLIMBS)
    out = torch.from_numpy(np.ascontiguousarray(arr.T).astype(np.int32))
    out = out.to(device)
    if batch_shape is not None:
        out = out.reshape((NLIMBS, *batch_shape))
    return out


def to_numpy_u32(arr: torch.Tensor) -> np.ndarray:
    """Planes -> numpy uint32 array of the same shape (one device fetch)."""
    return arr.detach().to("cpu", I32).contiguous().numpy().view(np.uint32)


def from_numpy_u32(arr: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 planes (the JAX package's layout) -> int32 tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def unpack(arr) -> list[int]:
    """(16, ...) planes -> list of Python ints (batch flattened)."""
    a = (to_numpy_u32(arr) if isinstance(arr, torch.Tensor)
         else np.asarray(arr)).reshape(NLIMBS, -1)
    blob = a.T.astype("<u2").tobytes()
    return [int.from_bytes(blob[32 * i:32 * (i + 1)], "little")
            for i in range(a.shape[1])]


def unpack_scalar(arr) -> int:
    return unpack(arr.reshape(NLIMBS, 1))[0]


def to_bytes_le_block(arr, check_canonical: bool = False) -> bytes:
    """(16, n) canonical planes (numpy or tensor) -> n*32 LE scalar bytes."""
    a = (to_numpy_u32(arr) if isinstance(arr, torch.Tensor)
         else np.asarray(arr)).reshape(NLIMBS, -1)
    if check_canonical and a.shape[1]:
        lt = np.zeros(a.shape[1], dtype=bool)
        decided = np.zeros(a.shape[1], dtype=bool)
        for i in range(NLIMBS - 1, -1, -1):
            pi = int(P_LIMBS[i])
            lt |= ~decided & (a[i] < pi)
            decided |= a[i] != pi
        if not lt.all():
            raise AssertionError("non-canonical scalar in limb block")
    return a.T.astype("<u2").tobytes()


@functools.lru_cache(maxsize=None)
def _const_col(x: int, device: torch.device) -> torch.Tensor:
    # cached per device: never modified in place by anything in the port
    return pack([x], device)


def const(x: int, device, k: int = 1) -> torch.Tensor:
    """(16, k) planes all holding ``x mod P`` (a broadcast view for k > 1)."""
    col = _const_col(x % P, torch.device(device))
    return col if k == 1 else col.expand(NLIMBS, k)


def const_like(x: int, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a (16, 1, ..., 1) column broadcasting against ``like``."""
    return const(x, like.device).reshape((NLIMBS,) + (1,) * (like.dim() - 1))


def zeros(batch_shape, device) -> torch.Tensor:
    return torch.zeros((NLIMBS, *batch_shape), dtype=I32, device=device)


# ---------------------------------------------------------------------------
# int64 limb helpers (8 x 32-bit limbs)


def _limbs(a: torch.Tensor) -> torch.Tensor:
    """(16, *b) digit planes -> fresh (8, *b) int64 32-bit limbs."""
    a = a.to(I64)
    return a[0::2] | (a[1::2] << 16)


def _planes(L: torch.Tensor) -> torch.Tensor:
    """(8, *b) limbs in [0, 2^32) -> (16, *b) int32 digit planes."""
    out = torch.empty((NLIMBS, *L.shape[1:]), dtype=I32, device=L.device)
    out[0::2] = L & _M16
    out[1::2] = L >> 16
    return out


@functools.lru_cache(maxsize=None)
def _limb_col(values: tuple, device: torch.device, ndim: int) -> torch.Tensor:
    # cached per device so no host-to-device copy is made per operation
    return torch.tensor(values, dtype=I64, device=device).reshape(
        (len(values),) + (1,) * (ndim - 1))


def _p32(L: torch.Tensor) -> torch.Tensor:
    return _limb_col(_P32, L.device, L.dim())


def _normalize(L: torch.Tensor) -> torch.Tensor:
    """Signed carry pass, in place: limbs 0..6 end in [0, 2^32) and the top
    limb keeps the sign and any excess (value is unchanged)."""
    for k in range(7):
        c = L[k] >> 32  # floor division: borrows are -1, -2, ...
        L[k] &= _M32
        L[k + 1] += c
    return L


def _cond_sub_p(L: torch.Tensor) -> torch.Tensor:
    """Normalized limbs of a value in [0, 2P) -> limbs in [0, P)."""
    d = _normalize(L - _p32(L))
    return torch.where(d[7:8] >= 0, d, L)


# ---------------------------------------------------------------------------
# Modular add/sub/neg (canonical or Montgomery form alike)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _planes(_cond_sub_p(_normalize(_limbs(a) + _limbs(b))))


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = _limbs(a) - _limbs(b)
    return _planes(_cond_sub_p(_normalize(L + _p32(L))))


def neg_mod(a: torch.Tensor) -> torch.Tensor:
    L = _limbs(a)
    return _planes(_cond_sub_p(_normalize(_p32(L) - L)))


def is_zero_mask(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over batch dims: element == 0."""
    return (a == 0).all(dim=0)


def eq_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, t: torch.Tensor, f: torch.Tensor):
    """mask over batch dims chooses t (True) or f per element."""
    return torch.where(mask[None, ...], t, f)


# ---------------------------------------------------------------------------
# Montgomery multiplication


_PD = tuple((P >> (16 * i)) & _M16 for i in range(NLIMBS))


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*2^-256 mod P in plain torch (digit-serial Montgomery REDC).

    Canonical output whenever a*b < 2^256 * P.  Columns of the 16-bit digit
    convolution stay below 2^38 through the reduction, well inside int64.
    """
    a, b = torch.broadcast_tensors(a, b)
    A = a.to(I64)
    B = b.to(I64)
    t = torch.zeros((31, *A.shape[1:]), dtype=I64, device=A.device)
    for i in range(NLIMBS):
        t[i:i + NLIMBS] += A[i] * B
    pd = _limb_col(_PD, A.device, A.dim())
    for i in range(NLIMBS):
        m = (t[i] * NPRIME16) & _M16
        t[i:i + NLIMBS] += m * pd
        t[i + 1] += t[i] >> 16
    # value = sum_k t[16 + k] * 2^(16 k) < 2P
    r = t[16:]
    L = torch.zeros((8, *A.shape[1:]), dtype=I64, device=A.device)
    L[:7] = r[0:14:2] + (r[1:14:2] << 16)
    L[7] = r[14]
    return _planes(_cond_sub_p(_normalize(L)))


def _plane_view(x: torch.Tensor, shape, n: int):
    """(pointer owner, row stride, column stride) of ``x`` as (16, n) under
    broadcasting to ``shape``: a stride-0 column for a (16, 1, ...) operand,
    the tensor's own strides where it already has the full shape, and a
    materialized copy otherwise."""
    if x.numel() == NLIMBS:
        v = x.reshape(NLIMBS, 1)
        return v, v.stride(0), 0
    if tuple(x.shape) != tuple(shape):
        x = x.expand(shape)
    v = x.reshape(NLIMBS, n)
    return v, v.stride(0), v.stride(1)


_PK_MONT_MUL = K.Entry("pk_mont_mul")


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product with broadcasting; the CUDA kernel on the card.

    A CPU operand takes :func:`mont_mul_plain`.  A CUDA operand launches
    ``pk_mont_mul`` (counted in ``mont_mul.launches``) or raises."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b)
    dev = K.check_cuda_int32("mont_mul", a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for d in shape[1:]:
        n *= d
    av, a_rs, a_cs = _plane_view(a, shape, n)
    bv, b_rs, b_cs = _plane_view(b, shape, n)
    out = torch.empty((NLIMBS, n), dtype=I32, device=dev)
    _PK_MONT_MUL(dev, av.data_ptr(), a_rs, a_cs, bv.data_ptr(), b_rs, b_cs,
                 out.data_ptr(), n)
    mont_mul.launches += 1
    return out.reshape(shape)


mont_mul.launches = 0


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const_like(bn254.R2, a))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, const_like(1, a))


def mul_std(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical-form product a*b mod P."""
    return mont_mul(mont_mul(a, b), const_like(bn254.R2, a))


# ---------------------------------------------------------------------------
# Reductions of wide values


def reduce_256(a: torch.Tensor) -> torch.Tensor:
    """Any 256-bit value (16 digits) mod P.

    P < 2^254, so the top two bits give q with q*P <= a; a - q*P < 2.3 P,
    and two conditional subtracts finish."""
    L = _limbs(a)
    q = L[7] >> 30
    L = _normalize(L - _p32(L) * q)
    return _planes(_cond_sub_p(_cond_sub_p(L)))


def reduce_wide(cols: torch.Tensor) -> torch.Tensor:
    """(16, *batch) digit columns -> canonical planes of their value mod P.

    int64 columns may hold any value in [0, 2^46); int32 columns are read
    as uint32 (the JAX package's reduce_wide input).

    value = extra * 2^256 + lo  ==>  lo mod P + extra * R mod P, with
    extra * R = mont_mul(extra, R^2)."""
    c = cols.to(I64)
    if cols.dtype == I32:  # the JAX package's uint32 columns, same bits
        c &= _M32
    L = _normalize(c[0::2] + (c[1::2] << 16))
    extra = L[7] >> 32
    L[7] &= _M32
    lo = reduce_256(_planes(L))
    ext = torch.zeros_like(c)
    for i in range(4):  # extra < 2^64 fits four digits
        ext[i] = (extra >> (16 * i)) & _M16
    hi = mont_mul(ext.to(I32), const_like(bn254.R2, ext))
    return add_mod(lo, hi)


def sum_mod(a: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Modular sum over one batch axis (axis >= 1).

    Digit planes summed in int64 (each sum < n * 2^16) and reduced once."""
    return reduce_wide(a.to(I64).sum(dim=axis))


# ---------------------------------------------------------------------------
# Exponentiation / inversion


def mont_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in Montgomery form (a is aR, result a^e R); host exponent."""
    if e == 0:
        return const_like(bn254.R, a).expand(a.shape).clone()
    acc = a
    for bit in bin(e)[3:]:  # MSB first, leading 1 consumed
        acc = mont_mul(acc, acc)
        if bit == "1":
            acc = mont_mul(acc, a)
    return acc


def mont_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse in Montgomery form: (aR) -> a^-1 R.  a must be nonzero."""
    return mont_pow(a, P - 2)


def _scan_prod(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 (log-step doubling)."""
    n = x.shape[1]
    d = 1
    while d < n:
        x = torch.cat([x[:, :d], mont_mul(x[:, d:], x[:, :n - d])], dim=1)
        d *= 2
    return x


def batch_inv_mont(a: torch.Tensor, zero_to_zero: bool = True):
    """Batched inversion of (16, n) Montgomery elements with one field
    inversion (Montgomery's trick over prefix and suffix products)."""
    n = a.shape[1]
    zmask = is_zero_mask(a)
    r1 = const(bn254.R, a.device, n)
    aa = select(zmask, r1, a)
    prefix = _scan_prod(aa)
    suffix = _scan_prod(aa.flip(1)).flip(1)
    total_inv = mont_inv(prefix[:, n - 1:n])
    one_col = const(bn254.R, a.device)
    eprefix = torch.cat([one_col, prefix[:, :-1]], dim=1)
    esuffix = torch.cat([suffix[:, 1:], one_col], dim=1)
    inv = mont_mul(mont_mul(eprefix, esuffix), total_inv)
    if zero_to_zero:
        inv = select(zmask, torch.zeros_like(inv), inv)
    return inv
