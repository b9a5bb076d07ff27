"""Tensor-core Montgomery product: can the tensor cores beat the CIOS kernel?

Port of ``scripts/mxu_mont_experiment.py`` (``docs/MXU_MONT.md``), variant
D: the Montgomery product a * b * 2^-256 mod P as three digit convolutions,
``T = a * b`` on the CUDA cores, then the two convolutions with constants,
``m = T_lo * N' mod 2^256`` and ``m * P``, as products with band matrices
over 8-bit digits on the tensor cores.  ``mont_mul_mma`` is the kernel of
this module: on a CUDA tensor it launches ``csrc/mont_mul_mma.cu``; on a CPU
tensor it runs :func:`mont_mul_mma_plain`, the same band-matrix arithmetic
in torch int64.  Nothing on the prove path calls it.

    python -m provekit_tpu_torch.experiments.mxu_mont

checks the kernel against the field formula, its plain version and
``mont_mul_plain``, and times it beside the CIOS kernel
(``fields.vector.mont_mul``) at n = 2^18, 2^20 and 2^21, on the card.  It
prints one JSON document.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from .. import kernels as K
from ..fields import bn254 as F
from ..fields import vector as V
from ..utils.profiling import cuda_ms

NPRIME256 = (-pow(F.P, -1, 1 << 256)) % (1 << 256)
I64 = torch.int64


def band_matrix(c: int, rows: int) -> np.ndarray:
    """(rows, 32) uint8 band matrix B[k][i] = digit_{k-i}(c), 8-bit digits:
    B times the 32 digits of x gives the first ``rows`` columns of the digit
    convolution x * c."""
    digits = [(c >> (8 * j)) & 0xFF for j in range(32)]
    band = np.zeros((rows, 32), dtype=np.uint8)
    for k in range(rows):
        for i in range(max(0, k - 31), min(k, 31) + 1):
            band[k, i] = digits[k - i]
    return band


BAND_NP = band_matrix(NPRIME256, 32)   # m = T_lo * N' mod 2^256
BAND_P = band_matrix(F.P, 64)          # m * P, full width


@functools.lru_cache(maxsize=None)
def _bands(device: torch.device) -> torch.Tensor:
    """Both band matrices as (96, 8) int32 words on ``device``."""
    words = np.concatenate([BAND_NP, BAND_P]).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def _band_product(band: np.ndarray, digits: torch.Tensor) -> torch.Tensor:
    """(rows, 32) band times (32, n) digits -> (rows, n) int64 column sums,
    one input digit at a time."""
    b = torch.from_numpy(band.astype(np.int64)).to(digits.device)
    cols = torch.zeros((band.shape[0], digits.shape[1]), dtype=I64,
                       device=digits.device)
    for i in range(32):
        cols += b[:, i:i + 1] * digits[i]
    return cols


def _carry8(cols: torch.Tensor) -> torch.Tensor:
    """(k, n) non-negative int64 columns of 8-bit weight -> (k, n) 8-bit
    digits of their sum mod 2^(8k)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + carry
        out[k] = v & 0xFF
        carry = v >> 8
    return out


def _split8(cols16: torch.Tensor) -> torch.Tensor:
    """(k, n) int64 columns of 16-bit weight -> (2k, n) columns of 8-bit
    weight with the same sum (the high part keeps any excess for the carry
    pass)."""
    out = torch.empty((2 * cols16.shape[0], cols16.shape[1]), dtype=I64,
                      device=cols16.device)
    out[0::2] = cols16 & 0xFF
    out[1::2] = cols16 >> 8
    return out


def mont_mul_mma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod P for (16, n) planes (a * b < 2^256 P) through the
    band-matrix steps of the kernel, in plain torch int64."""
    a, b = torch.broadcast_tensors(a, b)
    x, y = a.to(I64), b.to(I64)
    conv = torch.zeros((32, a.shape[1]), dtype=I64, device=a.device)
    for i in range(16):
        conv[i:i + 16] += x[i] * y          # 16-bit columns, each < 2^36
    t8 = _carry8(_split8(conv))             # the 64 8-bit digits of T
    m8 = _carry8(_band_product(BAND_NP, t8[:32]))
    s8 = _carry8(_band_product(BAND_P, m8) + t8)
    # (T + m P) / 2^256 < 2P: the 32 high digits, one conditional subtract
    hi = s8[32:]
    r = (hi[0::2] | (hi[1::2] << 8)).to(torch.int32)
    return V._planes(V._cond_sub_p(V._normalize(V._limbs(r))))


_PK_MONT_MUL_MMA = K.Entry("pk_mont_mul_mma")


def mont_mul_mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of two (16, n) plane tensors on the tensor cores.

    A CPU operand takes :func:`mont_mul_mma_plain`.  A CUDA operand launches
    ``pk_mont_mul_mma`` (counted in ``mont_mul_mma.launches``) or raises."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_mma_plain(a, b)
    dev = K.check_cuda_int32("mont_mul_mma", a, b)
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"mont_mul_mma: expected two (16, n) operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    n = a.shape[1]
    out = torch.empty_like(a)
    _PK_MONT_MUL_MMA(dev, a.data_ptr(), b.data_ptr(), _bands(dev).data_ptr(),
                     out.data_ptr(), n)
    mont_mul_mma.launches += 1
    return out


mont_mul_mma.launches = 0


def random_values(rng: np.random.Generator, count: int) -> list[int]:
    """``count`` field elements from a numpy generator (the JAX experiment's
    draw: 32 random bytes reduced mod P)."""
    return [int.from_bytes(rng.bytes(32), "little") % F.P
            for _ in range(count)]


def raw_planes(values, device) -> torch.Tensor:
    """Iterable of ints below 2^256 -> (16, n) int32 planes, not reduced."""
    blob = b"".join(v.to_bytes(32, "little") for v in values)
    arr = np.frombuffer(blob, dtype="<u2").reshape(-1, 16)
    return torch.from_numpy(
        np.ascontiguousarray(arr.T).astype(np.int32)).to(device)


# 0, 1, 2, P - 2, P - 1, R, R^2 and 2^255 mod P, and 2^256 - 1 (not
# canonical: a * b nears 2^256 P against P - 1)
EDGE_VALUES = (0, 1, 2, F.P - 2, F.P - 1, F.R % F.P, F.R * F.R % F.P,
               (1 << 255) % F.P)
ALL_ONES = (1 << 256) - 1


def edge_operands(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) planes of every pair of EDGE_VALUES, and 2^256 - 1 against
    each of them in both orders (a * b < 2^256 P in every pair)."""
    pairs = [(x, y) for x in EDGE_VALUES for y in EDGE_VALUES]
    pairs += [(ALL_ONES, y) for y in EDGE_VALUES]
    pairs += [(x, ALL_ONES) for x in EDGE_VALUES]
    return (raw_planes([x for x, _ in pairs], device),
            raw_planes([y for _, y in pairs], device))


def check(out: torch.Tensor, a_vals: list[int], b_vals: list[int]) -> bool:
    """Whether ``out`` holds a * b * R^-1 mod P, canonical, elementwise."""
    r_inv = pow(F.R, -1, F.P)
    return V.unpack(out) == [x * y * r_inv % F.P
                             for x, y in zip(a_vals, b_vals)]


# the JAX experiment's two sizes (docs/MXU_MONT.md) and the CIOS kernel's
# shape on the poseidon path
LOG_NS = (18, 20, 21)


def run(device) -> dict:
    """The experiment on a CUDA ``device``: exactness on 256 random pairs,
    then at each 2^log_n of LOG_NS (the pairs tiled) the kernel against the
    CIOS kernel, its plain version and ``mont_mul_plain``, and both
    kernels' times (median of 20 runs)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the experiment times kernels on a CUDA card")
    rng = np.random.default_rng(1)
    a_vals, b_vals = random_values(rng, 256), random_values(rng, 256)
    a_small, b_small = V.pack(a_vals, dev), V.pack(b_vals, dev)
    rows = {"device": torch.cuda.get_device_name(dev),
            "checks": {"mma_vs_formula":
                       check(mont_mul_mma(a_small, b_small), a_vals, b_vals)},
            "ms": {}, "M_per_s": {}}
    for log_n in LOG_NS:
        n = 1 << log_n
        a = a_small.repeat(1, n // 256)
        b = b_small.repeat(1, n // 256)
        got = mont_mul_mma(a, b)
        rows["checks"][f"mma_vs_plain_2^{log_n}"] = bool(
            torch.equal(got, mont_mul_mma_plain(a, b)))
        rows["checks"][f"mma_vs_mont_mul_plain_2^{log_n}"] = bool(
            torch.equal(got, V.mont_mul_plain(a, b)))
        rows["checks"][f"mma_vs_cios_2^{log_n}"] = bool(
            torch.equal(got, V.mont_mul(a, b)))
        for name, fn in (("mma", mont_mul_mma), ("cios", V.mont_mul)):
            ms = cuda_ms(lambda: fn(a, b), 20)
            rows["ms"][f"{name}_2^{log_n}"] = ms
            rows["M_per_s"][f"{name}_2^{log_n}"] = n / ms / 1e3
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the tensor-core experiment needs a CUDA card")
    rows = run(torch.device("cuda", 0))
    print(json.dumps(rows, indent=1))
    return 0 if all(rows["checks"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
