"""NTT over BN254-Fr and the multilinear wavelet transform.

Port of ``provekit_tpu/ops/ntt.py``: the Reed-Solomon encoder of the WHIR
commitments.  A size-m transform runs as log2(m) constant-geometry (Pease)
DIF stages over a (16, m * chunk) array whose minor ``chunk`` axis is
batched, then one bit-reversal gather of chunks.  Sizes up to 2^12 run
single-phase (chunk 1); larger ones take the four-step split
X = NTT_n2(twiddle(NTT_n1(A))).

A stage runs one of the module's two kernels, chosen where the JAX package
chooses between its fused stage and its butterfly (:func:`butterfly_route`):
``ntt_stage`` or ``butterfly``, which compute the same stage with one body
(``csrc/ntt_stage.cu``).  On a CUDA tensor each launches its kernel; on a
CPU tensor each runs the plain stage.  The bit-reversal gather, the
cross-twiddle product and the transpose stay torch ops.  Twiddle tables are
Montgomery form and cached per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels as K
from ..fields import bn254 as F
from ..fields import vector as V


@functools.lru_cache(maxsize=None)
def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _bitrev_index(log_n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_perm(log_n)).to(device)


def _power_table(w: int, n: int, device) -> torch.Tensor:
    """(16, n) Montgomery table of w^k, k < n (log-doubling T || T*w^|T|)."""
    tw = V.pack([F.to_mont(1)], device)
    while tw.shape[1] < n:
        k = tw.shape[1]
        shift = V.const(F.to_mont(pow(w, k, F.P)), device)
        tw = torch.cat([tw, V.mont_mul(tw, shift)], dim=1)
    return tw[:, :n].contiguous()


def _root(log_n: int, inverse: bool) -> int:
    w = F.root_of_unity(log_n)
    return F.inv(w) if inverse else w


@functools.lru_cache(maxsize=None)
def _twiddle_table(log_n: int, inverse: bool,
                   device: torch.device) -> torch.Tensor:
    """(16, n/2) table of w^k, w of order 2^log_n."""
    return _power_table(_root(log_n, inverse), max(1, (1 << log_n) >> 1),
                        device)


@functools.lru_cache(maxsize=None)
def _cross_twiddles(log_n: int, log_n1: int, inverse: bool,
                    device: torch.device) -> torch.Tensor:
    """(16, n) cross-twiddle matrix T[k1*n2 + j2] = w^{k1*j2}."""
    n = 1 << log_n
    n1, n2 = 1 << log_n1, n >> log_n1
    tw = _power_table(_root(log_n, inverse), n, device)
    idx = (torch.arange(n1, dtype=torch.int64, device=device)[:, None]
           * torch.arange(n2, dtype=torch.int64, device=device)[None, :])
    return tw[:, idx.reshape(-1)].contiguous()


def butterfly_plain(a: torch.Tensor, b: torch.Tensor,
                    tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a + b, (a - b) * tw) in plain torch: the JAX package's
    ``butterfly_dispatch`` off the TPU."""
    return V.add_mod(a, b), V.mont_mul_plain(V.sub_mod(a, b), tw)


def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int,
                    chunk: int) -> torch.Tensor:
    """One constant-geometry DIF stage in plain torch (see ntt_stage): the
    butterfly of each step with its twiddle, then the chunk interleave."""
    n = x.shape[1]
    half = n // 2
    steps = half // chunk
    a = x[:, :half].reshape(16, steps, chunk)
    b = x[:, half:].reshape(16, steps, chunk)
    j = torch.arange(steps, device=x.device)
    u, t = butterfly_plain(a, b, tw[:, (j >> s) << s].reshape(16, steps, 1))
    return torch.stack([u, t], dim=2).reshape(16, n)


_ENTRIES = {name: K.Entry(f"pk_{name}") for name in ("ntt_stage",
                                                     "butterfly")}


def _launch_stage(wrapper, x: torch.Tensor, tw: torch.Tensor, s: int,
                  chunk: int) -> torch.Tensor:
    """Launch ``pk_<wrapper name>`` on CUDA operands and count it in
    ``wrapper.launches``."""
    name = wrapper.__name__
    dev = K.check_cuda_int32(name, x, tw)
    n = x.shape[1]
    if (x.dim() != 2 or tw.dim() != 2 or chunk & (chunk - 1)
            or n % (2 * chunk)):
        raise ValueError(f"{name}: bad geometry x={tuple(x.shape)} "
                         f"tw={tuple(tw.shape)} chunk={chunk}")
    if ((n // (2 * chunk) - 1) >> s) << s >= max(1, tw.shape[1]):
        raise ValueError(f"{name}: twiddle table too short")
    x = x.contiguous()
    tw = tw.contiguous()
    out = torch.empty_like(x)
    _ENTRIES[name](dev, x.data_ptr(), out.data_ptr(), n, tw.data_ptr(),
                   tw.shape[1], s, chunk.bit_length() - 1)
    wrapper.launches += 1
    return out


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int,
              chunk: int) -> torch.Tensor:
    """One DIF stage over (16, n) with chunk interleave: for step j,
    out[2jc : 2jc+c] = a_j + b_j and out[2jc+c : 2jc+2c] = (a_j - b_j) *
    tw[(j >> s) << s], with a_j = x[jc : jc+c] and b_j = x[n/2 + jc : ...].

    A CPU operand takes :func:`ntt_stage_plain`; a CUDA operand launches
    ``pk_ntt_stage`` (counted in ``ntt_stage.launches``) or raises."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_stage_plain(x, tw, s, chunk)
    return _launch_stage(ntt_stage, x, tw, s, chunk)


ntt_stage.launches = 0


def butterfly(x: torch.Tensor, tw: torch.Tensor, s: int,
              chunk: int) -> torch.Tensor:
    """The stage of :func:`ntt_stage` for the stages the JAX package sends
    to its butterfly kernel (:func:`butterfly_route`).

    A CPU operand takes :func:`ntt_stage_plain`; a CUDA operand launches
    ``pk_butterfly`` (counted in ``butterfly.launches``) or raises."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_stage_plain(x, tw, s, chunk)
    return _launch_stage(butterfly, x, tw, s, chunk)


butterfly.launches = 0


def butterfly_route(n: int, chunk: int) -> bool:
    """Whether a stage over (16, n) with this chunk takes the butterfly
    kernel: where the JAX package's ``_pease_flat`` leaves its fused stage
    (``ntt_stage_enabled``: chunk outside 256..4096) and
    ``butterfly_dispatch`` takes ``butterfly_pallas`` (half >= 2048 and
    half a multiple of min(512, half))."""
    half = n >> 1
    return (not 256 <= chunk <= 4096 and half >= 2048
            and half % min(512, half) == 0)


def _pease_flat(x: torch.Tensor, tw: torch.Tensor, rev: torch.Tensor,
                log_m: int, chunk: int, plain: bool) -> torch.Tensor:
    """Constant-geometry DIF NTT along the major axis of (16, m, chunk)."""
    if log_m == 0:
        return x
    n = x.shape[1]
    if plain:
        stage = ntt_stage_plain
    else:
        stage = butterfly if butterfly_route(n, chunk) else ntt_stage
    for s in range(log_m):
        x = stage(x, tw, s, chunk)
    return x.reshape(16, 1 << log_m, chunk)[:, rev].reshape(16, n)


# sizes up to this run single-phase; above, four-step
FOUR_STEP_MIN_LOG = 12


def _ntt_core(x: torch.Tensor, log_n: int, inverse: bool,
              plain: bool = False) -> torch.Tensor:
    """The transform; ``plain`` runs it with the plain versions of the
    kernels on any device (the reference the card's kernels are held to)."""
    dev = x.device
    mul = V.mont_mul_plain if plain else V.mont_mul
    n_inv = V.const(F.to_mont(F.inv(1 << log_n)), dev)
    if log_n <= FOUR_STEP_MIN_LOG:
        x = _pease_flat(x, _twiddle_table(log_n, inverse, dev),
                        _bitrev_index(log_n, dev), log_n, 1, plain)
    else:
        log_n1 = (log_n + 1) // 2
        log_n2 = log_n - log_n1
        n1, n2 = 1 << log_n1, 1 << log_n2
        x = _pease_flat(x, _twiddle_table(log_n1, inverse, dev),
                        _bitrev_index(log_n1, dev), log_n1, n2, plain)
        x = mul(x, _cross_twiddles(log_n, log_n1, inverse, dev))
        x = x.reshape(16, n1, n2).transpose(1, 2).reshape(16, n1 * n2)
        x = _pease_flat(x, _twiddle_table(log_n2, inverse, dev),
                        _bitrev_index(log_n2, dev), log_n2, n1, plain)
    if inverse:
        x = mul(x, n_inv)
    return x


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at [w^0, ..., w^(n-1)]."""
    return _ntt_core(x, x.shape[1].bit_length() - 1, False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients."""
    return _ntt_core(x, x.shape[1].bit_length() - 1, True)


def rs_encode(coeffs: torch.Tensor, log_domain: int,
              plain: bool = False) -> torch.Tensor:
    """Reed-Solomon encode: zero-pad coefficients to 2^log_domain, NTT."""
    n = coeffs.shape[1]
    domain = 1 << log_domain
    assert domain >= n
    padded = torch.nn.functional.pad(coeffs, (0, domain - n))
    return _ntt_core(padded, log_domain, False, plain)


def wavelet(evals: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Multilinear evals <-> coeffs (Mobius transform), MSB-first variables.

    Forward (evals->coeffs): for each variable, hi -= lo.
    Inverse (coeffs->evals): hi += lo.
    """
    n = evals.shape[1]
    x = evals
    for s in range(n.bit_length() - 1):
        half = 1 << s
        xs = x.reshape(16, n >> (s + 1), 2, half)
        lo, hi = xs[:, :, 0], xs[:, :, 1]
        hi = V.add_mod(hi, lo) if inverse else V.sub_mod(hi, lo)
        x = torch.stack([lo, hi], dim=2).reshape(16, n)
    return x


def coeffs_of_evals(evals: torch.Tensor) -> torch.Tensor:
    return wavelet(evals, False)


def evals_of_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    return wavelet(coeffs, True)
