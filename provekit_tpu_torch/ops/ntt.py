"""NTT over BN254-Fr and the multilinear wavelet transform.

Port of ``provekit_tpu/ops/ntt.py``: the Reed-Solomon encoder of the WHIR
commitments.  A size-m transform runs as log2(m) constant-geometry (Pease)
DIF stages over a (16, m * chunk) array whose minor ``chunk`` axis is
batched, then one bit-reversal gather of chunks.  Sizes up to 2^12 run
single-phase (chunk 1); larger ones take the four-step split
X = NTT_n2(twiddle(NTT_n1(A))).

On a CUDA tensor the transform runs as passes of the one kernel
``csrc/ntt_stage.cu`` (``pk_ntt_pass``): each pass takes up to
``MAX_PASS_STAGES`` consecutive stages through shared memory, the first
pass reads the digit planes with ``rs_encode``'s zero padding, the passes
in between hand packed (n, 8) limbs on, the last pass of each phase stores
in bit-reversed row order, phase 1's last pass multiplies by the cross
twiddles (and the inverse's 1/n) from two small tables, and phase 2's
first pass reads phase 1's output transposed (:func:`plan`): a 2^21 or
2^25 transform is four launches and nothing else.  On a CPU tensor, or
with ``plain`` (the reference the card is held to), the transform runs in
plain torch stage by stage (:func:`_ntt_stages`): the plain stages, the
gathers, the cross-twiddle product and the transpose.

Each pass takes one of the JAX package's two kernels' routes, chosen where
the JAX package chooses between its fused stage and its butterfly
(:func:`butterfly_route`), and counts its launch there:
``ntt_stage.launches`` (K3) or ``butterfly.launches`` (K2); every pass also
counts in ``ntt_pass.launches``, its stages in ``ntt_pass.stages`` and its
geometry in ``ntt_pass.shapes``.  ``ntt_stage`` and ``butterfly`` are the
one-stage passes, and :func:`ntt_pass` runs the whole transform along
the major axis in one pass (the sharded NTT's columns).  Twiddle tables
are Montgomery form and cached per device.
"""

from __future__ import annotations

import collections
import dataclasses
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


def ntt_pass_plain(x: torch.Tensor, tw: torch.Tensor, s0: int, k: int,
                   chunk: int) -> torch.Tensor:
    """Stages s0 .. s0 + k - 1 in plain torch: k calls of
    :func:`ntt_stage_plain`."""
    for s in range(s0, s0 + k):
        x = ntt_stage_plain(x, tw, s, chunk)
    return x


# ---------------------------------------------------------------------------
# passes (csrc/ntt_stage.cu)

# at most this many stages a pass; a tile of the multi-tile passes holds
# 2^TILE_LOG elements (64 KiB of shared memory, two CTAs an SM)
MAX_PASS_STAGES = 7
TILE_LOG = 11
# the kernel's largest tile (128 KiB): a whole single-phase transform
MAX_TILE_LOG = 12
# the kernel's flags (csrc/ntt_stage.cu)
IN_PACKED, IN_TRANSPOSED, OUT_PACKED, OUT_BITREV, CROSS = 1, 2, 4, 8, 16
TW_PACKED = 32
ROUTES = ("ntt_stage", "butterfly")


@dataclasses.dataclass(frozen=True)
class Pass:
    """One launch of ``pk_ntt_pass``: stages s0 .. s0 + k - 1 of a size
    2^log_m transform batched over 2^log_chunk columns, in tiles of 2^k
    rows, 2^log_g consecutive low row bits and 2^log_c consecutive columns,
    with the load and store modes of ``flags``."""
    log_m: int
    log_chunk: int
    s0: int
    k: int
    log_g: int
    log_c: int
    flags: int
    route: str

    @property
    def n(self) -> int:
        return 1 << (self.log_m + self.log_chunk)

    @property
    def log_tile(self) -> int:
        return self.k + self.log_g + self.log_c

    @property
    def grid(self) -> int:
        return self.n >> self.log_tile

    @functools.cached_property
    def key(self) -> str:
        names = ("packed", "transposed", "out_packed", "bitrev", "cross")
        modes = "+".join(m for i, m in enumerate(names) if self.flags >> i & 1)
        return (f"n=2^{self.log_m + self.log_chunk} m=2^{self.log_m} "
                f"chunk=2^{self.log_chunk} stages {self.s0}-"
                f"{self.s0 + self.k - 1} tile 2^{self.k}x2^{self.log_g}"
                f"x2^{self.log_c} {modes or 'planes'} ({self.route})")


def _tile(log_m: int, log_chunk: int, k: int,
          transposed: bool) -> tuple[int, int]:
    """(log_g, log_c) of a pass's tile: 2^TILE_LOG elements where the
    geometry allows, columns first (contiguous in a row-major load), or
    first up to eight rows for a transposed load (contiguous there)."""
    if k > MAX_TILE_LOG:
        raise ValueError(f"ntt_pass: {k} stages do not fit one tile")
    budget = max(0, TILE_LOG - k)
    log_g = min(log_m - k, budget, 3) if transposed else 0
    log_c = min(log_chunk, budget - log_g)
    return min(log_m - k, budget - log_c), log_c


@functools.lru_cache(maxsize=None)
def _make_pass(log_m: int, log_chunk: int, s0: int, k: int, flags: int,
               route: str | None = None) -> Pass:
    log_g, log_c = _tile(log_m, log_chunk, k, bool(flags & IN_TRANSPOSED))
    n = 1 << (log_m + log_chunk)
    return Pass(log_m, log_chunk, s0, k, log_g, log_c, flags,
                route or ROUTES[butterfly_route(n, 1 << log_chunk)])


def _split(stages: int) -> list[int]:
    """Stages a pass for a phase: as few passes as MAX_PASS_STAGES allows,
    balanced, the larger first."""
    count = -(-stages // MAX_PASS_STAGES)
    return [stages // count + (i < stages % count) for i in range(count)]


def _phase(log_m: int, log_chunk: int, first: int, last: int) -> list[Pass]:
    """The passes of one phase; ``first`` and ``last`` are the flags of its
    first load and its last store (the passes between them hand packed
    limbs on; every pass reads packed twiddles)."""
    out, s0 = [], 0
    ks = _split(log_m)
    for i, k in enumerate(ks):
        flags = TW_PACKED | (first if i == 0 else IN_PACKED)
        flags |= last if i == len(ks) - 1 else OUT_PACKED
        out.append(_make_pass(log_m, log_chunk, s0, k, flags))
        s0 += k
    return out


@functools.lru_cache(maxsize=None)
def plan(log_n: int, inverse: bool = False) -> tuple[Pass, ...]:
    """The passes of a size-2^log_n transform on the card: one pass for a
    single-phase size (its whole transform in one tile; the inverse's 1/n
    from the scale tables), else phase 1 (planes in, zero-padded; the last
    pass stores bit-reversed rows times the cross twiddles, packed) and
    phase 2 (the first pass reads phase 1's output transposed; the last
    stores bit-reversed rows as planes)."""
    if log_n <= FOUR_STEP_MIN_LOG:
        return (_make_pass(log_n, 0, 0, log_n, TW_PACKED | OUT_BITREV
                           | (CROSS if inverse else 0)),)
    log_n1 = (log_n + 1) // 2
    log_n2 = log_n - log_n1
    return (*_phase(log_n1, log_n2, 0, OUT_BITREV | CROSS | OUT_PACKED),
            *_phase(log_n2, log_n1, IN_PACKED | IN_TRANSPOSED, OUT_BITREV))


@functools.lru_cache(maxsize=None)
def _twiddle_packed(log_n: int, inverse: bool,
                    device: torch.device) -> torch.Tensor:
    """:func:`_twiddle_table` as packed (n/2, 8) limbs."""
    return pack_limbs(_twiddle_table(log_n, inverse, device))


def pass_twiddles(p: Pass, inverse: bool,
                  device: torch.device) -> torch.Tensor:
    """The twiddle operand of a launch for ``p``: the (16, m/2) planes of
    w_m^e, or their packed (m/2, 8) limbs where ``p.flags`` has
    TW_PACKED."""
    if p.flags & TW_PACKED:
        return _twiddle_packed(p.log_m, inverse, device)
    return _twiddle_table(p.log_m, inverse, device)


def pack_limbs(x: torch.Tensor) -> torch.Tensor:
    """(16, n) digit planes -> (n, 8) int32 limbs (the packed layout)."""
    d = x.to(torch.int64)
    limbs = (d[0::2] | (d[1::2] << 16)).T
    return (limbs - ((limbs >> 31) << 32)).to(torch.int32).contiguous()


def unpack_limbs(x: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 limbs -> (16, n) digit planes."""
    limbs = x.to(torch.int64).T & 0xFFFFFFFF
    return torch.stack([limbs & 0xFFFF, limbs >> 16], dim=1).reshape(
        16, -1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def scale_tables(log_n: int, inverse: bool,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor,
                                                int]:
    """(hi, lo, a), packed (., 8) Montgomery tables with
    w_n^e * c = hi[e >> a] * lo[e mod 2^a] for e < n: the cross twiddles of
    a four-step transform (w_n^(k1 j2), c = 1/n for the inverse), or for a
    single-phase size hi = [1/n], lo = [1], a = 0 (its inverse's scale)."""
    one = V.pack([F.to_mont(1)], device)
    n_inv = V.const(F.to_mont(F.inv(1 << log_n)), device)
    if log_n <= FOUR_STEP_MIN_LOG:
        return pack_limbs(n_inv), pack_limbs(one), 0
    a = (log_n + 1) // 2
    w = _root(log_n, inverse)
    lo = _power_table(w, 1 << a, device)
    hi = _power_table(pow(w, 1 << a, F.P), 1 << (log_n - a), device)
    if inverse:
        hi = V.mont_mul(hi, n_inv)
    return pack_limbs(hi), pack_limbs(lo), a


def pass_work(p: Pass, in_len: int) -> tuple[int, int]:
    """(bytes, Montgomery products) of one launch for ``p``: its input read
    once (the planes up to ``in_len``, or packed limbs), its output written
    once, the stage twiddles it reads (exponent 0 is skipped: the nonzero
    multiples of 2^s0 below m / 2) and the scale tables; the products of
    its stages whose twiddle is not 1, and two an element for the scale."""
    m, chunk, plane = 1 << p.log_m, 1 << p.log_chunk, 64
    nbytes = 32 * p.n if p.flags & IN_PACKED else plane * min(in_len, p.n)
    nbytes += 32 * p.n if p.flags & OUT_PACKED else plane * p.n
    nbytes += plane * max(0, ((m // 2) >> p.s0) - 1)
    products = sum(max(0, m // 2 - (1 << s)) * chunk
                   for s in range(p.s0, p.s0 + p.k))
    if p.flags & CROSS:
        log_n = p.log_m + p.log_chunk
        a = (log_n + 1) // 2 if log_n > FOUR_STEP_MIN_LOG else 0
        products += 2 * p.n
        nbytes += 32 * ((1 << a) + (1 << (log_n - a) if a else 1))
    return nbytes, products


_PASS = K.Entry("pk_ntt_pass")


def _launch(p: Pass, x: torch.Tensor, tw: torch.Tensor,
            tables: tuple | None) -> torch.Tensor:
    """One launch of ``pk_ntt_pass`` for ``p`` on CUDA operands: ``x`` is
    (16, in_len) planes (in_len <= n; zero beyond) or (n, 8) packed limbs;
    returns planes or packed limbs by ``p.flags``.  Counts the launch in
    ``ntt_pass`` and in its route's wrapper (``ntt_stage`` or
    ``butterfly``)."""
    name = "ntt_pass"
    packed_in = bool(p.flags & IN_PACKED)
    want = (p.n, 8) if packed_in else None
    if (x.dim() != 2 or (want is not None and tuple(x.shape) != want)
            or (want is None and (x.shape[0] != 16 or x.shape[1] > p.n))):
        raise ValueError(f"{name}: bad operand {tuple(x.shape)} for {p.key}")
    tw_len = tw.shape[0] if p.flags & TW_PACKED else tw.shape[-1]
    if tw.dim() != 2 or tw.shape[1 if p.flags & TW_PACKED else 0] != (
            8 if p.flags & TW_PACKED else 16) or (
            tw_len < max(1, (1 << p.log_m) >> 1)):
        raise ValueError(f"{name}: twiddle table {tuple(tw.shape)} is not "
                         f"w_m^e for m = 2^{p.log_m}")
    if p.flags & CROSS and tables is None:
        raise ValueError(f"{name}: {p.key} needs the scale tables")
    hi, lo, a = tables if p.flags & CROSS else (tw, tw, 0)
    dev = x.device
    for t in (x, tw, hi, lo):
        if t.device != dev or dev.type != "cuda" or t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32 on one CUDA "
                             f"device, got {t.dtype} on {t.device}")
    x, tw = x.contiguous(), tw.contiguous()
    out = torch.empty((p.n, 8) if p.flags & OUT_PACKED else (16, p.n),
                      dtype=torch.int32, device=dev)
    in_len = p.n if packed_in else x.shape[1]
    _PASS(dev, x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_len,
          hi.data_ptr(), lo.data_ptr(), in_len, p.log_m, p.log_chunk, p.s0,
          p.k, p.log_g, p.log_c, p.flags, a, ROUTES.index(p.route))
    ntt_pass.launches += 1
    ntt_pass.stages += p.k
    ntt_pass.shapes[p.key] += 1
    (butterfly if p.route == "butterfly" else ntt_stage).launches += 1
    return out


def pass_plain(p: Pass, x: torch.Tensor, tw: torch.Tensor,
               tables: tuple | None) -> torch.Tensor:
    """What one launch for ``p`` computes, in plain torch on any device:
    the load (zero padding, packed limbs, the transposed view), k plain
    stages, the bit-reversal gather, the scale product and the store's
    layout."""
    n, m, chunk = p.n, 1 << p.log_m, 1 << p.log_chunk
    if p.flags & TW_PACKED:
        tw = unpack_limbs(tw)
    if p.flags & IN_PACKED:
        x = unpack_limbs(x)
        if p.flags & IN_TRANSPOSED:
            x = x.reshape(16, chunk, m).transpose(1, 2).reshape(16, n)
    else:
        x = torch.nn.functional.pad(x, (0, n - x.shape[1]))
    x = ntt_pass_plain(x, tw, p.s0, p.k, chunk)
    if p.flags & OUT_BITREV:
        rev = _bitrev_index(p.log_m, x.device)
        x = x.reshape(16, m, chunk)[:, rev].reshape(16, n)
    if p.flags & CROSS:
        hi, lo, a = tables
        e = (torch.arange(m, device=x.device)[:, None]
             * torch.arange(chunk, device=x.device)[None, :]).reshape(-1)
        f = V.mont_mul_plain(unpack_limbs(hi)[:, e >> a],
                             unpack_limbs(lo)[:, e & ((1 << a) - 1)])
        x = V.mont_mul_plain(x, f)
    return pack_limbs(x) if p.flags & OUT_PACKED else x


def ntt_pass(x: torch.Tensor, tw: torch.Tensor, s0: int, k: int,
             chunk: int, bitrev: bool = False) -> torch.Tensor:
    """Stages s0 .. s0 + k - 1 over (16, n) planes in one pass (what k
    calls of :func:`ntt_stage` compute); with ``bitrev`` (the last stages,
    s0 + k = log2(n / chunk)) the pass stores row q at row bitrev(q), the
    gather that ends a constant-geometry transform.

    A CPU operand takes :func:`pass_plain`; a CUDA operand launches
    ``pk_ntt_pass`` on the route of its geometry or raises.  Every launch
    of the kernel counts in ``ntt_pass.launches``, its stages in
    ``ntt_pass.stages`` and its geometry (:attr:`Pass.key`) in
    ``ntt_pass.shapes``."""
    p = _stage_pass(x, s0, k, chunk, OUT_BITREV if bitrev else 0)
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return pass_plain(p, x, tw, None)
    return _launch(p, x, tw, None)


ntt_pass.launches = 0
ntt_pass.stages = 0
ntt_pass.shapes = collections.Counter()


def _stage_pass(x: torch.Tensor, s0: int, k: int, chunk: int, flags: int,
                route: str | None = None) -> Pass:
    n = x.shape[-1]
    if (x.dim() != 2 or chunk < 1 or chunk & (chunk - 1) or n % (2 * chunk)
            or n & (n - 1)):
        raise ValueError(f"ntt_pass: bad geometry x={tuple(x.shape)} "
                         f"chunk={chunk}")
    log_chunk = chunk.bit_length() - 1
    log_m = n.bit_length() - 1 - log_chunk
    if s0 < 0 or k < 1 or s0 + k > log_m:
        raise ValueError(f"ntt_pass: stages {s0} .. {s0 + k - 1} of a size "
                         f"2^{log_m} transform")
    if flags & OUT_BITREV and s0 + k != log_m:
        raise ValueError("ntt_pass: only the last stages store bit-reversed")
    return _make_pass(log_m, log_chunk, s0, k, flags, route)


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int,
              chunk: int) -> torch.Tensor:
    """One DIF stage over (16, n) with chunk interleave: for step j,
    out[2jc : 2jc+c] = a_j + b_j and out[2jc+c : 2jc+2c] = (a_j - b_j) *
    tw[(j >> s) << s], with a_j = x[jc : jc+c] and b_j = x[n/2 + jc : ...].

    A CPU operand takes :func:`ntt_stage_plain`; a CUDA operand launches
    ``pk_ntt_pass`` with k = 1 on K3's route (counted in
    ``ntt_stage.launches``, as is every pass on that route) or raises."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_stage_plain(x, tw, s, chunk)
    return _launch(_stage_pass(x, s, 1, chunk, 0, "ntt_stage"), x, tw, None)


ntt_stage.launches = 0


def butterfly(x: torch.Tensor, tw: torch.Tensor, s: int,
              chunk: int) -> torch.Tensor:
    """The stage of :func:`ntt_stage` for the stages the JAX package sends
    to its butterfly kernel (:func:`butterfly_route`).

    A CPU operand takes :func:`ntt_stage_plain`; a CUDA operand launches
    ``pk_ntt_pass`` with k = 1 on K2's route (counted in
    ``butterfly.launches``, as is every pass on that route) or raises."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_stage_plain(x, tw, s, chunk)
    return _launch(_stage_pass(x, s, 1, chunk, 0, "butterfly"), x, tw, None)


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
                log_m: int, chunk: int) -> torch.Tensor:
    """Constant-geometry DIF NTT along the major axis of (16, m, chunk),
    one plain stage at a time: on the CPU through the wrapper of the JAX
    package's route for the stage (``ntt_stage`` or ``butterfly``, whose
    CPU path is the plain stage), on the card through
    :func:`ntt_stage_plain` (the reference, which launches no kernel)."""
    if log_m == 0:
        return x
    n = x.shape[1]
    if x.device.type == "cpu":
        stage = butterfly if butterfly_route(n, chunk) else ntt_stage
    else:
        stage = ntt_stage_plain
    for s in range(log_m):
        x = stage(x, tw, s, chunk)
    return x.reshape(16, 1 << log_m, chunk)[:, rev].reshape(16, n)


# sizes up to this run single-phase; above, four-step
FOUR_STEP_MIN_LOG = 12


def _ntt_stages(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """The transform in plain torch, stage by stage (the JAX package's
    structure): the zero padding, the plain stages, the bit-reversal
    gathers, the cross-twiddle product and the transpose, and the
    inverse's 1/n."""
    dev = x.device
    x = torch.nn.functional.pad(x, (0, (1 << log_n) - x.shape[1]))
    n_inv = V.const(F.to_mont(F.inv(1 << log_n)), dev)
    if log_n <= FOUR_STEP_MIN_LOG:
        x = _pease_flat(x, _twiddle_table(log_n, inverse, dev),
                        _bitrev_index(log_n, dev), log_n, 1)
    else:
        log_n1 = (log_n + 1) // 2
        log_n2 = log_n - log_n1
        n1, n2 = 1 << log_n1, 1 << log_n2
        x = _pease_flat(x, _twiddle_table(log_n1, inverse, dev),
                        _bitrev_index(log_n1, dev), log_n1, n2)
        x = V.mont_mul_plain(x, _cross_twiddles(log_n, log_n1, inverse, dev))
        x = x.reshape(16, n1, n2).transpose(1, 2).reshape(16, n1 * n2)
        x = _pease_flat(x, _twiddle_table(log_n2, inverse, dev),
                        _bitrev_index(log_n2, dev), log_n2, n1)
    if inverse:
        x = V.mont_mul_plain(x, n_inv)
    return x


def _ntt_passes(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """The transform as the launches of :func:`plan` (CUDA operands)."""
    dev = x.device
    if log_n == 0:
        return torch.nn.functional.pad(x, (0, 1 - x.shape[1]))
    tables = scale_tables(log_n, inverse, dev)
    for p in plan(log_n, inverse):
        x = _launch(p, x, pass_twiddles(p, inverse, dev), tables)
    return x


def _ntt_core(x: torch.Tensor, log_n: int, inverse: bool,
              plain: bool = False) -> torch.Tensor:
    """The transform of (16, n') planes zero-padded to n = 2^log_n: on a
    CUDA tensor the passes of :func:`plan`, else (or with ``plain``, the
    reference the card's kernels are held to) stage by stage."""
    if x.shape[1] > 1 << log_n:
        raise ValueError(f"ntt: {x.shape[1]} values for a size-2^{log_n} "
                         f"transform")
    if x.device.type == "cuda" and not plain:
        return _ntt_passes(x, log_n, inverse)
    return _ntt_stages(x, log_n, inverse)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at [w^0, ..., w^(n-1)]."""
    return _ntt_core(x, x.shape[1].bit_length() - 1, False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients."""
    return _ntt_core(x, x.shape[1].bit_length() - 1, True)


def rs_encode(coeffs: torch.Tensor, log_domain: int,
              plain: bool = False) -> torch.Tensor:
    """Reed-Solomon encode: zero-pad coefficients to 2^log_domain, NTT."""
    assert 1 << log_domain >= coeffs.shape[1]
    return _ntt_core(coeffs, log_domain, False, plain)


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
