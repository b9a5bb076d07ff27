"""The NTT's pass kernel (``csrc/ntt_stage.cu``) on the host: a model of its
schedule in plain torch, and its plan, against the JAX package, exactly.

``model_pass`` runs one launch of ``pk_ntt_pass`` block by block as the
kernel does: each block's load addresses (planes with the zero padding,
packed limbs, the transposed view), its tile's local indices, the k
butterfly levels with the kernel's twiddle exponents (a zero exponent skips
the product), the store rows (bit-reversed or not) and the cross twiddle
from the two scale tables; it checks that the tile indices are a
permutation and that every output element is written exactly once.  The
tests hold the model and the plain passes (``ntt.pass_plain``, k stages of
``ntt_pass_plain`` each) to the JAX package's ``_ntt_core`` and
``rs_encode(device=True)``, to the port's plain stage-by-stage transform
with every number of stages a pass, and to ``ntt_pass_plain`` at chunks 1,
64 and 8192; the plan to its launch targets and to the kernel's constants.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.ops import ntt as JN
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.ops import ntt

torch.set_num_threads(1)
CPU = torch.device("cpu")
SOURCE = Path(ntt.__file__).resolve().parent.parent / "csrc" / "ntt_stage.cu"


@pytest.fixture(autouse=True)
def _fresh_tables():
    """The JAX package's twiddle caches may hold traced arrays from its
    sharded tests; the plan depends on MAX_PASS_STAGES, which a test here
    changes."""
    for cached in (JN._twiddle_table, JN._power_table_full,
                   JN._cross_twiddles, ntt.plan):
        cached.cache_clear()
    yield
    ntt.plan.cache_clear()


def canonical(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    d[15] = rng.integers(0, 0x3064, size=n)
    return d.astype(np.uint32)


def T(arr):
    return convert.planes_to_torch(arr, "cpu")


def N(t) -> np.ndarray:
    return convert.planes_to_numpy(t)


def brev(q: torch.Tensor, bits: int) -> torch.Tensor:
    """__brev(q) >> (32 - bits), as the kernel computes a bit-reversed row."""
    r = torch.zeros_like(q)
    for b in range(32):
        r |= ((q >> b) & 1) << (31 - b)
    return r >> (32 - bits)


def model_pass(p: ntt.Pass, x: torch.Tensor, tw: torch.Tensor,
               tables) -> torch.Tensor:
    """One launch of ``pk_ntt_pass`` for ``p``, block by block, with the
    kernel's index and twiddle arithmetic (csrc/ntt_stage.cu:pass_body);
    values live as digit planes of the tile for the field operations."""
    L, k, lg, lc, lch = p.log_m, p.k, p.log_g, p.log_c, p.log_chunk
    lgc = lg + lc
    tile = 1 << p.log_tile
    packed_in = bool(p.flags & ntt.IN_PACKED)
    planes_in = ntt.unpack_limbs(x) if packed_in else x
    if p.flags & ntt.TW_PACKED:
        tw = ntt.unpack_limbs(tw)
    in_len = p.n if packed_in else x.shape[1]
    out = torch.zeros((16, p.n), dtype=torch.int32)
    written = torch.zeros(p.n, dtype=torch.int64)
    if p.flags & ntt.CROSS:
        hi, lo = (ntt.unpack_limbs(t) for t in tables[:2])
        a = tables[2]
    i = torch.arange(tile)
    b = torch.arange(tile // 2)
    quads = torch.arange(tile // 4)

    def butterfly(sm, ia, ib, e):
        """(x, y) <- (x + y, (x - y) w^e) on tile slots; no product for
        e = 0."""
        xa, xb = sm[:, ia], sm[:, ib]
        d = V.sub_mod(xa, xb)
        nz = e != 0
        d[:, nz] = V.mont_mul_plain(d[:, nz], tw[:, e[nz]])
        sm[:, ia] = V.add_mod(xa, xb)
        sm[:, ib] = d

    for bid in range(p.grid):
        cg = bid & ((1 << (lch - lc)) - 1)
        low0 = (bid >> (lch - lc)) << lg
        col0 = cg << lc
        # load
        if p.flags & ntt.IN_TRANSPOSED:
            g, c = i & ((1 << lg) - 1), (i >> lg) & ((1 << lc) - 1)
        else:
            c, g = i & ((1 << lc) - 1), (i >> lc) & ((1 << lg) - 1)
        h = i >> lgc
        row, col = (h << (L - k)) | (low0 + g), col0 + c
        if p.flags & ntt.IN_TRANSPOSED:
            e = (col << L) | row
        else:
            e = (row << lch) | col
        v = torch.zeros((16, tile), dtype=torch.int32)
        inside = e < in_len
        v[:, inside] = planes_in[:, e[inside]]
        li = (h << lgc) | (g << lc) | c
        assert torch.equal(li.sort().values, i)
        sm = torch.empty_like(v)
        sm[:, li] = v
        # k butterfly levels: pairs of levels on four elements a thread,
        # then an odd k's last level alone
        t = 0
        while t + 1 < k:
            bt = k - 2 - t
            gc, hq = quads & ((1 << lgc) - 1), quads >> lgc
            hm = hq & ((1 << bt) - 1)
            base = ((hq >> bt) << (bt + 2)) | hm
            lterm = ((low0 + (gc >> lc)) >> p.s0) << p.s0
            e0 = (hm << (L - k + t)) | (lterm << t)
            e1 = ((hm | (1 << bt)) << (L - k + t)) | (lterm << t)
            e2 = (hm << (L - k + t + 1)) | (lterm << (t + 1))
            idx = [((base | (j << bt)) << lgc) | gc for j in range(4)]
            butterfly(sm, idx[0], idx[2], e0)
            butterfly(sm, idx[1], idx[3], e1)
            butterfly(sm, idx[0], idx[1], e2)
            butterfly(sm, idx[2], idx[3], e2)
            t += 2
        for t in range(t, k):
            bit = k - 1 - t
            gc, hb = b & ((1 << lgc) - 1), b >> lgc
            hm = hb & ((1 << bit) - 1)
            ha = ((hb >> bit) << (bit + 1)) | hm
            lterm = ((low0 + (gc >> lc)) >> p.s0) << p.s0
            butterfly(sm, (ha << lgc) | gc, ((ha | (1 << bit)) << lgc) | gc,
                      (hm << (L - k + t)) | (lterm << t))
        # store
        c, h = i & ((1 << lc) - 1), (i >> lc) & ((1 << k) - 1)
        g = i >> (lc + k)
        v = sm[:, (h << lgc) | (g << lc) | c]
        q = ((low0 + g) << k) | h
        row = brev(q, L) if p.flags & ntt.OUT_BITREV else q
        col = col0 + c
        if p.flags & ntt.CROSS:
            e = row * col
            f = V.mont_mul_plain(hi[:, e >> a], lo[:, e & ((1 << a) - 1)])
            v = V.mont_mul_plain(v, f)
        o = (row << lch) | col
        out[:, o] = v
        written.index_add_(0, o, torch.ones_like(o))
    assert bool((written == 1).all())
    return ntt.pack_limbs(out) if p.flags & ntt.OUT_PACKED else out


def run_plan(run, x: torch.Tensor, log_n: int, inverse: bool,
             passes=None):
    """The transform of (16, n') planes as the launches of ``passes``
    (``ntt.plan`` by default), each through ``run`` (``model_pass`` or
    ``ntt.pass_plain``)."""
    tables = ntt.scale_tables(log_n, inverse, CPU)
    for p in passes or ntt.plan(log_n, inverse):
        x = run(p, x, ntt.pass_twiddles(p, inverse, CPU), tables)
    return x


@pytest.mark.parametrize("log_n", [9, 13])
def test_model_and_plain_passes_match_jax(log_n):
    """Single-phase 2^9 and four-step 2^13, forward and inverse, and the
    encode of half as many coefficients."""
    for inverse in (False, True):
        x = canonical(1 << log_n, seed=500 + log_n + inverse)
        want = np.asarray(JN._ntt_core(jnp.asarray(x), log_n, inverse))
        for run in (model_pass, ntt.pass_plain):
            got = run_plan(run, T(x), log_n, inverse)
            assert np.array_equal(N(got), want), (run, inverse)
    coeffs = canonical(1 << (log_n - 1), seed=600 + log_n)
    want = np.asarray(JN.rs_encode(jnp.asarray(coeffs), log_n, device=True))
    for run in (model_pass, ntt.pass_plain):
        assert np.array_equal(N(run_plan(run, T(coeffs), log_n, False)),
                              want)


@pytest.mark.parametrize("log_n", [6, 13])
def test_model_every_pass_size_matches_plain_core(monkeypatch, log_n):
    """Plans of passes of 1 .. 7 stages (single-phase 2^6 split as a
    phase, four-step 2^13 with chunks 64 and 128), forward and inverse, on
    a zero-padded tail."""
    n = 1 << log_n
    x = T(canonical(n - 37, seed=700 + log_n))
    for k in range(1, 8):
        monkeypatch.setattr(ntt, "MAX_PASS_STAGES", k)
        for inverse in (False, True):
            if log_n <= ntt.FOUR_STEP_MIN_LOG:
                passes = ntt._phase(log_n, 0, 0, ntt.OUT_BITREV
                                    | (ntt.CROSS if inverse else 0))
            else:
                passes = ntt.plan.__wrapped__(log_n, inverse)
            assert max(p.k for p in passes) <= k
            want = ntt._ntt_core(x, log_n, inverse, plain=True)
            got = run_plan(model_pass, x, log_n, inverse, passes)
            assert torch.equal(got, want), (k, inverse)


def test_model_passes_match_ntt_pass_plain():
    """``ntt_pass``'s own launches (planes in and out): every (s0, k) at
    chunks 1, 64 and 8192, and the last stages with the bit-reversed store
    (the sharded NTT's columns: the whole transform in one pass)."""
    for chunk, log_m in ((1, 7), (64, 5), (8192, 3)):
        n = chunk << log_m
        x = T(canonical(n, seed=800 + chunk))
        tw = ntt._twiddle_table(log_m, False, CPU)
        rev = ntt._bitrev_index(log_m, CPU)
        for k in range(1, log_m + 1):
            for s0 in range(log_m - k + 1):
                p = ntt._stage_pass(x, s0, k, chunk, 0)
                want = ntt.ntt_pass_plain(x, tw, s0, k, chunk)
                assert torch.equal(ntt.ntt_pass(x, tw, s0, k, chunk), want)
                assert torch.equal(model_pass(p, x, tw, None), want), (
                    chunk, s0, k)
                if s0 + k < log_m:
                    continue
                p = ntt._stage_pass(x, s0, k, chunk, ntt.OUT_BITREV)
                want = want.reshape(16, 1 << log_m, chunk)[:, rev].reshape(
                    16, n)
                assert torch.equal(
                    ntt.ntt_pass(x, tw, s0, k, chunk, bitrev=True), want)
                assert torch.equal(model_pass(p, x, tw, None), want), (
                    chunk, s0, k, "bitrev")
        with pytest.raises(ValueError):
            ntt.ntt_pass(x, tw, 0, log_m - 1, chunk, bitrev=True)


def test_plan_launch_targets_and_kernel_constants():
    """A 2^21 or 2^25 transform is four launches, 2^12 and below one; the
    first pass reads the planes, phase 1's last stores bit-reversed rows
    times the cross twiddles, phase 2's first reads transposed and its last
    stores the planes, so nothing runs between the launches.  The flags
    and the tile limits are the kernel's."""
    for log_n, launches in ((21, 4), (24, 4), (25, 4), (13, 2), (12, 1),
                            (1, 1)):
        passes = ntt.plan(log_n)
        assert len(passes) == launches
        assert sum(p.k for p in passes) == log_n
        assert passes[0].flags & ntt.IN_PACKED == 0
        assert passes[-1].flags & (ntt.OUT_PACKED | ntt.CROSS) == 0
        assert all(p.log_tile <= ntt.MAX_TILE_LOG for p in passes)
        if log_n > ntt.FOUR_STEP_MIN_LOG:
            flags = [p.flags for p in passes]
            assert sum(f & ntt.CROSS != 0 for f in flags) == 1
            assert sum(f & ntt.IN_TRANSPOSED != 0 for f in flags) == 1
            assert sum(f & ntt.OUT_BITREV != 0 for f in flags) == 2
            assert all(p.log_tile == ntt.TILE_LOG for p in passes)
    assert [p.route for p in ntt.plan(25)] == ["ntt_stage"] * 2 + [
        "butterfly"] * 2
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int k(\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("InPacked", "InTransposed",
                                        "OutPacked", "OutBitrev", "Cross",
                                        "TwPacked", "MaxTileLog")} == {
        "InPacked": ntt.IN_PACKED, "InTransposed": ntt.IN_TRANSPOSED,
        "OutPacked": ntt.OUT_PACKED, "OutBitrev": ntt.OUT_BITREV,
        "Cross": ntt.CROSS, "TwPacked": ntt.TW_PACKED,
        "MaxTileLog": ntt.MAX_TILE_LOG}
