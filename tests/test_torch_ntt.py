"""The torch port's NTT layer against the JAX package's, exactly.

* the plain ``ntt_stage`` (what the kernel wrapper runs on the CPU) against
  the JAX package's generic stage formula (``ops/ntt.py:_pease_flat``:
  decimated broadcast twiddles, butterfly, chunk interleave);
* ``ntt``, ``intt``, ``rs_encode`` and the wavelet at log n = 9
  (single-phase) and 13 (four-step) against ``_ntt_core`` /
  ``rs_encode(device=True)`` / ``_wavelet_dev`` and the host ``_host_ntt``;
* the butterfly route (which stages take the butterfly kernel) against the
  JAX package's own branches for log n = 1..26, ``butterfly_plain`` against
  ``butterfly_dispatch``, and the transform at 2^12 and 2^13, where every
  stage takes the butterfly route.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.fields import vector as JV
from provekit_tpu.ops import ntt as JN
from provekit_tpu.ops import pallas_kernels as JPK
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.ops import ntt

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_jax_tables():
    """The JAX package caches its twiddle tables per process, and its sharded
    tests fill those caches from inside ``shard_map`` traces: a worker that
    ran them first would hand this module traced arrays.  Start clean."""
    for cached in (JN._twiddle_table, JN._power_table_full,
                   JN._cross_twiddles):
        cached.cache_clear()


def canonical(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    d[15] = rng.integers(0, 0x3064, size=n)
    return d.astype(np.uint32)


def T(arr):
    return convert.planes_to_torch(arr, "cpu")


def N(t) -> np.ndarray:
    return convert.planes_to_numpy(t)


def jax_stage(x, tw, s: int, chunk: int):
    """The JAX package's unfused Pease stage (ops/ntt.py:_pease_flat)."""
    n = x.shape[1]
    half = n >> 1
    m = n // chunk
    dec = tw if s == 0 else jax.lax.slice(
        tw, (0, 0), (16, (m >> 1) - (1 << s) + 1), (1, 1 << s))
    a, b = x[:, :half], x[:, half:]
    rep = (1 << s) * chunk
    tw_s = jnp.broadcast_to(dec[:, :, None],
                            (16, m >> (s + 1), rep)).reshape(16, half)
    u = JV.add_mod(a, b)
    t = JV.mont_mul(JV.sub_mod(a, b), tw_s)
    return jnp.stack([u.reshape(16, half // chunk, chunk),
                      t.reshape(16, half // chunk, chunk)],
                     axis=2).reshape(16, n)


@pytest.mark.parametrize("chunk", [1, 4, 256])
@pytest.mark.parametrize("s", [0, 1, 2])
def test_ntt_stage_matches_jax_formula(chunk, s):
    n = 2048
    x = canonical(n, seed=chunk + 10 * s)
    log_m = (n // chunk).bit_length() - 1
    jtw = JN._twiddle_table(log_m, False)
    ttw = ntt._twiddle_table(log_m, False, torch.device("cpu"))
    assert np.array_equal(N(ttw), np.asarray(jtw))
    want = np.asarray(jax_stage(jnp.asarray(x), jtw, s, chunk))
    assert np.array_equal(N(ntt.ntt_stage(T(x), ttw, s, chunk)), want)
    assert np.array_equal(N(ntt.ntt_stage_plain(T(x), ttw, s, chunk)), want)


@pytest.fixture(scope="module", params=[9, 13])
def log_n(request):
    return request.param


def test_ntt_matches_jax_core(log_n):
    x = canonical(1 << log_n, seed=log_n)
    want = np.asarray(JN._ntt_core(jnp.asarray(x), log_n, False))
    assert np.array_equal(N(ntt.ntt(T(x))), want)


def test_ntt_intt_match_host(log_n):
    # the NTT is linear, so the Montgomery factor commutes with it and the
    # host transform of the raw digit values is the reference
    x = canonical(1 << log_n, seed=100 + log_n)
    vals = V.unpack(T(x))
    assert V.unpack(ntt.ntt(T(x))) == JN._host_ntt(vals, log_n, False)
    assert V.unpack(ntt.intt(T(x))) == JN._host_ntt(vals, log_n, True)
    assert np.array_equal(N(ntt.intt(ntt.ntt(T(x)))), x)


def test_rs_encode_matches_jax(log_n):
    coeffs = canonical(1 << (log_n - 1), seed=200 + log_n)
    want = np.asarray(JN.rs_encode(jnp.asarray(coeffs), log_n, device=True))
    assert np.array_equal(N(ntt.rs_encode(T(coeffs), log_n)), want)
    vals = V.unpack(T(coeffs)) + [0] * (1 << (log_n - 1))
    assert V.unpack(ntt.rs_encode(T(coeffs), log_n)) == JN._host_ntt(
        vals, log_n, False)


def test_wavelet_matches_jax(log_n):
    x = canonical(1 << log_n, seed=300 + log_n)
    want = np.asarray(JN._wavelet_dev(jnp.asarray(x), False))
    got = ntt.coeffs_of_evals(T(x))
    assert np.array_equal(N(got), want)
    assert np.array_equal(N(ntt.evals_of_coeffs(got)), x)


def jax_plan(log_n: int) -> list[tuple[int, int]]:
    """(n, chunk) of every Pease pass of the JAX package's ``_ntt_core``."""
    n = 1 << log_n
    if log_n <= JN.FOUR_STEP_MIN_LOG:
        return [(n, 1)]
    log_n1 = (log_n + 1) // 2
    return [(n, 1 << (log_n - log_n1)), (n, 1 << log_n1)]


def test_butterfly_route_matches_jax(monkeypatch):
    """The JAX package's branches, run as on a TPU (Pallas on), on shapes
    alone: its fused-stage switch, then ``butterfly_dispatch`` with the
    kernel and the field ops replaced by recorders."""
    monkeypatch.setenv("PROVEKIT_TPU_PALLAS", "1")
    taken = []
    monkeypatch.setattr(JPK, "butterfly_pallas",
                        lambda a, b, tw: taken.append(True))
    monkeypatch.setattr(JPK, "V", types.SimpleNamespace(
        add_mod=lambda a, b: None, sub_mod=lambda a, b: None,
        mont_mul=lambda a, b: None))

    def jax_takes_butterfly(n, chunk):
        if JPK.ntt_stage_enabled(chunk):
            return False
        taken.clear()
        half = types.SimpleNamespace(ndim=2, shape=(16, n // 2))
        JPK.butterfly_dispatch(half, half, half)
        return bool(taken)

    reached = []
    for log_n in range(1, 27):
        for n, chunk in jax_plan(log_n):
            want = jax_takes_butterfly(n, chunk)
            assert ntt.butterfly_route(n, chunk) == want, (log_n, chunk)
            if want and log_n not in reached:
                reached.append(log_n)
    assert reached == [12, 13, 14, 15, 25, 26]


def test_butterfly_plain_matches_jax_dispatch():
    half = 2048
    a, b, tw = (canonical(half, seed) for seed in (41, 42, 43))
    want = JPK.butterfly_dispatch(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(tw))
    got = ntt.butterfly_plain(T(a), T(b), T(tw))
    for g, w in zip(got, want):
        assert np.array_equal(N(g), np.asarray(w))


@pytest.mark.parametrize("log_n", [12, 13])
def test_ntt_butterfly_route(monkeypatch, log_n):
    """Every stage at 2^12 (chunk 1) and 2^13 (chunks 64 and 128) takes the
    butterfly route, whose CPU path is the plain stage.  The
    transform matches the JAX package's host NTT here; at 2^13 it is also
    held to ``_ntt_core`` by test_ntt_matches_jax_core[13]."""
    chunks = []
    kernel = ntt.butterfly
    monkeypatch.setattr(ntt, "butterfly", lambda x, tw, s, chunk: (
        chunks.append(chunk), kernel(x, tw, s, chunk))[1])
    x = canonical(1 << log_n, seed=400 + log_n)
    got = ntt.ntt(T(x))
    assert sorted(set(chunks)) == sorted({c for _, c in jax_plan(log_n)})
    assert len(chunks) == log_n
    assert V.unpack(got) == JN._host_ntt(V.unpack(T(x)), log_n, False)
