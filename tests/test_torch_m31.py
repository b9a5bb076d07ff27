"""The port's M31/CM31 module (provekit_tpu_torch.fields.m31) exactly
against the JAX package's, on seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.fields import m31 as J
from provekit_tpu_torch.fields import m31 as T

P = T.P31
EDGE = [0, 1, 2, P - 2, P - 1, 0xFFFF, 0x10000, 0x7FFF8000, 0x12345678,
        1 << 30]


@pytest.fixture(autouse=True)
def _fresh_jax_twiddles():
    """The JAX module caches its CM31 twiddles (``functools.cache``) from
    inside the jitted NTT's trace: after ``jax.clear_caches()`` (the
    conftest's, between modules) a retrace at a cached size meets the old
    trace's leaked tracers.  Start and end each test with the cache empty,
    so that neither this module nor ``tests/test_m31.py`` after it in the
    same worker finds them."""
    J._cm31_stage_twiddles.cache_clear()
    yield
    J._cm31_stage_twiddles.cache_clear()


def _lanes(rng, n: int) -> np.ndarray:
    return np.concatenate([np.array(EDGE, dtype=np.int64),
                           rng.integers(0, P, size=n, dtype=np.int64)])


def _both(x: np.ndarray):
    return torch.from_numpy(x), jnp.asarray(x.astype(np.uint32))


def _eq(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_scalar_reference_and_constants_are_the_jax_modules():
    assert (T.P31, T.CM31_GROUP_ORDER, T.CM31_TWO_ADICITY,
            T.CM31_GENERATOR) == (J.P31, J.CM31_GROUP_ORDER,
                                  J.CM31_TWO_ADICITY, J.CM31_GENERATOR)
    for k in (0, 1, 5, 20, 32):
        assert T.cm31_root_of_unity(k) == J.cm31_root_of_unity(k)
    a, b = (123456789, 987654321), (P - 1, 7)
    assert T.cm31_mul(a, b) == J.cm31_mul(a, b)
    assert T.cm31_inv(a) == J.cm31_inv(a)
    assert T.cm31_mul(a, T.cm31_inv(a)) == (1, 0)
    assert T.m31_mul(P - 1, P - 1) == J.m31_mul(P - 1, P - 1) == 1


@pytest.mark.parametrize("op", ["vadd", "vsub", "vmul"])
def test_m31_vector_ops(op):
    rng = np.random.default_rng(31)
    a, b = _lanes(rng, 256), _lanes(rng, 256)[::-1].copy()
    # every pair of edge values as well
    ea, eb = (np.array(v, dtype=np.int64)
              for v in zip(*[(x, y) for x in EDGE for y in EDGE]))
    for x, y in ((a, b), (ea, eb)):
        (tx, jx), (ty, jy) = _both(x), _both(y)
        assert _eq(getattr(T, op)(tx, ty), getattr(J, op)(jx, jy))


@pytest.mark.parametrize("op", ["cvmul", "cvadd", "cvsub"])
def test_cm31_vector_ops(op):
    rng = np.random.default_rng(32)
    parts = [_lanes(rng, 128) for _ in range(4)]
    t_args = [torch.from_numpy(p) for p in parts]
    j_args = [jnp.asarray(p.astype(np.uint32)) for p in parts]
    got = getattr(T, op)(*t_args)
    want = getattr(J, op)(*j_args)
    assert all(_eq(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_cm31_ntt_and_inverse(log_n):
    rng = np.random.default_rng(33 + log_n)
    n = 1 << log_n
    xr, xi = (rng.integers(0, P, size=n, dtype=np.int64) for _ in range(2))
    tr, ti = T.cm31_ntt(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = J.cm31_ntt(jnp.asarray(xr.astype(np.uint32)),
                        jnp.asarray(xi.astype(np.uint32)))
    assert _eq(tr, jr) and _eq(ti, ji)
    br, bi = T.cm31_intt(tr, ti)
    kr, ki = J.cm31_intt(jr, ji)
    assert _eq(br, kr) and _eq(bi, ki)
    assert np.array_equal(br.numpy(), xr) and np.array_equal(bi.numpy(), xi)
