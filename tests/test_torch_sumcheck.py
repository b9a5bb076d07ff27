"""The torch port's sumcheck layer against the JAX package's, exactly.

Small shapes, and ``CHEAP_SYNC`` on where the JAX package reads it, so its
functions take their host (Python int) reference paths and cost no XLA
compile.  Every compared value is a field element.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu import config as jax_config
from provekit_tpu.ops import sumcheck as JS
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.ops import sumcheck as S

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

M = 6
N = 1 << M


def canonical(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(16, *shape), dtype=np.int64)
    d[15] = rng.integers(0, 0x3064, size=shape)
    return d.astype(np.uint32)


def T(arr):
    return convert.planes_to_torch(arr, "cpu")


def same(got, want) -> bool:
    return np.array_equal(convert.planes_to_numpy(got), np.asarray(want))


@pytest.fixture
def host_paths(monkeypatch):
    monkeypatch.setattr(jax_config, "CHEAP_SYNC", True)


@pytest.fixture(scope="module")
def alpha():
    a = canonical((1,), seed=7)[:, 0]
    return a, jnp.asarray(a), T(a)


def test_eq_table_and_scalars():
    rng = random.Random(4)
    rs = [rng.randrange(F.P) for _ in range(M)]
    alphas = [rng.randrange(F.P) for _ in range(M)]
    assert same(S.eq_table(rs, "cpu"), JS.eq_table(rs))
    assert S.eq_point(rs, alphas) == JS.eq_point(rs, alphas)
    assert S.eval_cubic(rs[:4], alphas[0]) == JS.eval_cubic(rs[:4], alphas[0])


@pytest.mark.parametrize("order", ["msb", "lsb"])
def test_fold_stacked(alpha, order):
    x = canonical((2, N), seed=1)
    _, ja, ta = alpha
    port = S.fold_stacked_msb if order == "msb" else S.fold_stacked_lsb
    ref = JS.fold_stacked_msb if order == "msb" else JS.fold_stacked_lsb
    assert same(port(T(x), ta), ref(jnp.asarray(x), ja))


def test_spartan_round_stacked():
    abce = canonical((4, N), seed=2)
    got = S.spartan_round_stacked(T(abce))
    want = JS.spartan_round_stacked(jnp.asarray(abce))
    assert all(same(g, w) for g, w in zip(got, want))


def test_whir_round_split_and_fold(alpha):
    fw = canonical((2, N), seed=3)
    _, ja, ta = alpha
    ev, d, *sums = S.whir_round_split_dev(T(fw))
    want = JS.whir_round_stacked(jnp.asarray(fw))
    assert all(same(g, w) for g, w in zip(sums, want))
    assert all(same(g, w) for g, w in zip(S.whir_round_stacked(T(fw)), want))
    assert same(S.fold_from_split_dev(ev, d, ta),
                JS.fold_stacked_lsb(jnp.asarray(fw), ja))


def test_weighted_sum(host_paths):
    w, v = canonical((N,), seed=5), canonical((N,), seed=6)
    assert same(S.weighted_sum(T(w), T(v)),
                JS.weighted_sum(jnp.asarray(w), jnp.asarray(v)))


def test_eq_combination_and_mle_evaluation(host_paths):
    p = 3
    coords = canonical((M, p), seed=8)
    coeffs = canonical((p,), seed=9)
    evals = canonical((N,), seed=10)
    assert same(S.combine_eq_weights_dev(T(coords), T(coeffs), M),
                JS.combine_eq_weights_dev(jnp.asarray(coords),
                                          jnp.asarray(coeffs), M))
    # host points (canonical) of the same coordinates, MSB-first
    flat = [F.from_mont(v) for v in V.unpack(T(coords))]
    points = [[flat[k * p + j] for k in range(M)] for j in range(p)]
    want = JS.eval_multilinear_batch(jnp.asarray(evals), points)
    got = V.unpack(V.from_mont(S.eval_multilinear_batch_dev(T(evals),
                                                            T(coords))))
    assert got == want
    assert S.eval_multilinear_batch(T(evals), points) == want
    assert S.eval_multilinear(T(evals), points[0]) == want[0]
