"""The port's WHIR hints and host statement helpers against the JAX
package's, exactly.

Hints are the Merkle openings and claimed evaluations that a proof carries
without absorbing them (``provekit_tpu_torch.whir.hints``): the same values,
made from a seeded generator, must serialize to the JAX package's bytes,
read back to themselves, and be refused with the JAX package's message
when they are malformed.  The statement's host helpers (the univariate
embedding's point and the eq weight's evaluation) are compared the same
way.  Everything here is host integers and bytes: no kernel, no compile.
"""

import random

import pytest

from provekit_tpu.ops import sumcheck as JSC
from provekit_tpu.whir import hints as JH
from provekit_tpu.whir import statement as JST
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.ops import sumcheck as SC
from provekit_tpu_torch.whir import hints as H
from provekit_tpu_torch.whir import statement as ST


def scalars(rng: random.Random, n: int) -> list[int]:
    """n field elements, with 0, 1 and P - 1 among them when n allows."""
    out = [rng.randrange(F.P) for _ in range(n)]
    for v in [0, 1, F.P - 1][:n]:
        out[rng.randrange(n)] = v
    return out


def multipath(rng: random.Random, leaves: int, depth: int):
    """(leaf_indexes, leaf_siblings, auth_paths_topdown) of ``leaves``
    openings in a tree of ``depth`` internal levels, sorted by index so
    that neighbouring paths share top-down prefixes as a real opening's
    do."""
    indexes = sorted(rng.sample(range(1 << depth), leaves))
    top = scalars(rng, depth)
    paths = []
    for _ in indexes:
        shared = rng.randrange(depth + 1)
        paths.append(top[:shared] + scalars(rng, depth - shared))
    return indexes, scalars(rng, leaves), paths


MULTIPATHS = {"none": (0, 4), "one": (1, 5), "many": (9, 6)}


@pytest.mark.parametrize("case", sorted(MULTIPATHS))
def test_multipath_bytes_are_jax_bytes(case):
    leaves, depth = MULTIPATHS[case]
    indexes, siblings, paths = multipath(random.Random(len(case)), leaves,
                                         depth)
    got = H.serialize_multipath(indexes, siblings, paths)
    assert got == JH.serialize_multipath(indexes, siblings, paths)
    assert H.deserialize_multipath(got) == (indexes, siblings, paths)
    assert H.deserialize_multipath(got) == JH.deserialize_multipath(got)


def test_stir_answers_bytes_are_jax_bytes():
    rng = random.Random(7)
    answers = [scalars(rng, k) for k in (0, 1, 4, 16)]
    got = H.serialize_stir_answers(answers)
    assert got == JH.serialize_stir_answers(answers)
    assert H.deserialize_stir_answers(got) == answers
    assert H.serialize_stir_answers([]) == JH.serialize_stir_answers([])


def test_scalar_vec_and_claimed_evaluations_are_jax_bytes():
    rng = random.Random(8)
    f_sums, g_sums = scalars(rng, 5), scalars(rng, 3)
    vec = H.serialize_scalar_vec(f_sums)
    assert vec == JH.serialize_scalar_vec(f_sums)
    assert H.deserialize_scalar_vec(vec) == f_sums
    claimed = H.serialize_claimed_evaluations(f_sums, g_sums)
    assert claimed == JH.serialize_claimed_evaluations(f_sums, g_sums)
    assert H.deserialize_claimed_evaluations(claimed) == (f_sums, g_sums)


def _good_multipath() -> bytes:
    return H.serialize_multipath(*multipath(random.Random(3), 3, 4))


def _u64(n: int) -> bytes:
    return n.to_bytes(8, "little")


# name -> (reader name, malformed bytes, what the refusal says)
MALFORMED = {
    "multipath_truncated": ("deserialize_multipath",
                            lambda: _good_multipath()[:-1], "truncated"),
    "multipath_trailing": ("deserialize_multipath",
                           lambda: _good_multipath() + b"\0", "trailing"),
    "multipath_length_mismatch": (
        "deserialize_multipath",
        lambda: _u64(1) + F.to_bytes_le(5) + _u64(0) + _u64(0) + _u64(0),
        "length mismatch"),
    "multipath_prefix_out_of_range": (
        "deserialize_multipath",
        lambda: (_u64(2) + F.to_bytes_le(1) + F.to_bytes_le(2)
                 + _u64(2) + _u64(0) + _u64(3)      # prefix lengths
                 + _u64(2) + _u64(0) + _u64(0)      # two empty suffixes
                 + _u64(2) + _u64(0) + _u64(1)),
        "prefix length out of range"),
    "stir_answers_non_canonical": (
        "deserialize_stir_answers",
        lambda: _u64(1) + _u64(1) + F.P.to_bytes(32, "little"),
        "non-canonical"),
    "stir_answers_absurd_length": ("deserialize_stir_answers",
                                   lambda: _u64(1 << 40), "absurd"),
    "scalar_vec_trailing": (
        "deserialize_scalar_vec",
        lambda: H.serialize_scalar_vec([1, 2]) + b"\1", "trailing"),
    "claimed_evaluations_truncated": (
        "deserialize_claimed_evaluations",
        lambda: H.serialize_claimed_evaluations([1], [2, 3])[:-8],
        "truncated"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_hints_are_refused_as_jax_refuses_them(case):
    reader, make, says = MALFORMED[case]
    data = make()
    with pytest.raises(ValueError) as want:
        getattr(JH, reader)(data)
    with pytest.raises(ValueError) as got:
        getattr(H, reader)(data)
    assert str(got.value) == str(want.value)
    assert says in str(got.value)


@pytest.mark.parametrize("m", [1, 5, 20])
def test_univariate_point_and_eq_weight_match_jax(m):
    rng = random.Random(m)
    z = rng.randrange(F.P)
    coords = ST.univariate_to_multilinear_point(z, m)
    assert coords == JST.univariate_to_multilinear_point(z, m)
    assert coords[-1] == z and coords[0] == pow(z, 1 << (m - 1), F.P)
    point = scalars(rng, m)
    w = ST.EvaluationWeights.from_univariate(z, m, "cpu")
    assert w.coords == coords and w.num_variables == m
    assert w.eval_mle(point) == JST.EvaluationWeights.from_univariate(
        z, m).eval_mle(point)
    assert SC.eq_point(coords, point) == JSC.eq_point(coords, point)
    # eq is 1 on its own point and 0 on any other corner of the cube
    corner = [rng.randrange(2) for _ in range(m)]
    other = [1 - corner[0]] + corner[1:]
    assert SC.eq_point(corner, corner) == 1
    assert SC.eq_point(corner, other) == 0
