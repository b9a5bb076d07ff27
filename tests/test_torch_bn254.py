"""The port's host field arithmetic (``provekit_tpu_torch.fields.bn254``)
against the JAX package's, exactly.

These plain-integer functions make the prover's challenges, the verifier's
checks and the test oracles, so each must give the JAX package's value on
the same seeded inputs and on the edge values 0, 1, 2, P - 2, P - 1, R and
R^2.  The port's inverse takes another route (extended Euclid, where the
JAX package raises to P - 2): the values must still agree.
"""

import random

import pytest

from provekit_tpu.fields import bn254 as JF
from provekit_tpu_torch.fields import bn254 as F

EDGES = [0, 1, 2, F.P - 2, F.P - 1, F.R, F.R2]


def values(seed: int, n: int = 64) -> list[int]:
    rng = random.Random(seed)
    return EDGES + [rng.randrange(F.P) for _ in range(n)]


def pairs(seed: int) -> list[tuple[int, int]]:
    a, b = values(seed), values(seed + 1)
    return [(x, y) for x in EDGES for y in EDGES] + list(zip(a, b))


# name -> its calls on one seeded list of arguments, made on either module
CASES = {
    "add": lambda m: [m.add(x, y) for x, y in pairs(1)],
    "sub": lambda m: [m.sub(x, y) for x, y in pairs(2)],
    "neg": lambda m: [m.neg(x) for x in values(3)],
    "mul": lambda m: [m.mul(x, y) for x, y in pairs(4)],
    "sqr": lambda m: [m.sqr(x) for x in values(5)],
    "inv": lambda m: [m.inv(x) for x in values(6) if x],
    "pow": lambda m: [m.pow_(x, e) for x in values(7, 8)
                      for e in (0, 1, 2, 13, F.P - 2, F.P - 1, 1 << 255)],
    "root_of_unity": lambda m: [m.root_of_unity(k) for k in range(29)],
    "bytes": lambda m: [(m.to_bytes_le(x), m.from_bytes_le(m.to_bytes_le(x)))
                        for x in values(8)]
    + [m.from_bytes_le(bytes([0xFF]) * 32)],
    "limbs": lambda m: [(m.to_limbs(x), m.from_limbs(m.to_limbs(x)))
                        for x in values(9)],
    "mont": lambda m: [(m.to_mont(x), m.from_mont(x),
                        m.from_mont(m.to_mont(x))) for x in values(10)],
    "constants": lambda m: [m.P, m.BITS, m.BYTES, m.NLIMBS, m.LIMB_BITS, m.R,
                            m.R2, m.R3, m.RINV, m.NPRIME16, m.GENERATOR,
                            m.TWO_ADICITY, m.ROOT_OF_UNITY, m.HALF],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_field_matches_jax(name):
    assert CASES[name](F) == CASES[name](JF)


def test_host_field_laws():
    """What the values above must also satisfy, checked on the port."""
    for x, y in pairs(11):
        assert F.sub(F.add(x, y), y) == x % F.P
        assert F.add(x, F.neg(x)) == 0
        assert F.mul(x, y) == F.mul(y, x)
        if x % F.P:
            assert F.mul(x, F.inv(x)) == 1
    w = F.root_of_unity(F.TWO_ADICITY)
    assert F.pow_(w, 1 << F.TWO_ADICITY) == 1
    assert F.pow_(w, 1 << (F.TWO_ADICITY - 1)) == F.P - 1
    assert F.mul(F.HALF, 2) == 1
    assert F.from_mont(F.to_mont(5)) == 5 and F.to_mont(1) == F.R


@pytest.mark.parametrize("call", ["inv_zero", "root_past_two_adicity"])
def test_host_field_refuses_as_jax_refuses(call):
    def run(m):
        if call == "inv_zero":
            return m.inv(0)
        return m.root_of_unity(m.TWO_ADICITY + 1)
    want = ZeroDivisionError if call == "inv_zero" else ValueError
    with pytest.raises(want) as jx:
        run(JF)
    with pytest.raises(want) as got:
        run(F)
    assert str(got.value) == str(jx.value)
