"""The torch port's field layer against the JAX package's, exactly.

Inputs are numpy arrays from a seeded generator, handed to both packages as
the same (16, n) digit planes (``provekit_tpu_torch.convert``); every
compared value is a field element, so the tolerance is exact equality.  On
the CPU the port's kernel wrappers run their plain torch versions.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.fields import vector as JV
from provekit_tpu.fields import wide as JW
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.fields import wide as W

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

N = 1024
CSRC = Path(__file__).resolve().parent.parent / "provekit_tpu_torch" / "csrc"


def planes_of(vals) -> np.ndarray:
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(16)], dtype=np.uint32)


def ints_of(planes: np.ndarray) -> list[int]:
    return [sum(int(planes[i, j]) << (16 * i) for i in range(16))
            for j in range(planes.shape[1])]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    specials = [0, 1, F.P - 1, F.R]

    def canonical(n):
        d = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        d[15] = rng.integers(0, 0x3064, size=n)  # below P's top digit
        return d.astype(np.uint32)

    a = canonical(N)
    a[:, :4] = planes_of(specials)
    b = canonical(N)
    b[:, 4:8] = planes_of(specials)
    wide = rng.integers(0, 1 << 16, size=(16, N), dtype=np.int64).astype(
        np.uint32)
    wide[:, :2] = planes_of([(1 << 256) - 1, 5 * F.P])
    cols = rng.integers(0, 1 << 32, size=(16, N), dtype=np.uint64).astype(
        np.uint32)
    ids = rng.integers(0, 37, size=N).astype(np.int64)
    return {"a": a, "b": b, "wide": wide, "cols": cols, "ids": ids}


def jax_out(x) -> np.ndarray:
    return np.asarray(x)


def torch_out(x) -> np.ndarray:
    return convert.planes_to_numpy(x)


def T(arr):
    return convert.planes_to_torch(arr, "cpu")


# name -> (JAX call, torch call), each on the fixture's numpy arrays
CASES = {
    "add_mod": (lambda d: JV.add_mod(jnp.asarray(d["a"]), jnp.asarray(d["b"])),
                lambda d: V.add_mod(T(d["a"]), T(d["b"]))),
    "sub_mod": (lambda d: JV.sub_mod(jnp.asarray(d["a"]), jnp.asarray(d["b"])),
                lambda d: V.sub_mod(T(d["a"]), T(d["b"]))),
    "neg_mod": (lambda d: JV.neg_mod(jnp.asarray(d["a"])),
                lambda d: V.neg_mod(T(d["a"]))),
    "mont_mul": (lambda d: JV.mont_mul(jnp.asarray(d["a"]),
                                       jnp.asarray(d["b"])),
                 lambda d: V.mont_mul(T(d["a"]), T(d["b"]))),
    "mont_mul_broadcast": (
        lambda d: JV.mont_mul(jnp.asarray(d["a"]), jnp.broadcast_to(
            jnp.asarray(d["b"][:, 9:10]), d["a"].shape)),
        lambda d: V.mont_mul(T(d["a"]), T(d["b"][:, 9:10]))),
    "to_mont": (lambda d: JV.to_mont(jnp.asarray(d["a"])),
                lambda d: V.to_mont(T(d["a"]))),
    "from_mont": (lambda d: JV.from_mont(jnp.asarray(d["a"])),
                  lambda d: V.from_mont(T(d["a"]))),
    "reduce_256": (lambda d: JV.reduce_256(jnp.asarray(d["wide"])),
                   lambda d: V.reduce_256(T(d["wide"]))),
    "sum_mod": (lambda d: JV.sum_mod(jnp.asarray(d["a"])),
                lambda d: V.sum_mod(T(d["a"]))),
    "batch_inv_mont": (lambda d: JV.batch_inv_mont(jnp.asarray(d["a"])),
                       lambda d: V.batch_inv_mont(T(d["a"]))),
    "mont_pow": (lambda d: JV.mont_pow(jnp.asarray(d["a"]), 13),
                 lambda d: V.mont_pow(T(d["a"]), 13)),
    "reduce_wide": (lambda d: JW.reduce_wide(jnp.asarray(d["cols"])),
                    lambda d: W.reduce_wide(T(d["cols"]))),
    "segment_sum_mod": (
        lambda d: JW.segment_sum_mod(jnp.asarray(d["a"]), jnp.asarray(
            d["ids"].astype(np.int32)), 37),
        lambda d: W.segment_sum_mod(T(d["a"]), torch.from_numpy(d["ids"]),
                                    37)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(data, name):
    jax_fn, torch_fn = CASES[name]
    want = jax_out(jax_fn(data))
    got = torch_out(torch_fn(data))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_mont_mul_matches_ints(data):
    a, b = ints_of(data["a"]), ints_of(data["b"])
    got = V.unpack(V.mont_mul(T(data["a"]), T(data["b"])))
    assert got == [x * y * F.RINV % F.P for x, y in zip(a, b)]


def test_pack_unpack_bytes(data):
    vals = ints_of(data["a"])
    packed = V.pack(vals, "cpu")
    assert np.array_equal(convert.planes_to_numpy(packed),
                          np.asarray(JV.pack(vals)))
    assert V.unpack(packed) == JV.unpack(jnp.asarray(data["a"])) == vals
    assert (V.to_bytes_le_block(packed, check_canonical=True)
            == JV.to_bytes_le_block(jnp.asarray(data["a"]),
                                    check_canonical=True))
    with pytest.raises(AssertionError):
        V.to_bytes_le_block(T(planes_of([F.P])), check_canonical=True)


def test_convert_round_trip(data):
    t = convert.planes_to_torch(data["a"], "cpu")
    assert t.dtype == torch.int32
    assert np.array_equal(convert.planes_to_numpy(t), data["a"])

    from provekit_tpu.r1cs import R1CS as JR1CS
    from provekit_tpu.whir.parameters import WhirConfig as JWhirConfig
    jr = JR1CS()
    w = jr.new_witnesses(3)
    jr.add_constraint([(2, w)], [(1, w + 1)], [(F.P - 1, w + 2), (7, 0)])
    jr.add_constraint([(1, 0)], [(1, w)], [(1, w)])
    coo = convert.r1cs_to_coo(jr)
    r = convert.r1cs_from_coo(coo)
    assert convert.r1cs_to_coo(r) == coo
    assert (r.num_constraints, r.num_witnesses) == (2, 4)

    cfg = JWhirConfig(num_variables=9, batch_size=2, security_level=40,
                      folding_factor=3)
    fields = convert.whir_config_fields(cfg)
    port = convert.whir_config_from_fields(fields)
    assert [vars(x) for x in port.rounds] == [vars(x) for x in cfg.rounds]
    assert port.final_queries == cfg.final_queries


def test_kernel_wrapper_never_falls_back():
    """A tensor that is not on the CPU never reaches the plain version: a
    CUDA operand launches the kernel, anything else raises."""
    x = torch.empty((16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        V.mont_mul(x, x)
    c = torch.zeros((16, 4), dtype=torch.int64)
    assert V.mont_mul(c.to(torch.int32), c.to(torch.int32)).device.type == \
        "cpu"


def test_cuda_constants_match():
    """csrc/field.cuh carries the JAX package's P and -P^-1 mod 2^32."""
    src = (CSRC / "field.cuh").read_text()
    body = re.search(r"P\[8\] = \{([^}]*)\}", src).group(1)
    limbs = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    assert sum(l << (32 * k) for k, l in enumerate(limbs)) == F.P
    assert V.P_LIMBS.tolist() == JV.P_LIMBS.tolist()
    nprime0 = int(re.search(r"NPRIME0 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert nprime0 == JV.NPRIME256 & 0xFFFFFFFF
    assert (nprime0 * F.P) % (1 << 32) == (1 << 32) - 1
