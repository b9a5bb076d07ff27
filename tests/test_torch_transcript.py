"""The torch port's transcript, PoW, Merkle and mask stream against the JAX
package's, exactly: same inputs, same bytes, nonces, roots, paths, bits."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.fs import DomainSeparator as JDomainSeparator
from provekit_tpu.ops import merkle as JM
from provekit_tpu.ops import pow as JP
from provekit_tpu.protocol import spartan as JSP
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.fs import DomainSeparator
from provekit_tpu_torch.fs.device import DeviceProverState
from provekit_tpu_torch.ops import merkle as M
from provekit_tpu_torch.ops import pow as P
from provekit_tpu_torch.protocol import spartan as SP

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _pattern(ds):
    (ds.absorb(2, "a").squeeze(3, "s").absorb(1, "b").absorb(2, "c")
       .squeeze(1, "t").hint("h").absorb(1, "d"))
    return ds


def test_device_transcript_matches_host():
    """Mirror of tests/test_device_fs.py::test_device_transcript_matches_host
    against the JAX package's host ProverState."""
    rng = random.Random(7)
    vals1 = [rng.randrange(F.P) for _ in range(2)]
    vals2 = [rng.randrange(F.P) for _ in range(2)]

    h = _pattern(JDomainSeparator("test")).to_prover_state()
    h.add_scalars(vals1)
    ch1 = h.challenge_scalars(3)
    h.add_scalars([ch1[0]])
    h.add_scalars(vals2)
    ch2 = h.challenge_scalars(1)
    h.hint_bytes(b"hello")
    h.add_scalars([ch2[0]])
    host_narg = h.narg_string()

    d = DeviceProverState(_pattern(DomainSeparator("test")), CPU)
    d.add_scalars(vals1)
    c1 = d.challenge_scalars_dev(3)
    assert V.unpack(c1) == ch1
    d.add_scalars_dev(c1[:, :1])
    d.add_scalars(vals2)
    c2 = d.challenge_scalars_dev(1)
    d.hint_bytes(b"hello")
    d.add_scalars_dev(c2)
    assert d.narg_string() == host_narg

    v = _pattern(DomainSeparator("test")).to_verifier_state(host_narg)
    assert v.next_scalars(2) == vals1
    assert v.challenge_scalars(3) == ch1


@pytest.mark.parametrize("bits", [2.0, 6.0])
def test_pow_solve_dev_matches_jax(bits):
    rng = random.Random(3 + int(bits))
    ch = rng.randrange(1 << 200)
    want = JP.solve(ch, bits)
    got = V.unpack(P.solve_dev(V.pack([ch], CPU).reshape(16, 1), bits))[0]
    assert got == want
    assert P.verify(ch, bits, got) and JP.verify(ch, bits, got)
    assert P.threshold(bits + P.PROVER_BIAS) == JP.threshold(
        bits + JP.PROVER_BIAS)


def test_merkle_matches_jax():
    rng = np.random.default_rng(5)
    leaves = rng.integers(0, 1 << 16, size=(16, 4, 64), dtype=np.int64)
    leaves[15] = rng.integers(0, 0x3064, size=(4, 64))
    leaves = leaves.astype(np.uint32)
    jtree = JM.commit(jnp.asarray(leaves))
    tree = M.commit_dev(convert.planes_to_torch(leaves, CPU))
    assert tree.depth == jtree.depth
    assert tree.root() == jtree.root()
    assert np.array_equal(convert.planes_to_numpy(M.root_dev(tree)),
                          np.asarray(JM.root_dev(jtree)))
    idx = [0, 5, 5, 63, 17]
    paths = tree.open(idx)
    assert paths == jtree.open(idx)
    flat = M.open_gather_dev(tree, torch.tensor(idx))
    assert np.array_equal(
        convert.planes_to_numpy(flat),
        np.asarray(JM.open_gather_dev(jtree, jnp.asarray(idx, jnp.uint32))))
    vals = V.unpack(convert.planes_to_torch(leaves, CPU).reshape(16, -1))
    for i, path in zip(idx, paths):
        leaf = [vals[k * 64 + i] for k in range(4)]
        assert M.verify_path(tree.root(), leaf, i, path)
        assert JM.verify_path(tree.root(), leaf, i, path)
        assert not M.verify_path(tree.root(), leaf, i ^ 1, path)


def test_mask_stream_matches_jax_random_bits():
    bits = random.Random(9).getrandbits(256)
    jkey = JSP._key_from_256_bits(bits)
    key = SP.key_from_256_bits(bits)
    assert [int(x) for x in np.asarray(jkey)] == list(key)  # raw uint32 key
    want = np.asarray(jax.random.bits(jkey, (16, 64), jnp.uint32))
    got = SP.random_bits(key, (16, 64), CPU).numpy()
    assert np.array_equal(got.astype(np.uint64), want.astype(np.uint64))


def test_random_mont_matches_jax():
    rng_j, rng_t = random.Random(11), random.Random(11)
    want = np.asarray(JSP.random_mont_dev(64, rng_j))
    got = convert.planes_to_numpy(SP.random_mont_dev(64, CPU, rng_t))
    assert np.array_equal(got, want)
    # both consumed the same 256 bits of the caller's rng
    assert rng_j.getrandbits(64) == rng_t.getrandbits(64)
