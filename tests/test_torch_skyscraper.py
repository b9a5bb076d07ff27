"""The torch port's Skyscraper against the JAX package's, exactly.

The batched plain versions (what the kernel wrappers run on the CPU) are
held against the JAX package's ``permute_v`` / ``compress_v`` at n = 64,
against the scalar reference, and against the Sage known-answer vectors of
``tests/test_skyscraper.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.hash import skyscraper as JS
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.hash import skyscraper as S

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

N = 64
CSRC = Path(__file__).resolve().parent.parent / "provekit_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def lr():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 1 << 16, size=(2, 16, N), dtype=np.int64)
    d[:, 15] = rng.integers(0, 0x3064, size=(2, N))
    d[:, :, 0] = 0  # include the all-zero pair
    return d[0].astype(np.uint32), d[1].astype(np.uint32)


def ints(t: torch.Tensor) -> list[int]:
    return V.unpack(t)


def test_compress_matches_jax(lr):
    l, r = lr
    want = np.asarray(JS.compress_v(jnp.asarray(l), jnp.asarray(r)))
    tl, tr = (convert.planes_to_torch(x, "cpu") for x in (l, r))
    assert np.array_equal(convert.planes_to_numpy(S.compress_v(tl, tr)), want)
    assert np.array_equal(convert.planes_to_numpy(S.compress_plain(tl, tr)),
                          want)


def test_permute_matches_jax(lr):
    l, r = lr
    wl, wr = JS.permute_v(jnp.asarray(l), jnp.asarray(r))
    tl, tr = (convert.planes_to_torch(x, "cpu") for x in (l, r))
    gl, gr = S.permute_v(tl, tr)
    assert np.array_equal(convert.planes_to_numpy(gl), np.asarray(wl))
    assert np.array_equal(convert.planes_to_numpy(gr), np.asarray(wr))


def test_batched_matches_scalar(lr):
    l, r = lr
    tl, tr = (convert.planes_to_torch(x, "cpu") for x in (l, r))
    ls, rs = ints(tl), ints(tr)
    gl, gr = S.permute_plain(tl, tr)
    assert list(zip(ints(gl), ints(gr))) == [S.permute(a, b)
                                             for a, b in zip(ls, rs)]
    assert ints(S.compress_plain(tl, tr[:, 5:6])) == [
        S.compress(a, rs[5]) for a in ls]
    assert [JS.compress(a, b) for a, b in zip(ls, rs)] == [
        S.compress(a, b) for a, b in zip(ls, rs)]


def _steps(k0, l, r):
    tl, tr = V.pack([l], "cpu"), V.pack([r], "cpu")
    for k in (k0, k0 + 1):
        tl, tr = S._step_plain(k, tl, tr)
    return ints(tl)[0], ints(tr)[0]


def test_ss_2():
    # reference.rs:105-122: two square-steps starting at round constant 2
    l = 11818428481613126259506041491792444971306025298632020312923851211664140080269
    r = 16089984100220651117533376273482359701319211672522891227502963383930673183481
    want = (2897520731550929941842826131888578795995028656093850302425034320680216166225,
            10274752619072178425540318899508997829349102488123199431506343228471746115261)
    assert _steps(2, l, r) == want


def test_bb_6():
    # reference.rs:136-152: the two bar steps 6 and 7
    l = 13251711941470795978907268022756015766767985221093713388330058285942871890923
    r = 1017722258958995329580328739423576514309327442471989504101393158056883989572
    want = (3193610555912363022088172260048956988022957239290210718020144819371540058981,
            17363210535454321713488811303876243393424286347736908007836172565366081010820)
    assert _steps(6, l, r) == want


def test_permute_zero():
    want = (5793276905781313965269111743763131906666794041798623267477617572701829069290,
            12296274483727574983376829575121280934973829438414198530604912453551798647077)
    assert S.permute(0, 0) == want
    z = V.zeros((1,), "cpu")
    gl, gr = S.permute_v(z, z)
    assert (ints(gl)[0], ints(gr)[0]) == want


def test_cuda_round_constants_match():
    """csrc/skyscraper.cu carries the protocol's 18 round constants."""
    src = (CSRC / "skyscraper.cu").read_text()
    table = re.search(r"RC\[18\]\[8\] = \{(.*?)\n\};", src, re.S).group(1)
    rows = re.findall(r"\{([^}]*)\}", table)
    got = [sum(int(x.strip().rstrip("u"), 16) << (32 * k)
               for k, x in enumerate(row.split(","))) for row in rows]
    assert got == S.ROUND_CONSTANTS == JS.ROUND_CONSTANTS
    assert all(c < F.P for c in got)
