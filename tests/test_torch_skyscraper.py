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
    """csrc/skyscraper_sponge.cuh, which skyscraper.cu and
    sumcheck_segment.cu include, carries the protocol's 18 round
    constants."""
    src = (CSRC / "skyscraper_sponge.cuh").read_text()
    table = re.search(r"RC\[18\]\[8\] = \{(.*?)\n\};", src, re.S).group(1)
    rows = re.findall(r"\{([^}]*)\}", table)
    got = [sum(int(x.strip().rstrip("u"), 16) << (32 * k)
               for k, x in enumerate(row.split(","))) for row in rows]
    assert got == S.ROUND_CONSTANTS == JS.ROUND_CONSTANTS
    assert all(c < F.P for c in got)


# ---------------------------------------------------------------------------
# edge values, the leaf fold and the duplex (the CUDA kernels' plain twins),
# and the kernels' own carry-chain arithmetic built for the host


def _edge_values() -> list[int]:
    """The ladder's edge values (0, 1, 2, P - 1, P - 2, 2^253, ..., four
    whose S-box output reaches 4P) and eight seeded random ones."""
    rng = np.random.default_rng(11)
    return S.edge_values(20261016) + [
        int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(8)]


def test_edge_values_match_scalar_and_jax():
    vals = _edge_values()
    # N pairs (the JAX functions' shape in the tests above): every edge
    # value on the left against four on the right
    ls = [v for v in vals for _ in range(4)][:N]
    rs = [vals[(i * 5 + 3) % len(vals)] for i in range(N)]
    tl, tr = V.pack(ls, "cpu"), V.pack(rs, "cpu")
    jl, jr = (jnp.asarray(convert.planes_to_numpy(t)) for t in (tl, tr))
    got = S.compress_plain(tl, tr)
    assert ints(got) == [S.compress(a, b) for a, b in zip(ls, rs)]
    assert np.array_equal(convert.planes_to_numpy(got),
                          np.asarray(JS.compress_v(jl, jr)))
    gl, gr = S.permute_plain(tl, tr)
    wl, wr = JS.permute_v(jl, jr)
    assert np.array_equal(convert.planes_to_numpy(gl), np.asarray(wl))
    assert np.array_equal(convert.planes_to_numpy(gr), np.asarray(wr))
    assert [S.bar(v) for v in vals[9:13]] == [JS.bar(v) for v in vals[9:13]]


@pytest.mark.parametrize("leaf_size", [2, 3, 32])
def test_compress_fold_plain_matches_jax(leaf_size):
    from provekit_tpu.ops import merkle as JM
    from provekit_tpu_torch.ops import merkle as M
    rng = np.random.default_rng(leaf_size)
    d = rng.integers(0, 1 << 16, size=(16, leaf_size, 8), dtype=np.int64)
    d[15] = rng.integers(0, 0x3064, size=(leaf_size, 8))
    leaves = d.astype(np.uint32)
    edge = V.pack(_edge_values()[:8], "cpu")
    leaves[:, 0, :] = convert.planes_to_numpy(edge)
    want = np.asarray(JM.hash_leaves(jnp.asarray(leaves)))
    # a strided view, as the commitment passes it; on the CPU hash_leaves
    # runs compress_fold_plain
    tl = torch.from_numpy(np.repeat(leaves, 2, axis=1).astype(
        np.int32))[:, 0::2, :]
    got = M.hash_leaves(tl)
    assert np.array_equal(convert.planes_to_numpy(got), want)


def _state(values) -> torch.Tensor:
    return V.pack(values, "cpu").reshape(16, 2)


@pytest.mark.parametrize("k,start_pos", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_duplex_absorb_matches_jax(k, start_pos):
    from provekit_tpu.fs import device as JD
    vals = _edge_values()
    state = _state([vals[3], vals[9]])
    arr = V.pack(vals[4:4 + k], "cpu")
    got, outs = S.duplex_v(state, arr, start_pos, 0)
    assert outs.shape == (16, 0)
    want = JD._absorb_jit(jnp.asarray(convert.planes_to_numpy(state)),
                          jnp.asarray(convert.planes_to_numpy(arr)), k,
                          start_pos)
    assert np.array_equal(convert.planes_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n", [1, 3])
def test_duplex_squeeze_matches_jax(n):
    from provekit_tpu.fs import device as JD
    vals = _edge_values()
    state = _state([vals[n], vals[10]])
    got_state, got = S.duplex_v(state, None, 0, n)
    want_state, want = JD._squeeze_jit(
        jnp.asarray(convert.planes_to_numpy(state)), n)
    assert np.array_equal(convert.planes_to_numpy(got), np.asarray(want))
    assert np.array_equal(convert.planes_to_numpy(got_state),
                          np.asarray(want_state))


@pytest.mark.parametrize("k", [3, 4])
def test_duplex_fused_step_matches_jax(k):
    """A fused round step's one call (absorb a round's k messages from
    position 0, squeeze its challenge) against the JAX absorb then
    squeeze."""
    from provekit_tpu.fs import device as JD
    vals = _edge_values()
    state = _state([vals[k], vals[11]])
    arr = V.pack(vals[5:5 + k], "cpu")
    got_state, got = S.duplex_v(state, arr, 0, 1)
    mid = JD._absorb_jit(jnp.asarray(convert.planes_to_numpy(state)),
                         jnp.asarray(convert.planes_to_numpy(arr)), k, 0)
    want_state, want = JD._squeeze_jit(mid, 1)
    assert np.array_equal(convert.planes_to_numpy(got), np.asarray(want))
    assert np.array_equal(convert.planes_to_numpy(got_state),
                          np.asarray(want_state))


def test_duplex_matches_host_sponge():
    """Absorb then squeeze in one call, against the scalar sponge, with the
    permutation count the wrapper reports."""
    from provekit_tpu_torch.fs.sponge import RATE, SkyscraperSponge
    vals = _edge_values()
    for start_pos, k, n in [(0, 4, 2), (1, 2, 1), (0, 0, 5), (1, 0, 0)]:
        calls = []
        real = S.permute_plain

        def counted(l, r):
            calls.append(1)
            return real(l, r)

        sponge = SkyscraperSponge.__new__(SkyscraperSponge)
        sponge.state = [vals[5], vals[6]]
        sponge.absorb_pos, sponge.squeeze_pos = start_pos, RATE
        S.permute_plain = counted
        try:
            st, outs = S.duplex_plain(_state(sponge.state),
                                      V.pack(vals[:k], "cpu") if k else None,
                                      start_pos, n)
        finally:
            S.permute_plain = real
        assert len(calls) == S.duplex_permutations(k, start_pos, n)
        if k:
            sponge.absorb(vals[:k])
        assert ints(outs) == (sponge.squeeze(n) if n else [])
        assert ints(st) == sponge.state


@pytest.fixture(scope="module")
def host_ladder(tmp_path_factory):
    """csrc/skyscraper_field.cuh built for the host
    (tests/skyscraper_host.cpp): the kernels' own carry chains, on an
    emulated carry flag."""
    import ctypes
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("sk_host") / "libsk_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(out),
                    str(Path(__file__).with_name("skyscraper_host.cpp"))],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.sk_lost.restype = ctypes.c_uint64
    rc = np.array([[(c >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                   for c in S.ROUND_CONSTANTS], dtype=np.uint32)
    lib.sk_set_rc(rc.ctypes.data_as(ctypes.c_void_p))
    return lib


def test_host_ladder_matches_plain(host_ladder):
    """The CUDA kernels' arithmetic (the dedicated square, the one lazy
    reduction a step, bar's branch-free reduction) equals the plain version
    on the edge values and 2,000 random ones, and no chain drops a carry."""
    import ctypes
    rng = np.random.default_rng(13)
    vals = _edge_values() + [int.from_bytes(rng.bytes(32), "little") % F.P
                             for _ in range(2000)]
    n = len(vals)
    a = convert.planes_to_numpy(V.pack(vals, "cpu"))
    b = np.ascontiguousarray(a[:, ::-1])
    out, out2 = np.zeros_like(a), np.zeros_like(a)

    def ptr(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    def unpack(x):
        return V.unpack(torch.from_numpy(x.astype(np.int32)))

    host_ladder.sk_sqr_lazy(ptr(a), ptr(out), ctypes.c_int64(n))
    sq = unpack(out)
    assert all(s < 2 * F.P and s % F.P == v * v * F.RINV % F.P
               for s, v in zip(sq, vals))
    host_ladder.sk_bar(ptr(a), ptr(out), ctypes.c_int64(n))
    assert unpack(out) == [S.bar(v) for v in vals]

    tl, tr = torch.from_numpy(a.astype(np.int32)), torch.from_numpy(
        b.astype(np.int32))
    host_ladder.sk_compress(ptr(a), ptr(b), ptr(out), ctypes.c_int64(n))
    assert torch.equal(torch.from_numpy(out.astype(np.int32)),
                       S.compress_plain(tl, tr))
    host_ladder.sk_permute(ptr(a), ptr(b), ptr(out), ptr(out2),
                           ctypes.c_int64(n))
    gl, gr = S.permute_plain(tl, tr)
    assert torch.equal(torch.from_numpy(out.astype(np.int32)), gl)
    assert torch.equal(torch.from_numpy(out2.astype(np.int32)), gr)
    assert host_ladder.sk_lost() == 0
