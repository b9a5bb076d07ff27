"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA card and skip without one.  The card's machine
has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from provekit_tpu_torch.experiments import mxu_mont as M
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.hash import skyscraper as S
from provekit_tpu_torch.ops import ntt
from provekit_tpu_torch.utils.profiling import device_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def canonical(n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    d[15] = rng.integers(0, 0x3064, size=n)
    return torch.from_numpy(d.astype(np.int32)).to(device)


def test_mont_mul_kernel(cuda):
    a, b = canonical(4096, 1, cuda), canonical(4096, 2, cuda)
    a[:, :4] = V.pack([0, 1, F.P - 1, F.R], cuda)
    before = V.mont_mul.launches
    assert torch.equal(V.mont_mul(a, b), V.mont_mul_plain(a, b))
    assert torch.equal(V.mont_mul(a, b[:, 3:4]), V.mont_mul_plain(a, b[:, 3:4]))
    assert torch.equal(V.mont_mul(a[:, 0::2], b[:, 1::2]),
                       V.mont_mul_plain(a[:, 0::2], b[:, 1::2]))
    assert V.mont_mul.launches == before + 3


@pytest.mark.parametrize("chunk", [1, 4, 256, 1024])
def test_ntt_stage_kernel(cuda, chunk):
    x = canonical(4096, chunk, cuda)
    tw = ntt._twiddle_table((4096 // chunk).bit_length() - 1, False, cuda)
    for s in range(min(3, (4096 // chunk).bit_length() - 1)):
        assert torch.equal(ntt.ntt_stage(x, tw, s, chunk),
                           ntt.ntt_stage_plain(x, tw, s, chunk))


@pytest.mark.parametrize("chunk", [1, 2, 4, 64, 8192])
def test_butterfly_kernel(cuda, chunk):
    n = max(4096, 4 * chunk)
    x = canonical(n, 10 + chunk, cuda)
    tw = ntt._twiddle_table((n // chunk).bit_length() - 1, False, cuda)
    before = ntt.butterfly.launches
    for s in range(min(3, (n // chunk).bit_length() - 1)):
        got = ntt.butterfly(x, tw, s, chunk)
        assert torch.equal(got, ntt.ntt_stage_plain(x, tw, s, chunk))
        assert torch.equal(got, ntt.ntt_stage(x, tw, s, chunk))
    assert ntt.butterfly.launches > before


def test_butterfly_route_on_card(cuda):
    # 2^13: both four-step phases (chunks 64 and 128) take the butterfly's
    # route, one pass each, 13 stages
    x = canonical(1 << 13, 8, cuda)
    before = ntt.butterfly.launches, ntt.ntt_pass.stages
    assert torch.equal(ntt.ntt(x), ntt._ntt_core(x, 13, False, plain=True))
    assert ntt.butterfly.launches == before[0] + 2
    assert ntt.ntt_pass.stages == before[1] + 13


def pass_input(p, x: torch.Tensor) -> torch.Tensor:
    """The operand of a pass of a plan: planes, or packed limbs in the
    pass's input layout."""
    return ntt.pack_limbs(x) if p.flags & ntt.IN_PACKED else x


def test_ntt_pass_kernel_at_path_shapes(cuda):
    """Every pass of the transforms the paths run at 2^21 (poseidon2
    x1000), 2^24 (passport) and 2^25 (sha256 x100), forward and inverse,
    against its plain version; the first pass on a half-size input (the
    zero padding); ntt_pass's own launches (planes in and out, and the
    last stages stored bit-reversed)."""
    for log_n in (21, 24, 25):
        n = 1 << log_n
        x = canonical(n, 20 + log_n, cuda)
        for inverse in (False, True):
            tables = ntt.scale_tables(log_n, inverse, cuda)
            for i, p in enumerate(ntt.plan(log_n, inverse)):
                tw = ntt.pass_twiddles(p, inverse, cuda)
                xin = x[:, :n // 2] if i == 0 else pass_input(p, x)
                got = ntt._launch(p, xin, tw, tables)
                want = ntt.pass_plain(p, xin, tw, tables)
                assert torch.equal(got, want), (inverse, p.key)
                del got, want, xin
        log_m = log_n // 2
        tw = ntt._twiddle_table(log_m, False, cuda)
        chunk = n >> log_m
        for k in (1, 4, 7):
            assert torch.equal(ntt.ntt_pass(x, tw, 0, k, chunk),
                               ntt.ntt_pass_plain(x, tw, 0, k, chunk))
        # the last stages, stored bit-reversed
        rev = ntt._bitrev_index(log_m, cuda)
        want = ntt.ntt_pass_plain(x, tw, log_m - 7, 7, chunk)
        assert torch.equal(
            ntt.ntt_pass(x, tw, log_m - 7, 7, chunk, bitrev=True),
            want.reshape(16, 1 << log_m, chunk)[:, rev].reshape(16, n))
        del want
        del x
        torch.cuda.empty_cache()


def test_ntt_pass_edges_and_inverse(cuda):
    """0, 1 and P - 1 (and random values) through the single-phase and the
    four-step transforms, both ways; the inverse undoes the forward."""
    edge = V.pack([0, 1, F.P - 1], cuda)
    for log_n in (1, 5, 12, 13, 16, 21):
        n = 1 << log_n
        x = canonical(n, log_n, cuda)
        x[:, : n // 2] = edge.repeat(1, n)[:, : n // 2]
        for inverse in (False, True):
            want = ntt._ntt_core(x, log_n, inverse, plain=True)
            assert torch.equal(ntt._ntt_core(x, log_n, inverse), want)
        assert torch.equal(ntt.intt(ntt.ntt(x)), x)
        coeffs = x[:, : max(1, n // 4) + 3][:, :n]
        assert torch.equal(ntt.rs_encode(coeffs, log_n),
                           ntt.rs_encode(coeffs, log_n, plain=True))


def test_ntt_launch_counts(cuda):
    """A transform is its plan's launches of pk_ntt_pass and nothing else:
    no gather, transpose, pad or Montgomery product between them; 2^13 in
    two launches, 2^21 and 2^25 in four."""
    for log_n, launches in ((13, 2), (21, 4), (25, 4)):
        coeffs = canonical(1 << (log_n - 1), 30 + log_n, cuda)
        ntt.rs_encode(coeffs, log_n)  # the tables, built once
        torch.cuda.synchronize()
        before = ntt.ntt_pass.launches, V.mont_mul.launches
        ntt.rs_encode(coeffs, log_n)
        assert ntt.ntt_pass.launches == before[0] + launches
        assert V.mont_mul.launches == before[1]
        # every device kernel the profiler sees in an encode is a pass, of
        # every route of the plan (it can lose a record: PERF.md section 7)
        kernels = device_kernels(lambda: ntt.rs_encode(coeffs, log_n))
        assert all("ntt_pass_kernel" in k for k in kernels), kernels
        assert 0 < len(kernels) <= launches, kernels
        for p in ntt.plan(log_n):
            route = f"ntt_pass_kernel<{ntt.ROUTES.index(p.route)},"
            assert any(route in k for k in kernels), (p.route, kernels)


@pytest.mark.parametrize("n", [1, 3, 64, 4096 + 37, 1 << 16])
def test_mont_mul_mma_kernel(cuda, n):
    a, b = canonical(n, 11, cuda), canonical(n, 12, cuda)
    k = min(n, 4)
    a[:, :k] = V.pack([0, 1, F.P - 1, F.R][:k], cuda)
    b[:, :k] = V.pack([F.P - 1] * k, cuda)
    before = M.mont_mul_mma.launches
    got = M.mont_mul_mma(a, b)
    assert torch.equal(got, V.mont_mul_plain(a, b))
    assert torch.equal(got, M.mont_mul_mma_plain(a, b))
    assert M.mont_mul_mma.launches == before + 1


def test_mont_mul_mma_kernel_edges_and_layouts(cuda):
    a, b = M.edge_operands(cuda)
    assert torch.equal(M.mont_mul_mma(a, b), M.mont_mul_mma_plain(a, b))
    # a strided view, made contiguous by the wrapper
    x, y = canonical(2 * 4096, 13, cuda), canonical(4096, 14, cuda)
    assert torch.equal(M.mont_mul_mma(x[:, 0::2], y),
                       M.mont_mul_mma_plain(x[:, 0::2], y))
    # n % 4 == 0 on a base 4 bytes past 16-byte alignment: the plain fill
    flat = torch.empty(16 * 256 + 1, dtype=torch.int32, device=cuda)
    odd = flat[1:].view(16, 256)
    odd.copy_(canonical(256, 15, cuda))
    assert odd.data_ptr() % 16 == 4
    assert torch.equal(M.mont_mul_mma(odd, y[:, :256]),
                       M.mont_mul_mma_plain(odd, y[:, :256]))


def test_rs_encode_kernel_path(cuda):
    coeffs = canonical(1 << 12, 7, cuda)
    assert torch.equal(ntt.rs_encode(coeffs, 14),
                       ntt.rs_encode(coeffs, 14, plain=True))


def test_skyscraper_kernels(cuda):
    l, r = canonical(512, 3, cuda), canonical(512, 4, cuda)
    assert torch.equal(S.compress_v(l, r), S.compress_plain(l, r))
    assert torch.equal(S.compress_v(l[:, :1], r), S.compress_plain(l[:, :1], r))
    got = S.permute_v(l[:, :1], r[:, :1])
    want = S.permute_plain(l[:, :1], r[:, :1])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lv, rv = V.unpack(l[:, :1])[0], V.unpack(r[:, :1])[0]
    assert (V.unpack(got[0])[0], V.unpack(got[1])[0]) == S.permute(lv, rv)


def edge_planes(device) -> torch.Tensor:
    """The ladder's edge values (``skyscraper.edge_values``)."""
    return V.pack(S.edge_values(20261016), device)


def test_compress_kernel_edges_and_strides(cuda):
    e = edge_planes(cuda)
    k = e.shape[1]
    el, er = e.repeat_interleave(k, dim=1), e.repeat(1, k)
    assert torch.equal(S.compress_v(el, er), S.compress_plain(el, er))
    assert V.unpack(S.compress_v(el, er)) == [
        S.compress(x, y) for x, y in zip(V.unpack(el), V.unpack(er))]
    # PoW's broadcast challenge (column stride 0), the tree's column stride 2
    nonces = canonical(1 << 12, 21, cuda)
    assert torch.equal(S.compress_v(e[:, 3:4], nonces),
                       S.compress_plain(e[:, 3:4], nonces))
    x = canonical(1 << 12, 22, cuda)
    assert torch.equal(S.compress_v(x[:, 0::2], x[:, 1::2]),
                       S.compress_plain(x[:, 0::2], x[:, 1::2]))


@pytest.mark.parametrize("leaf_size", [1, 2, 3, 32])
def test_compress_fold_kernel(cuda, leaf_size):
    from provekit_tpu_torch.ops import merkle
    n = 1000
    leaves = canonical(leaf_size * n, 30 + leaf_size, cuda).reshape(
        16, leaf_size, n)
    e = edge_planes(cuda)
    leaves[:, 0, :e.shape[1]] = e
    before = S.compress_fold_v.launches
    got = S.compress_fold_v(leaves)
    assert S.compress_fold_v.launches == before + 1
    assert torch.equal(got, S.compress_fold_plain(leaves))
    assert torch.equal(merkle.hash_leaves(leaves), got)
    # a strided view: every other element of a wider leaf
    wide = torch.repeat_interleave(leaves, 2, dim=1)[:, 0::2, :]
    assert torch.equal(S.compress_fold_v(wide), got)


@pytest.mark.parametrize("k,start_pos,n", [(1, 0, 0), (1, 1, 0), (4, 0, 0),
                                           (8, 1, 0), (0, 0, 1), (0, 0, 3),
                                           (0, 0, 100), (3, 1, 2),
                                           (3, 0, 1), (4, 0, 1)])
def test_duplex_kernel(cuda, k, start_pos, n):
    e = edge_planes(cuda)
    arr = torch.cat([e, canonical(8, 40, cuda)], dim=1)[:, :k] if k else None
    for i in range(e.shape[1]):
        state = torch.cat([e[:, i:i + 1], e[:, -1 - i:e.shape[1] - i]], 1)
        before = (S.duplex_v.launches, S.duplex_v.permutations)
        got_state, got = S.duplex_v(state, arr, start_pos, n)
        want_state, want = S.duplex_plain(state, arr, start_pos, n)
        assert torch.equal(got_state, want_state)
        assert torch.equal(got, want)
        assert (S.duplex_v.launches, S.duplex_v.permutations) == (
            before[0] + 1,
            before[1] + S.duplex_permutations(k, start_pos, n))


def test_tiny_digest_on_card(cuda):
    from provekit_tpu_torch.protocol import WhirR1CSScheme
    from provekit_tpu_torch.r1cs import R1CS
    from provekit_tpu_torch.whir.parameters import WhirConfig
    rng = random.Random(3)
    r = R1CS()
    x0 = r.new_witness()
    vals = {0: 1, x0: rng.randrange(F.P)}
    sq = r.new_witness()
    r.add_constraint([(1, x0)], [(1, x0)], [(1, sq)])
    vals[sq] = vals[x0] * vals[x0] % F.P
    nxt = r.new_witness()
    r.add_constraint([(1, sq), (1, x0)], [(1, 0)], [(1, nxt)])
    vals[nxt] = (vals[sq] + vals[x0]) % F.P
    cfg = dict(batch_size=2, security_level=3, max_pow_bits=2,
               folding_factor=2)
    scheme = WhirR1CSScheme(
        m=3, m_0=1, a_num_terms=2,
        whir_witness=WhirConfig(num_variables=3, **cfg),
        whir_for_hiding_spartan=WhirConfig(num_variables=3, **cfg),
        security_level=3, max_pow_bits=2, device=cuda)
    proof = scheme.prove(r, [vals[i] for i in range(4)],
                         rng=random.Random(11))
    assert hashlib.sha256(proof).hexdigest() == (
        "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0")
    scheme.verify(r, proof)


def segment_planes(n: int, seed: int, edge: bool, device) -> torch.Tensor:
    """(16, n) Montgomery operands of a segment: random canonical values,
    or the edge values 0, 1 and P - 1 in a seeded order."""
    if not edge:
        return canonical(n, seed, device)
    rng = np.random.default_rng(seed)
    return V.pack([int(v) for v in rng.choice([0, 1, F.P - 1], size=n)],
                  device)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("n,count", [(8, 0), (8, 1), (8, 3), (1 << 10, 1),
                                     (1 << 10, 10), (1 << 14, 2),
                                     (1 << 17, 17), (1 << 20, 4)])
def test_whir_segment_kernel(cuda, n, count, edge):
    from provekit_tpu_torch.ops import fused
    # fw as a strided view (element stride 2), the state as a block's view
    fw = segment_planes(4 * n, 50 + count, edge, cuda).reshape(
        16, 2, 2 * n)[:, :, 0::2]
    block = segment_planes(5, 60 + count, edge, cuda)
    state = block[:, 1:3]
    before = (fused.whir_sumcheck_segment.launches,
              fused.whir_sumcheck_segment.permutations)
    got = fused.whir_sumcheck_segment(fw, state, count)
    assert (fused.whir_sumcheck_segment.launches,
            fused.whir_sumcheck_segment.permutations) == (
        before[0] + 1, before[1] + 3 * count)
    for want in (fused.whir_sumcheck_segment_plain(fw, state, count),
                 fused.whir_rounds(fw, state, count)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("m,lead", [(0, 0), (1, 0), (3, 1), (10, 0),
                                    (14, 12), (17, 0), (18, 3)])
def test_spartan_segment_kernel(cuda, m, lead, edge):
    from provekit_tpu_torch.ops import fused
    n = 1 << m
    seed = 70 + m + lead
    abce = segment_planes(4 * n, seed, edge, cuda).reshape(16, 4, n)
    cols = segment_planes(5 + 7 * m, seed + 1, edge, cuda)
    state, claim, rho, prefix = (cols[:, :2], cols[:, 2:3], cols[:, 3:4],
                                 cols[:, 4:5])
    pms, sms, sfx = (cols[:, 5 + k * m:5 + (k + 1) * m] for k in range(3))
    g = cols[:, 5 + 3 * m:].reshape(16, m, 4)
    abce, state, _, _, claim, prefix = fused.spartan_rounds(
        abce, state, claim, prefix, rho, g, pms, sms, sfx, lead)
    args = (abce, state, claim, rho, g[:, lead:], pms[:, lead:],
            sms[:, lead:], sfx[:, lead:], prefix, m - lead)
    before = fused.spartan_sumcheck_fused.launches
    got = fused.spartan_sumcheck_fused(*args)
    assert fused.spartan_sumcheck_fused.launches == before + 1
    want = fused.spartan_sumcheck_fused_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("fuse_max", [0, 4, 1 << 14, 1 << 32])
def test_tiny_digest_on_card_at_every_split(cuda, monkeypatch, fuse_max):
    from provekit_tpu_torch.ops import fused
    monkeypatch.setattr(fused, "FUSE_MAX", fuse_max)
    before = (fused.whir_sumcheck_segment.launches,
              fused.spartan_sumcheck_fused.launches)
    test_tiny_digest_on_card(cuda)
    launched = (fused.whir_sumcheck_segment.launches > before[0],
                fused.spartan_sumcheck_fused.launches > before[1])
    assert launched == ((False, False) if fuse_max == 0 else (True, True))
