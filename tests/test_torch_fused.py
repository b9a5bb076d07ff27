"""The fused sumcheck segments of the torch port (``ops/fused.py``) against
the JAX package's per-round functions, exactly.

The reference is the JAX package's round sums, messages and folds run one
round at a time with its host transcript's sponge, as
``tests/test_fused.py`` runs them: the JAX package's own unrolled segments
take minutes to compile on the CPU.  The segment kernels' arithmetic
(``csrc/sumcheck_round.cuh``) is built for the host with ``g++``
(``tests/segment_host.cpp``) and held to the plain versions, in the
kernels' own schedule over a grid of blocks, whose ownership map is checked
to cover every pair and element exactly once; the kernels themselves run
only on the card (``tests/test_torch_cuda.py``).  Every compared value is a
field element, so every comparison is exact.
"""

import ctypes
import hashlib
import random
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu.fields import bn254 as JB
from provekit_tpu.fields import vector as JV
from provekit_tpu.fs import DomainSeparator as JDomainSeparator
from provekit_tpu.ops import fused as JF
from provekit_tpu.ops import sumcheck as JS
from provekit_tpu_torch import convert
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V
from provekit_tpu_torch.ops import fused
from provekit_tpu_torch.ops import sumcheck as sc
from tests.test_e2e import build_system
from tests.test_verifier_circuit import tiny_scheme

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "provekit_tpu_torch" / "csrc"
PINNED = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"
CPU = torch.device("cpu")


def mont_values(rng: np.random.Generator, k: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(k)]


def planes(vals: list[int], *shape) -> np.ndarray:
    """Ints -> numpy uint32 (16, *shape) planes (the JAX package's)."""
    return convert.planes_to_numpy(V.pack(vals, CPU)).reshape(16, *shape)


def T(arr: np.ndarray) -> torch.Tensor:
    return convert.planes_to_torch(arr, CPU)


def ints(x) -> list[int]:
    x = x if isinstance(x, torch.Tensor) else T(np.asarray(x))
    return V.unpack(x) if x.numel() else []


def sponge_start(pattern: list) -> tuple:
    """A JAX host transcript whose pattern is ``pattern`` rounds of
    (absorb k, squeeze 1), and its sponge state as (16, 2) planes."""
    ds = JDomainSeparator("fused-segment-test")
    for k in pattern:
        ds.absorb(k, "c").squeeze(1, "a")
    tr = ds.to_prover_state()
    return tr, np.asarray(tr.sponge_state_array())


def jax_whir_rounds(fw: np.ndarray, count: int):
    """The JAX package's WHIR rounds one at a time (tests/test_fused.py):
    messages, challenges, the final sponge state and the folded array."""
    tr, state = sponge_start([3] * count)
    cur, msgs, alphas = jnp.asarray(fw), [], []
    for _ in range(count):
        h = JF.whir_round_messages(*JS.whir_round_stacked(cur))
        cs = [JB.from_mont(JV.unpack_scalar(x)) for x in h]
        tr.add_scalars(cs)
        alpha = tr.challenge_scalars(1)[0]
        msgs += cs
        alphas.append(alpha)
        cur = JS.fold_stacked_lsb(cur, JV.pack_scalar(JB.to_mont(alpha)))
    return (state, msgs, alphas, ints(tr.sponge_state_array()),
            ints(np.asarray(cur).reshape(16, -1)))


def spartan_inputs(m: int, seed: int) -> dict:
    """Seeded Montgomery planes of one Spartan segment of m rounds: abce
    (16, 4, 2^m), claim, rho and a nonzero prefix (16, 1), the blinding
    cubics (16, m, 4) and pms, sms, suffix (16, m)."""
    rng = np.random.default_rng(seed)
    n = 1 << m
    return {"abce": planes(mont_values(rng, 4 * n), 4, n),
            "claim": planes(mont_values(rng, 1), 1),
            "rho": planes(mont_values(rng, 1), 1),
            "prefix": planes(mont_values(rng, 1), 1),
            "g": planes(mont_values(rng, 4 * m), m, 4),
            "pms": planes(mont_values(rng, m), m),
            "sms": planes(mont_values(rng, m), m),
            "suffix": planes(mont_values(rng, m), m)}


def spartan_scal(state: np.ndarray, x: dict, m: int) -> np.ndarray:
    """The (16, 5 + 7 m) scalar block pk_spartan_segment takes."""
    return np.ascontiguousarray(np.concatenate(
        [state, x["claim"], x["rho"], x["prefix"], x["pms"], x["sms"],
         x["suffix"], x["g"].reshape(16, 4 * m)], axis=1))


def jax_spartan_rounds(x: dict, m: int):
    """The JAX package's ZK-Spartan rounds one at a time, as
    provekit_tpu/protocol/spartan.py:_spartan_rounds_unfused runs them, with
    the host transcript's sponge: coefficients, challenges, final state."""
    tr, state = sponge_start([4] * m)
    half_c = JV.pack([JB.to_mont(JB.HALF)])
    abce, claim, prefix = (jnp.asarray(x[k]) for k in ("abce", "claim",
                                                      "prefix"))
    rho, g = jnp.asarray(x["rho"]), jnp.asarray(x["g"])
    coeffs, alphas = [], []
    for i in range(m):
        f0, fm1, finf = (s.reshape(16, 1)
                         for s in JS.spartan_round_stacked(abce))
        gi = [g[:, i, k].reshape(16, 1) for k in range(4)]
        col = [jnp.asarray(x[k][:, i:i + 1]) for k in ("pms", "sms",
                                                        "suffix")]
        cs = JF.spartan_round_coeffs(f0, fm1, finf, claim, prefix, gi, *col,
                                     rho, half_c)
        cv = [JB.from_mont(JV.unpack_scalar(c)) for c in cs]
        tr.add_scalars(cv)
        alpha = tr.challenge_scalars(1)[0]
        coeffs += cv
        alphas.append(alpha)
        am = JV.pack([JB.to_mont(alpha)])
        claim = JF._eval_poly_mont(cs, am)
        prefix = JV.add_mod(prefix, JF._eval_poly_mont(gi, am))
        abce = JS.fold_stacked_msb(abce, am[:, 0])
    return state, coeffs, alphas, ints(tr.sponge_state_array())


@pytest.mark.parametrize("n,count", [(8, 0), (8, 1), (8, 3), (64, 2),
                                     (64, 6), (1 << 10, 10)])
def test_whir_segment_matches_jax(n, count):
    rng = np.random.default_rng(100 + n + count)
    fw = planes(mont_values(rng, 2 * n), 2, n)
    state, msgs, alphas, state2, folded = jax_whir_rounds(fw, count)
    got_fw, got_state, got_msgs, got_alphas = fused.whir_sumcheck_segment(
        T(fw), T(state), count)
    assert tuple(got_msgs.shape) == (16, count, 3)
    assert ints(got_msgs) == msgs
    assert ints(got_alphas) == alphas
    assert ints(got_state) == state2
    assert tuple(got_fw.shape) == (16, 2, n >> count)
    assert ints(got_fw) == folded
    # the per-round path the prover's leading rounds take, the same values
    per_round = fused.whir_rounds(T(fw), T(state), count)
    assert all(torch.equal(a, b) for a, b in zip(per_round, (
        got_fw, got_state, got_msgs, got_alphas)))


@pytest.mark.parametrize("m,lead", [(3, 0), (3, 1), (5, 2), (10, 0)])
def test_spartan_segment_matches_jax(m, lead):
    """``lead`` rounds one at a time, then the rest as one segment that
    takes the claim and the (nonzero) blinding prefix they leave; (10, 0)
    is a whole sumcheck in one segment."""
    x = spartan_inputs(m, seed=200 + m + lead)
    state, coeffs, alphas, state2 = jax_spartan_rounds(x, m)
    t = {k: T(v) for k, v in x.items()}
    abce, st, cs, a, claim, prefix = fused.spartan_rounds(
        t["abce"], T(state), t["claim"], t["prefix"], t["rho"], t["g"],
        t["pms"], t["sms"], t["suffix"], lead)
    st, cs2, a2 = fused.spartan_sumcheck_fused(
        abce, st, claim, t["rho"], t["g"][:, lead:], t["pms"][:, lead:],
        t["sms"][:, lead:], t["suffix"][:, lead:], prefix, m - lead)
    assert tuple(cs2.shape) == (16, m - lead, 4)
    assert ints(cs) + ints(cs2) == coeffs
    assert ints(a) + ints(a2) == alphas
    assert ints(st) == state2


@pytest.fixture(scope="module")
def host_segments(tmp_path_factory):
    """csrc/sumcheck_round.cuh (with field.cuh and skyscraper_sponge.cuh)
    built for the host: tests/segment_host.cpp."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("seg_host") / "libseg_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(out),
                    str(Path(__file__).with_name("segment_host.cpp"))],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.seg_lost.restype = ctypes.c_uint64
    for name in ("seg_grid_blocks", "seg_check_schedule",
                 "seg_check_schedules"):
        getattr(lib, name).restype = ctypes.c_int64
    return lib


# resident blocks of the emulated grid: one block, a few, and more than the
# card holds of either kernel (132 SMs, one block each)
RESIDENT = 264


def ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def edge_or_random(rng, k: int, edge: bool) -> list[int]:
    if edge:
        return [int(v) for v in rng.choice([0, 1, F.P - 1], size=k)]
    return mont_values(rng, k)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("n,count", [(2, 1), (16, 4), (64, 3)])
def test_host_whir_segment_matches_plain(host_segments, n, count, edge):
    rng = np.random.default_rng(300 + n + count + edge)
    fw = planes(edge_or_random(rng, 2 * n, edge), 2, n)
    state = planes(edge_or_random(rng, 2, edge), 2)
    folded = np.zeros((16, 2, n >> count), dtype=np.uint32)
    out = np.zeros((16, 2 + 4 * count), dtype=np.uint32)
    host_segments.seg_whir(ptr(fw), ctypes.c_int64(n), count, ptr(state),
                           ptr(folded), ptr(out), ctypes.c_int64(RESIDENT))
    got_fw, st, msgs, alphas = fused.whir_sumcheck_segment_plain(
        T(fw), T(state), count)
    want = torch.cat([st, msgs.reshape(16, 3 * count), alphas], dim=1)
    assert torch.equal(T(out), want)
    assert torch.equal(T(folded), got_fw)
    assert host_segments.seg_lost() == 0


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("m", [1, 4])
def test_host_spartan_segment_matches_plain(host_segments, m, edge):
    rng = np.random.default_rng(400 + m + edge)
    x = spartan_inputs(m, seed=500 + m)
    if edge:
        x = {k: planes(edge_or_random(rng, v[0].size, True), *v.shape[1:])
             for k, v in x.items()}
    state = planes(edge_or_random(rng, 2, edge), 2)
    out = np.zeros((16, 2 + 5 * m), dtype=np.uint32)
    host_segments.seg_spartan(ptr(np.ascontiguousarray(x["abce"])),
                              ctypes.c_int64(1 << m), m,
                              ptr(spartan_scal(state, x, m)), ptr(out),
                              ctypes.c_int64(RESIDENT))
    t = {k: T(v) for k, v in x.items()}
    st, cs, alphas = fused.spartan_sumcheck_fused_plain(
        t["abce"], T(state), t["claim"], t["rho"], t["g"], t["pms"],
        t["sms"], t["suffix"], t["prefix"], m)
    assert torch.equal(T(out), torch.cat([st, cs.reshape(16, 4 * m), alphas],
                                         dim=1))
    assert host_segments.seg_lost() == 0


@pytest.mark.parametrize("resident", [1, 3, RESIDENT])
def test_host_segments_on_the_grid_match_plain(host_segments, resident):
    """Both segments at n = 2^12, every round, run as the kernels run them
    over a grid of 1, 3 and 8 blocks (2^11 pairs in round 0, 256 a block):
    the per-block sums, the ping-pong and in-place folds, the step from
    the grid's sums, then block 0 alone once a pass fits one block."""
    m = 12
    n = 1 << m
    assert host_segments.seg_grid_blocks(ctypes.c_int64(n),
                                         ctypes.c_int64(resident)) == \
        min(resident, n // 2 // host_segments.seg_threads())
    rng = np.random.default_rng(600 + resident)
    fw = planes(mont_values(rng, 2 * n), 2, n)
    state = planes(mont_values(rng, 2), 2)
    folded = np.zeros((16, 2, 1), dtype=np.uint32)
    out = np.zeros((16, 2 + 4 * m), dtype=np.uint32)
    host_segments.seg_whir(ptr(fw), ctypes.c_int64(n), m, ptr(state),
                           ptr(folded), ptr(out), ctypes.c_int64(resident))
    got_fw, st, msgs, alphas = fused.whir_sumcheck_segment_plain(
        T(fw), T(state), m)
    assert torch.equal(T(out), torch.cat(
        [st, msgs.reshape(16, 3 * m), alphas], dim=1))
    assert torch.equal(T(folded), got_fw)
    x = spartan_inputs(m, seed=700 + resident)
    out = np.zeros((16, 2 + 5 * m), dtype=np.uint32)
    host_segments.seg_spartan(ptr(np.ascontiguousarray(x["abce"])),
                              ctypes.c_int64(n), m,
                              ptr(spartan_scal(state, x, m)), ptr(out),
                              ctypes.c_int64(resident))
    t = {k: T(v) for k, v in x.items()}
    st, cs, alphas = fused.spartan_sumcheck_fused_plain(
        t["abce"], T(state), t["claim"], t["rho"], t["g"], t["pms"],
        t["sms"], t["suffix"], t["prefix"], m)
    assert torch.equal(T(out), torch.cat([st, cs.reshape(16, 4 * m), alphas],
                                         dim=1))
    assert host_segments.seg_lost() == 0


def test_host_field_ops_on_carry_chains(host_segments):
    """The segments' add, sub and Montgomery product (carry chains) equal
    the field's on random values and on every pair of 0, 1, 2, P - 2,
    P - 1 and values near 2^253 and 2^254 below P, with no dropped carry."""
    rng = np.random.default_rng(900)
    edges = [0, 1, 2, F.P - 2, F.P - 1, (1 << 253) - 1, 1 << 253,
             F.P - (1 << 200)]
    xs = [a for a in edges for _ in edges] + mont_values(rng, 256)
    ys = [b for _ in edges for b in edges] + mont_values(rng, 256)
    n = len(xs)
    a, b = planes(xs, n), planes(ys, n)
    rinv = pow(1 << 256, -1, F.P)
    for op, want in ((0, [(x + y) % F.P for x, y in zip(xs, ys)]),
                     (1, [(x - y) % F.P for x, y in zip(xs, ys)]),
                     (2, [x * y * rinv % F.P for x, y in zip(xs, ys)])):
        out = np.zeros((16, n), dtype=np.uint32)
        host_segments.seg_field(op, ptr(a), ptr(b), ptr(out),
                                ctypes.c_int64(n))
        assert ints(out) == want, op
    assert host_segments.seg_lost() == 0


@pytest.mark.parametrize("edge", [False, True])
def test_host_fold_next_equals_fold_then_sums(host_segments, edge):
    """The fused step (seg::whir_fold_next, seg::spartan_fold_next): the
    fold of round j at alpha, then round j + 1's pair sums, equal the plain
    fold and then the plain round sums, one after the other."""
    rng = np.random.default_rng(800 + edge)
    units = 64
    alpha = planes(edge_or_random(rng, 1, edge), 1)
    am = T(alpha).reshape(16)
    x = planes(edge_or_random(rng, 2 * 4 * units, edge), 2, 4 * units)
    y = np.zeros((16, 2, 2 * units), dtype=np.uint32)
    acc = np.zeros((16, 3), dtype=np.uint32)
    host_segments.seg_whir_fold_next(ptr(x), ctypes.c_int64(units),
                                     ptr(alpha), ptr(y), ptr(acc))
    want_y = sc.fold_stacked_lsb(T(x), am)
    assert torch.equal(T(y), want_y)
    _, _, *h = sc.whir_round_split_dev(want_y)
    assert torch.equal(T(acc), torch.stack(h, dim=1))
    length = 4 * units
    x = planes(edge_or_random(rng, 4 * length, edge), 4, length)
    y = np.zeros((16, 4, length // 2), dtype=np.uint32)
    host_segments.seg_spartan_fold_next(ptr(x), ctypes.c_int64(length),
                                        ptr(alpha), ptr(y), ptr(acc))
    want_y = sc.fold_stacked_msb(T(x), am)
    assert torch.equal(T(y), want_y)
    assert torch.equal(T(acc), torch.stack(
        sc.spartan_round_stacked(want_y), dim=1))
    assert host_segments.seg_lost() == 0


def test_host_schedule_covers_every_pair_once(host_segments):
    """The grid's ownership map (csrc/sumcheck_round.cuh): for both kinds,
    n = 1 .. 2^12, every round count and every grid of at most 1 .. 264
    resident blocks, each pass takes every pair of its round once, reads
    each element of its array once and writes each folded element once;
    Spartan's in-place fold never writes what another unit reads, WHIR's
    never the array it reads; once off the grid only block 0 takes items.
    Then at n = 2^18, where 264 blocks fill the grid."""
    cases = ctypes.c_int64()
    assert host_segments.seg_check_schedules(
        12, ctypes.c_int64(RESIDENT), ctypes.byref(cases)) == 0
    assert cases.value > 2 * 13 * 7
    n = ctypes.c_int64(1 << 18)
    assert host_segments.seg_grid_blocks(n, ctypes.c_int64(RESIDENT)) == \
        RESIDENT
    for kind in (0, 1):
        for count in (1, 2, 9, 18):
            assert host_segments.seg_check_schedule(
                kind, n, count, ctypes.c_int64(RESIDENT)) == 0


def test_segment_wrappers_raise_off_the_cpu():
    """Off the CPU a segment wrapper launches its kernel or raises: a
    tensor on no CUDA device raises, and nothing is counted."""
    fw = torch.zeros((16, 2, 8), dtype=torch.int32, device="meta")
    state = torch.zeros((16, 2), dtype=torch.int32, device="meta")
    before = fused.whir_sumcheck_segment.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused.whir_sumcheck_segment(fw, state, 1)
    abce = torch.zeros((16, 4, 8), dtype=torch.int32, device="meta")
    col = torch.zeros((16, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused.spartan_sumcheck_fused(abce, state, col, col, col, col, col,
                                     col, col, 3)
    assert fused.whir_sumcheck_segment.launches == before


@pytest.fixture(scope="module")
def tiny():
    jr1cs, witness = build_system(seed=3, n_mults=1)
    jscheme = tiny_scheme(jr1cs, security=3, folding=2, max_pow=2)
    r1cs = convert.r1cs_from_coo(convert.r1cs_to_coo(jr1cs))
    scheme = convert.scheme_from_fields(convert.scheme_fields(jscheme), CPU)
    return scheme, r1cs, witness


@pytest.mark.parametrize("fuse_max", [0, 4, 1 << 14, fused.FUSE_MAX])
def test_tiny_proof_at_every_split(tiny, monkeypatch, fuse_max):
    """The hybrid split moves no byte: every round one at a time
    (FUSE_MAX 0), leading rounds and short segments (4), all segments (the
    earlier default 2^14 and the default) prove to the JAX package's pinned
    digest
    (tests/test_device_fs.py::test_proof_bytes_regression_hybrid)."""
    scheme, r1cs, witness = tiny
    monkeypatch.setattr(fused, "FUSE_MAX", fuse_max)
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    assert hashlib.sha256(proof).hexdigest() == PINNED
