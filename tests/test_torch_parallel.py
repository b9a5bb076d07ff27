"""The port's sharded prover (provekit_tpu_torch.parallel) on gloo ranks on
the CPU, exactly against the JAX package.

Two worlds, of eight ranks and of four (``tests/_torch_parallel_world.py``),
run the six sharded functions on 8 ranks and on 4 (the shapes of
``tests/test_sharding.py``, n = 64, and each at n = 2^12 against its
single-device counterpart in the rank) and ``commit_dev`` under a mesh
with 1, 2 and many leaves a rank, and the four ranks prove the tiny
system (the pinned digest of ``tests/test_device_fs.py``), once per pytest
run: both worlds run at once, and the suite's workers share their results
through a file under pytest's base temporary directory, whichever worker
asks first.  Each of those tests then compares with the JAX package
(``provekit_tpu.parallel``'s sharded functions on a mesh of the conftest's
CPU devices).  The two larger proves on four ranks each launch their own
ranks, so that the workers that run them do not wait on one another: the
24-step system with the inputs of ``tests/_sharded_prove_child.py``, and a
system whose sumchecks hold 2^10 or more elements a rank, each against the
port's single-device proof.
"""

import hashlib
import os
import pickle
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from filelock import FileLock

import chip_smoke as C
from provekit_tpu import parallel as pp
from provekit_tpu.ops import ntt as JN
from provekit_tpu_torch.parallel import collectives as PC
from provekit_tpu_torch.parallel import dryrun as D
from provekit_tpu_torch.parallel import launch, make_mesh
from provekit_tpu_torch.parallel import context as pctx
from provekit_tpu_torch.protocol import examples
from tests import _torch_parallel_world as W

torch.set_num_threads(1)

PINNED = "efa6851f51a1090ab1139f427a9a67daa4b2c16037937f0e853bb8db0c5cbfb0"
FUNCTIONS = ["spartan_round_sharded", "fold_msb_sharded",
             "whir_round_sharded", "fold_lsb_sharded", "ntt_sharded",
             "merkle_root_sharded"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The step worlds' results (``_torch_parallel_world.step_rank`` on
    eight ranks and on four, both worlds at once), computed by the first
    worker that asks and read back by the others (pytest-xdist's recipe for
    a fixture that runs once)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_parallel_world.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return pickle.loads(path.read_bytes())
        out, errors = {}, []

        def run(s):
            try:
                out[s] = launch(W.step_rank, s, "gloo", device="cpu",
                                timeout=600)
            except BaseException as e:  # re-raised below, in this thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(s,)) for s in (8, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        path.write_bytes(pickle.dumps(out))
        return out


def _prove_on_four(case: tuple) -> tuple:
    """``dryrun.prove_example`` of ``case`` (seed, n_mults, security,
    folding, max_pow, rng seed) on four gloo ranks, and the port's
    single-device proof of it, made here meanwhile."""
    ranks = {}

    def spawn():
        try:
            ranks["out"] = launch(D.prove_example, 4, "gloo", device="cpu",
                                  args=(*case, False), timeout=600)
        except BaseException as e:  # re-raised below, in the test's thread
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    seed, n, sec, fold, pow_, rng_seed = case
    r1cs, witness = examples.build_system(seed, n)
    scheme = examples.tiny_scheme(r1cs, "cpu", sec, fold, pow_)
    single = scheme.prove(r1cs, witness, rng=random.Random(rng_seed))
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return [r["mesh"] for r in ranks["out"]], single


@pytest.fixture(autouse=True)
def _fresh_jax_tables():
    """The JAX package caches its NTT twiddle tables per process, and its
    ``ntt_sharded`` fills those caches from inside ``shard_map`` traces:
    empty them around each test, so that no later JAX test in this worker
    is handed a traced array."""
    tables = (JN._twiddle_table, JN._power_table_full, JN._cross_twiddles)
    for cached in tables:
        cached.cache_clear()
    yield
    for cached in tables:
        cached.cache_clear()


def _ranks(world, key: str, size: int) -> list:
    got = [r[key] for r in world[size]]
    assert len(got) == size
    return got


# -- the six sharded functions against the JAX package ----------------------


def _jax_sharded(name: str, s: int):
    """The JAX package's sharded function on the same inputs, and its
    output as (16, ...) numpy planes."""
    x = D.step_inputs(W.SEED, D.step_shapes(s))
    n = D.step_shapes(s)["spartan"]
    mesh = pp.make_mesh(s)
    u32 = {k: jnp.asarray(v.astype(np.uint32)) for k, v in x.items()}
    abce, fw, alpha = u32["abce"], u32["fw"], u32["alpha"].reshape(16)

    def cyclic(v):
        return v.reshape(16, n // s, s).transpose(0, 2, 1)

    def contig(v):
        return v.reshape(16, s, v.shape[1] // s)

    if name == "spartan_round_sharded":
        out = jnp.stack(pp.spartan_round_sharded(
            mesh, *[cyclic(abce[:, k]) for k in range(4)]), axis=1)
    elif name == "fold_msb_sharded":
        out = pp.fold_msb_sharded(mesh, cyclic(abce[:, 0]), alpha)
    elif name == "whir_round_sharded":
        out = jnp.stack(pp.whir_round_sharded(
            mesh, contig(fw[:, 0]), contig(fw[:, 1])), axis=1)
    elif name == "fold_lsb_sharded":
        out = pp.fold_lsb_sharded(mesh, contig(fw[:, 0]), alpha)
    elif name == "ntt_sharded":
        log_n = D.step_shapes(s)["ntt_log"]
        out = pp.ntt_sharded(mesh, contig(u32["coeffs"]), log_n)
    else:
        leaves = u32["leaves"]
        out = pp.merkle_root_sharded(mesh, leaves.reshape(
            16, leaves.shape[1], s, leaves.shape[2] // s))
    return np.asarray(out).astype(np.int64)


def _port_sharded(world, name: str, s: int) -> np.ndarray:
    """The ranks' outputs in the JAX function's layout: round sums and
    roots (the same on every rank) once, sharded outputs stacked on a
    shard axis (16, S, ...)."""
    locals_ = [r["functions"][name]["local"].astype(np.int64)
               for r in _ranks(world, f"s{s}", s)]
    if name in ("spartan_round_sharded", "whir_round_sharded",
                "merkle_root_sharded"):
        assert all(np.array_equal(x, locals_[0]) for x in locals_)
        return locals_[0]
    return np.stack(locals_, axis=1)


@pytest.mark.parametrize("s", [4, 8])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_sharded_function_equals_the_jax_package(world, name, s):
    want = _jax_sharded(name, s)
    got = _port_sharded(world, name, s)
    assert got.shape == want.shape
    assert int(np.abs(got - want).max()) == 0
    for r in _ranks(world, f"s{s}", s):   # and the single device's, in-rank
        assert r["functions"][name]["max_abs_err"] == 0


@pytest.mark.parametrize("name", FUNCTIONS)
def test_sharded_function_at_4096_equals_the_single_device(world, name):
    for r in _ranks(world, "s4_wide", 4):
        assert r["functions"][name]["max_abs_err"] == 0


@pytest.mark.parametrize("s", [4, 8])
def test_collectives_count_their_calls_and_bytes(world, s):
    """What the collectives counted in the sharded step is the smoke run's
    model of them (on CPU tensors: no host copies)."""
    want = C.step_collectives(D.step_shapes(s), s, host_copies=False)
    for r in _ranks(world, f"s{s}", s):
        assert r["collectives"] == want


# -- commit_dev under a mesh --------------------------------------------------


@pytest.mark.parametrize("s", [4, 8])
def test_make_mesh_takes_the_whole_group(world, s):
    for r in world[s]:
        assert r["half_mesh_error"] == (f"make_mesh({s // 2}) in a group of "
                                        f"{s} ranks")


@pytest.mark.parametrize("key,case,sharded", [
    ("commit4", 0, 0), ("commit4", 1, 1), ("commit4", 2, 7),
    ("commit8", 0, 6)], ids=["4x1", "4x2", "4x128", "8x64"])
def test_commit_dev_under_a_mesh(world, key, case, sharded):
    """Root, whole levels and auth paths equal the single-device tree's
    with 1, 2 and many leaves a rank (1 a rank stays replicated)."""
    s = int(key[-1])
    for cases in _ranks(world, key, s):
        got = cases[case]
        assert got["sharded_levels"] == sharded
        assert got["root_equal"] and got["whole_levels_equal"]
        assert got["paths_max_abs_err"] == 0


# -- prove(mesh=...) ----------------------------------------------------------


def test_prove_under_make_mesh_1_gives_the_pinned_digest():
    r1cs, witness = examples.build_system(3, 1)
    scheme = examples.tiny_scheme(r1cs, "cpu")
    mesh = make_mesh(1, device="cpu")
    assert mesh.group is None and mesh.size == 1
    proof = scheme.prove(r1cs, witness, rng=random.Random(11), mesh=mesh)
    assert hashlib.sha256(proof).hexdigest() == PINNED
    assert mesh.counts == {}          # one rank in-process: no collective
    assert pctx.active_mesh() is None


def _scheme(case: tuple):
    seed, n, sec, fold, pow_, _ = case
    r1cs, _ = examples.build_system(seed, n)
    return examples.tiny_scheme(r1cs, "cpu", sec, fold, pow_)


def test_four_ranks_prove_the_pinned_digest(world):
    """Every rank's proof has the pinned digest; every rank counted the
    collectives that the smoke run's model gives for the scheme's shape,
    and launched no sumcheck segment."""
    ranks = _ranks(world, "tiny_prove", 4)
    for r in ranks:
        assert r["sha256"] == PINNED
    assert C.mesh_prove_faults(ranks, _scheme(W.TINY), 4) == []


def test_four_ranks_prove_the_single_device_bytes():
    """build_system(seed=5, n_mults=24) at security 10, folding 2, max_pow
    2 under Random(3), as tests/_sharded_prove_child.py proves it: every
    rank's bytes are the single-device proof's, and they verify (in the
    ranks, and here)."""
    ranks, base = _prove_on_four(W.MULTS24)
    assert all(r["proof"] == base for r in ranks)
    assert C.mesh_prove_faults(ranks, _scheme(W.MULTS24), 4) == []
    r1cs, _ = examples.build_system(5, 24)
    examples.tiny_scheme(r1cs, "cpu", 10, 2, 2).verify(r1cs, base)


def test_four_ranks_prove_a_large_system():
    """2^12 Spartan and 2^13 WHIR elements (2^10 and 2^11 a rank), 2^12
    witness leaves (subtrees of 10 levels): the single-device bytes."""
    r1cs, _ = examples.build_system(5, W.LARGE_MULTS)
    scheme = examples.tiny_scheme(r1cs, "cpu", 10, 2, 2)
    cfg = scheme.whir_witness
    leaves = (1 << cfg.starting_log_domain) >> cfg.initial_folding_factor
    assert (1 << scheme.m_0) // 4 >= 1 << 10
    assert (1 << scheme.m) // 4 >= 1 << 10
    assert leaves // 4 >= 4
    ranks, base = _prove_on_four(W.LARGE)
    for r in ranks:
        assert r["proof"] == base
    assert C.mesh_prove_faults(ranks, scheme, 4) == []


# -- the launcher and the mesh --------------------------------------------


def test_collectives_are_the_identity_on_one_rank():
    mesh = make_mesh(1, device="cpu")
    x = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3)
    assert PC.psum_mod(x, mesh) is x
    assert torch.equal(PC.all_gather(x, mesh)[0], x)
    y = x[:1]
    assert PC.all_to_all(y, mesh) is y
    assert mesh.counts == {}


def test_launch_refuses_what_the_backend_cannot_do():
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        launch(W.failing_rank, 2, "nccl", device="cpu")
    with pytest.raises(ValueError, match="refuses two ranks"):
        launch(W.failing_rank, 2, "nccl", device="cuda", share_device=True)
    with pytest.raises(ValueError, match="visible cards"):
        launch(W.failing_rank, torch.cuda.device_count() + 1, "gloo",
               device="cuda")
    with pytest.raises(ValueError, match="gloo or nccl"):
        launch(W.failing_rank, 2, "mpi", device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(4)


def test_launch_raises_a_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(W.failing_rank, 2, "gloo", device="cpu", timeout=300)
