"""Dry run of the sharded prover on S ranks: the counterpart of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``).

    python -m provekit_tpu_torch.parallel.dryrun --world 4 --backend gloo \\
        --device cuda --share-device

Each rank runs the sharded prover step at tiny shapes (the six functions of
:mod:`.mesh`, each held exactly to its single-device counterpart on the
rank's device), then proves ``build_system(seed=5, n_mults=24)`` at
security 10, folding 2, ``max_pow`` 2 under ``Random(3)`` once on its own
and once on the mesh; the two proofs must be equal and verify.  It prints
each rank's result and a table of the collectives' calls and bytes by
stage, as the collectives counted them.  Exits 1 on any difference.

The rank functions here (:func:`check_sharded`, :func:`check_commit`,
:func:`prove_example`, :func:`prove_blob`) are also what the smoke run and
the CPU tests launch: a spawned rank imports its function by name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pickle
import random
import sys
import time

import numpy as np
import torch

from ..ops import merkle
from ..ops import ntt as ntt_mod
from ..ops import sumcheck as sc
from ..protocol import examples
from ..utils import profiling
from ..utils.counts import kernel_counters, read_counts, reset_counts
from . import context as pctx
from . import mesh as M
from .launch import launch


def step_shapes(world: int) -> dict:
    """The JAX dry run's shapes on ``world`` ranks: n = 2^max(6, log2(2S))
    elements for the rounds and the NTT, leaves of 4 elements."""
    log_n = max(6, (2 * world - 1).bit_length())
    n = 1 << log_n
    return {"spartan": n, "whir": n, "ntt_log": log_n, "leaf": (4, n)}


def random_planes(rng: np.random.Generator, n: int) -> np.ndarray:
    """(16, n) int32 digit planes of canonical field elements."""
    digits = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    digits[15] = rng.integers(0, 0x3064, size=n)  # top digit < P's
    return digits.astype(np.int32)


def step_inputs(seed: int, shapes: dict) -> dict:
    """Seeded inputs of :func:`check_sharded`, the same on every rank."""
    rng = np.random.default_rng(seed)
    n_s, n_w = shapes["spartan"], shapes["whir"]
    size, n_leaves = shapes["leaf"]
    return {"abce": random_planes(rng, 4 * n_s).reshape(16, 4, n_s),
            "fw": random_planes(rng, 2 * n_w).reshape(16, 2, n_w),
            "alpha": random_planes(rng, 1),
            "coeffs": random_planes(rng, 1 << shapes["ntt_log"]),
            "leaves": random_planes(rng, size * n_leaves).reshape(
                16, size, n_leaves)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def comm_rows(mesh) -> list:
    """The mesh's collective counts: [stage, collective, calls, bytes, host
    bytes] rows, sorted."""
    if mesh is None:
        return []
    return sorted([stage, op, *row] for (stage, op), row in
                  mesh.counts.items())


def comm_table(rows: list) -> str:
    lines = [f"{'stage':<24} {'collective':<11} {'calls':>6} "
             f"{'bytes':>12} {'host bytes':>12}"]
    for stage, op, calls, nbytes, host in rows:
        lines.append(f"{stage:<24} {op:<11} {calls:>6} {nbytes:>12} "
                     f"{host:>12}")
    return "\n".join(lines)


def check_sharded(mesh, seed: int, shapes: dict, keep: bool = False) -> dict:
    """Rank function: the six sharded functions on this rank's shards of
    :func:`step_inputs`, each against its single-device counterpart on the
    whole inputs (this rank's part of its result), after one warm-up call
    of each.  Returns, by function, the max abs error, the sharded call's
    wall ms (synchronized) and, with ``keep``, the rank's local output; and
    the collective counts of the timed calls."""
    dev = mesh.device
    x = {k: torch.from_numpy(v).to(dev)
         for k, v in step_inputs(seed, shapes).items()}
    abce, fw, alpha = x["abce"], x["fw"], x["alpha"]
    coeffs, leaves = x["coeffs"], x["leaves"]
    cyc = [pctx.cyclic(abce[:, k], mesh) for k in range(4)]
    f, w = (pctx.block(fw[:, k], mesh) for k in range(2))
    s, me = mesh.size, mesh.rank
    cases = {
        "spartan_round_sharded": (
            lambda: torch.stack(M.spartan_round_sharded(mesh, *cyc), dim=1),
            lambda: torch.stack(sc.spartan_round_stacked(abce), dim=1)),
        "fold_msb_sharded": (
            lambda: M.fold_msb_sharded(mesh, cyc[0], alpha),
            lambda: pctx.cyclic(sc.fold_stacked_msb(abce[:, :1], alpha)[:, 0],
                                mesh)),
        "whir_round_sharded": (
            lambda: torch.stack(M.whir_round_sharded(mesh, f, w), dim=1),
            lambda: torch.stack(sc.whir_round_stacked(fw), dim=1)),
        "fold_lsb_sharded": (
            lambda: M.fold_lsb_sharded(mesh, f, alpha),
            lambda: pctx.block(sc.fold_stacked_lsb(fw[:, :1], alpha)[:, 0],
                               mesh)),
        "ntt_sharded": (
            lambda: M.ntt_sharded(mesh, pctx.block(coeffs, mesh),
                                  shapes["ntt_log"]),
            lambda: ntt_mod.ntt(coeffs)[:, me::s]),
        "merkle_root_sharded": (
            lambda: M.merkle_root_sharded(mesh, pctx.block(leaves, mesh)),
            lambda: merkle.commit_dev(leaves).levels[-1][:, 0]),
    }
    for sharded, single in cases.values():  # kernels, twiddle tables
        sharded()
        single()
    mesh.counts.clear()
    out = {}
    for name, (sharded, single) in cases.items():
        with profiling.span(name):
            _sync(dev)
            t0 = time.perf_counter()
            got = sharded()
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
        row = {"max_abs_err": _max_abs_err(got, single()), "ms": ms,
               "shape": list(got.shape)}
        if keep:
            row["local"] = got.cpu().numpy()
        out[name] = row
    return {"functions": out, "collectives": comm_rows(mesh)}


def check_commit(mesh, seed: int, cases: list) -> list:
    """Rank function: for each (log2 leaves, leaf size), ``commit_dev``
    under the mesh against the single-device tree: the root, the level
    shapes of the levels kept whole, and the auth paths of six leaves (the
    first, the last and four seeded ones)."""
    rng = np.random.default_rng(seed)
    dev = mesh.device
    out = []
    for log_n, size in cases:
        n = 1 << log_n
        leaves = torch.from_numpy(random_planes(rng, size * n).reshape(
            16, size, n)).to(dev)
        idx = torch.tensor(sorted({0, n - 1, *rng.choice(n, 4).tolist()}),
                           dtype=torch.int64, device=dev)
        want = merkle.commit_dev(leaves)
        with pctx.use_mesh(mesh):
            got = merkle.commit_dev(leaves)
            paths = merkle.open_gather_dev(got, idx)
        out.append({
            "sharded_levels": got.sharded,
            "root_equal": got.root() == want.root(),
            "whole_levels_equal": all(
                torch.equal(a, b) for a, b in zip(got.levels[got.sharded:],
                                                  want.levels[got.sharded:])),
            "paths_max_abs_err": _max_abs_err(
                paths, merkle.open_gather_dev(want, idx))})
    return out


def prove_timed(mesh, scheme, r1cs, witness, rng_state) -> dict:
    """One prove of ``scheme`` on ``mesh`` (None: alone) from ``rng_state``:
    its bytes, digest, wall seconds, spans, kernel launches, peak device
    memory and collective counts."""
    dev = torch.device(scheme.device)
    counters = kernel_counters()
    reset_counts(counters)
    if mesh is not None:
        mesh.counts.clear()
    sync = profiling.GLOBAL.sync
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        profiling.GLOBAL.sync = torch.cuda.synchronize
    mark = len(profiling.GLOBAL.root.children)
    rng = random.Random()
    rng.setstate(rng_state)
    try:
        t0 = time.perf_counter()
        proof = scheme.prove(r1cs, witness, rng=rng, mesh=mesh)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        profiling.GLOBAL.sync = sync
    return {
        "proof": proof, "sha256": hashlib.sha256(proof).hexdigest(),
        "wall_s": wall,
        "spans": {s.name: s.elapsed
                  for s in profiling.GLOBAL.root.children[mark:]},
        "launches": read_counts(counters),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None),
        "collectives": comm_rows(mesh)}


def prove_example(mesh, seed: int, n_mults: int, security: int,
                  folding: int, max_pow: int, rng_seed: int,
                  base: bool = True) -> dict:
    """Rank function: ``examples.build_system(seed, n_mults)`` proved on the
    mesh from ``Random(rng_seed)`` and verified, and with ``base`` proved
    once more on this rank alone.  Returns both proofs' records
    (:func:`prove_timed`)."""
    r1cs, witness = examples.build_system(seed, n_mults)
    scheme = examples.tiny_scheme(r1cs, mesh.device, security, folding,
                                  max_pow)
    state = random.Random(rng_seed).getstate()
    out = {}
    if base:
        out["base"] = prove_timed(None, scheme, r1cs, witness, state)
    out["mesh"] = prove_timed(mesh, scheme, r1cs, witness, state)
    scheme.verify(r1cs, out["mesh"]["proof"])
    return out


def prove_blob(mesh, blob: bytes, rng_state) -> dict:
    """Rank function: ``pickle.loads(blob)`` = (scheme, r1cs, witness),
    proved on the mesh from ``rng_state`` on this rank's device (after one
    warm-up prove); returns its record (:func:`prove_timed`)."""
    scheme, r1cs, witness = pickle.loads(blob)
    scheme.device = mesh.device
    prove_timed(mesh, scheme, r1cs, witness, rng_state)
    return prove_timed(mesh, scheme, r1cs, witness, rng_state)


def dryrun_rank(mesh) -> dict:
    step = check_sharded(mesh, 0, step_shapes(mesh.size))
    proves = prove_example(mesh, seed=5, n_mults=24, security=10, folding=2,
                           max_pow=2, rng_seed=3)
    return {"step": step, "proves": proves}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", choices=["gloo", "nccl"], required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--share-device", action="store_true",
                    help="every rank on cuda:0 (gloo only)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    results = launch(dryrun_rank, args.world, args.backend, args.device,
                     args.share_device)
    ok = True
    for rank, res in enumerate(results):
        errs = {k: v["max_abs_err"]
                for k, v in res["step"]["functions"].items()}
        mesh_p, base_p = res["proves"]["mesh"], res["proves"]["base"]
        same = mesh_p["proof"] == base_p["proof"]
        ok &= same and not any(errs.values())
        print(f"rank {rank}: sharded step max abs errors {json.dumps(errs)}; "
              f"prove on the mesh {'equals' if same else 'DIFFERS FROM'} the "
              f"single-rank proof ({len(base_p['proof'])} bytes, sha256 "
              f"{mesh_p['sha256'][:16]}...) and verifies; mesh prove "
              f"{mesh_p['wall_s']:.3f} s, alone {base_p['wall_s']:.3f} s")
    step_rows = results[0]["step"]["collectives"]
    prove_rows = results[0]["proves"]["mesh"]["collectives"]
    print("rank 0's collectives in the sharded step:\n"
          + comm_table(step_rows))
    print(f"rank 0's collectives in the prove:\n{comm_table(prove_rows)}")
    print(f"dryrun on {args.world} ranks ({args.backend}, {args.device}"
          f"{', one shared card' if args.share_device else ''}): "
          f"{'OK' if ok else 'FAILED'} in {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
