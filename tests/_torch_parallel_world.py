"""The ranks of tests/test_torch_parallel.py: worlds of eight and of four
gloo ranks on the CPU for the sharded functions and ``commit_dev`` (and
on four the tiny system's prove), and the inputs of its proves on four.

This module imports no JAX: the spawned ranks import it by name.
"""

from provekit_tpu_torch.parallel import dryrun as D
from provekit_tpu_torch.parallel import make_mesh

SEED = 20261018
WIDE = {"spartan": 1 << 12, "whir": 1 << 12, "ntt_log": 12,
        "leaf": (4, 1 << 12)}
# (log2 leaves, leaf size): 1, 2 and 128 leaves a rank on four ranks
COMMIT_CASES_4 = [(2, 4), (3, 2), (9, 4)]
COMMIT_CASES_8 = [(9, 4)]
# n_mults of the large case: 2050 constraints (m_0 = 12) and 2052
# witnesses (m = 13), so both sumchecks hold 2^10 or more elements a rank
# on four ranks, and each witness subtree 2^10 leaves
LARGE_MULTS = 1025
# (seed, n_mults, security, folding, max_pow, rng seed) of each prove
TINY = (3, 1, 3, 2, 2, 11)
MULTS24 = (5, 24, 10, 2, 2, 3)
LARGE = (5, LARGE_MULTS, 10, 2, 2, 3)


def step_rank(mesh) -> dict:
    """The sharded functions and ``commit_dev`` on a mesh of eight ranks or
    of four; on four also the functions at n = 2^12 and the tiny system's
    prove (its record, ``dryrun.prove_timed``)."""
    s = mesh.size
    out = {f"s{s}": D.check_sharded(mesh, SEED, D.step_shapes(s), keep=True),
           f"commit{s}": D.check_commit(mesh, SEED, {4: COMMIT_CASES_4,
                                                     8: COMMIT_CASES_8}[s])}
    if s == 4:
        out["s4_wide"] = D.check_sharded(mesh, SEED, WIDE)
        out["tiny_prove"] = D.prove_example(mesh, *TINY, base=False)["mesh"]
    try:                      # a mesh is the whole group, never a part
        make_mesh(s // 2, device="cpu")
    except ValueError as e:
        out["half_mesh_error"] = str(e)
    return out


def failing_rank(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
