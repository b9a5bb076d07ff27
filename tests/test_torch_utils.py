"""The port's small utilities: the span tree against the JAX package's, the
kernel wrappers' launch counters, and the kernel library's naming and
operand checks.  All on the host; nothing here builds or launches a
kernel."""

import pytest
import torch

from provekit_tpu.utils import profiling as JP
from provekit_tpu_torch import kernels as K
from provekit_tpu_torch.utils import counts as C
from provekit_tpu_torch.utils import profiling as P


def _timed_tree(module, elapsed: float):
    """A tree of two stages, the first with two children, each span's
    elapsed time set to a multiple of ``elapsed``."""
    tree = module.SpanTree()
    with tree.span("prove") as prove:
        with tree.span("commit") as commit:
            pass
        with tree.span("sumcheck") as sumcheck:
            pass
    with tree.span("verify") as verify:
        pass
    for k, s in enumerate([prove, commit, sumcheck, verify]):
        s.elapsed = elapsed * (k + 1.5)
    return tree


@pytest.mark.parametrize("elapsed", [2.0, 3e-3, 4e-6, 5e-9],
                         ids=["s", "ms", "us", "ns"])
def test_span_report_is_the_jax_report(elapsed):
    """With no device-memory column (the JAX package leaves it out when a
    span moved no device memory) the two reports are the same text."""
    got = _timed_tree(P, elapsed).report()
    assert got == _timed_tree(JP, elapsed).report()
    lines = got.splitlines()
    assert [line.split("─ ", 1)[1].split()[0] for line in lines] == [
        "prove", "commit", "sumcheck", "verify"]
    assert lines[0].startswith("├─") and lines[-1].startswith("└─")
    assert lines[1].startswith("│  ├─") and lines[2].startswith("│  └─")


def test_span_tree_syncs_at_every_exit():
    calls = []
    tree = P.SpanTree(sync=lambda: calls.append(len(tree.stack)))
    with tree.span("outer"):
        with tree.span("inner"):
            pass
    # inner's exit, then outer's, each before its span is popped
    assert calls == [3, 2]
    outer = tree.root.children[0]
    assert outer.elapsed >= outer.children[0].elapsed >= 0


def test_span_closes_on_an_exception():
    tree = P.SpanTree()
    with pytest.raises(KeyError):
        with tree.span("fails"):
            raise KeyError("x")
    assert tree.stack == [tree.root]
    assert tree.root.children[0].elapsed >= 0
    with tree.span("next"):
        pass
    assert [s.name for s in tree.root.children] == ["fails", "next"]


def test_counts_reset_and_read():
    counters = C.kernel_counters()
    saved = {k: (fn.launches, getattr(fn, "permutations", None))
             for k, fn in counters.items()}
    try:
        for k, fn in counters.items():
            fn.launches = 3
            if hasattr(fn, "permutations"):
                fn.permutations = 5
        got = C.read_counts(counters)
        assert all(got[k] == 3 for k in counters)
        assert got["duplex_permutations"] == 5
        assert got["segment_permutations"] == 5 * len(C.SEGMENT_KERNELS)
        assert got["sponge_permutations"] == 5 * (1 + len(C.SEGMENT_KERNELS))
        C.reset_counts(counters)
        got = C.read_counts(counters)
        assert all(v == 0 for v in got.values())
    finally:
        for k, fn in counters.items():
            fn.launches, perms = saved[k]
            if perms is not None:
                fn.permutations = perms


def test_kernel_counters_name_every_entry_point_of_the_path():
    """Every C entry point of ``csrc/`` that launches a kernel of the
    prover has a counter: all but the tensor-core experiment's and the
    segments' grid query; the route counters count launches of one of
    them."""
    entries = {e for sigs in K.SIGNATURES.values() for e in sigs}
    launched = entries - {"pk_mont_mul_mma", "pk_segment_max_blocks"}
    counters = C.kernel_counters()
    names = {f"pk_{k}" for k in counters if k not in C.ROUTE_COUNTERS}
    assert names == launched
    assert set(C.ROUTE_COUNTERS) <= set(counters)
    assert {f"pk_{k}" for k in C.ROUTE_COUNTERS.values()} <= launched


def test_library_path_names_the_source_and_its_hash():
    paths = {src: K.library_path(src) for src in K.SIGNATURES}
    for src, path in paths.items():
        stem = src.removesuffix(".cu")
        assert path.parent == K.BUILD_DIR
        assert path.name.startswith(f"libpk_{stem}_")
        assert len(path.name) == len(f"libpk_{stem}_") + 16 + len(".so")
    assert len(set(paths.values())) == len(paths)
    assert K.library_path("mont_mul.cu") == paths["mont_mul.cu"]


@pytest.mark.parametrize("case", ["one_device", "two_devices"])
def test_check_cuda_int32_refuses_operands_off_the_card(case):
    """Without a card every operand is off it: each is refused, whatever
    its dtype and shape, and so is a pair on two devices."""
    cpu = torch.zeros((16, 4), dtype=torch.int32)
    meta = torch.zeros((8, 4), dtype=torch.int64, device="meta")
    operands = {"one_device": [cpu, cpu.to(torch.int64)],
                "two_devices": [meta, cpu]}[case]
    with pytest.raises(ValueError, match="k: operands must share one CUDA "
                                         "device"):
        K.check_cuda_int32("k", *operands)
