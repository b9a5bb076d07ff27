"""The smoke run's bound arithmetic and phase helpers (chip_smoke.py),
pinned on the CPU.

A kernel's bound is the larger of its bytes over the HBM rate and its
operations over the card's peak: 32-bit integer multiply-adds at 132 SMs x
64 a clock x the maximum SM clock, two for each 32 x 32 -> 64-bit limb
product and one for each reduction factor (low word only).
"""

import json
import pathlib

import pytest

import chip_smoke as C


def test_peak_rates_at_the_h100_clock():
    rates = C.peak_rates(1980)
    assert rates["int32_muladd"] == 132 * 64 * 1980e6
    assert rates["int8_tensor"] == 1979e12


def test_multiply_adds_of_a_square_and_a_product():
    # square: 36 + 64 full limb products and 8 low-only factors; CIOS
    # product: 64 + 64 and 8
    assert C.MONT_SQR_MULADDS == 208
    assert C.MONT_MUL_MULADDS == 264
    assert C.ladder_ops(3) == {"int32_muladd": 3 * 14 * 208}
    assert C.mont_mul_ops(5) == {"int32_muladd": 5 * 264}


def test_bound_of_compress_at_2_20_is_operations():
    # 2^20 compressions: 14 squares of 208 multiply-adds each, against 192
    # bytes an element
    ms, by = C.bound(3 * 64 * 2**20, C.ladder_ops(2**20), C.peak_rates(1980))
    assert by == "operations"
    assert ms == pytest.approx(2**20 * 14 * 208 / (132 * 64 * 1.98e9)
                               * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.18255, abs=1e-5)


def test_bound_of_mont_mul_at_2_21_is_bytes():
    # 384 MiB at 3.35 TB/s; 264 multiply-adds an element stay under it
    ms, by = C.bound(3 * 64 * 2**21, C.mont_mul_ops(2**21), C.peak_rates(1980))
    assert by == "bytes"
    assert ms == pytest.approx(3 * 64 * 2**21 / 3.35e12 * 1e3, rel=1e-12)
    ops_ms = 2**21 * 264 / (132 * 64 * 1.98e9) * 1e3
    assert ops_ms == pytest.approx(0.03310, abs=1e-5)
    assert ops_ms < ms


# -- phase 8's helpers -------------------------------------------------------


def test_fixture_cases_are_the_acir_tests_inputs():
    """Phase 8 gives each Noir fixture the inputs of
    tests/test_acir_fixtures.py, by ABI name, and checks its witnesses."""
    from provekit_tpu_torch.fields import bn254 as F
    cases = C.fixture_cases()
    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    assert sorted(cases) == sorted(p.stem for p in fixtures.glob("*.json"))
    for name, (inputs, _) in cases.items():
        abi = json.loads((fixtures / f"{name}.json").read_text())["abi"]
        assert [p["name"] for p in abi["parameters"]] == list(inputs)
    assert cases["brillig_inverse"][1] == {1: pow(12345, F.P - 2, F.P)}
    assert cases["range_and_xor"] == ({"a": 0xA5, "b": 0x3C},
                                      {2: 0x24, 3: 0x99})


def test_prover_toml_reads_back_through_the_abi():
    from provekit_tpu_torch.acir.abi import Abi, input_from_toml
    text = C.prover_toml({"x": 6, "y": 7})
    assert text == 'x = "6"\ny = "7"\n'
    abi = Abi.from_json({"parameters": [
        {"name": "x", "type": {"kind": "field"}},
        {"name": "y", "type": {"kind": "field"}}]})
    assert input_from_toml(abi, text) == [6, 7]


def test_verify_requests():
    proof = bytes(range(10))
    reqs = C.verify_requests(proof)
    assert [(p, code) for p, _, code in reqs] == [
        ("/api/v1/verify", 200), ("/api/v1/verify", 400),
        ("/api/v1/verify", 400), ("/api/v1/prove", 404)]
    assert reqs[0][1] == b'{"transcript": "00010203040506070809"}'
    assert bytes.fromhex(json.loads(reqs[1][1])["transcript"]) == \
        bytes([0, 1, 2, 3, 4, 4, 6, 7, 8, 9])
    with pytest.raises(ValueError):
        json.loads(reqs[2][1])
    assert reqs[3][1] == reqs[0][1]


def test_scheme_shape_of_the_passport():
    """1,590,897 constraints and 2,261,537 witnesses: m = 23, m_0 = 21 and
    an RS domain of 2^24, half of sha256 x100's 2^25."""
    assert C.scheme_shape(C.PASSPORT_CONSTRAINTS, C.PASSPORT_WITNESSES) == \
        {"m": 23, "m_0": 21, "rs_domain_log": 24}
    assert C.scheme_shape(3_138_745, 4_630_312) == \
        {"m": 24, "m_0": 22, "rs_domain_log": 25}


def test_run_cli_returns_its_spans(tmp_path):
    fixture = pathlib.Path(__file__).resolve().parent / "fixtures" / \
        "mul_chain.json"
    nps = tmp_path / "s.nps"
    spans = C.run_cli(["prepare", str(fixture), "-o", str(nps), "--security",
                       "30", "--max-pow-bits", "6", "--device", "cpu"],
                      tmp_path / "out.txt")
    assert [p for p, _ in spans] == ["prepare", "prepare/noir_to_r1cs",
                                     "prepare/write_nps"]
    assert all(s >= 0 for _, s in spans)
    out = (tmp_path / "out.txt").read_text()
    assert "R1CS: " in out and f"wrote {nps}" in out and nps.exists()


# -- phase 9's helpers -------------------------------------------------------


def test_flip_byte_flips_one_transcript_byte(tmp_path):
    from provekit_tpu_torch.compiler import NoirProof
    from provekit_tpu_torch.io import files
    src, dst = tmp_path / "p.np", tmp_path / "bad.np"
    files.write(src, NoirProof(transcript=bytes(range(40))))
    C.flip_byte(src, dst)
    C.flip_byte(src, tmp_path / "bad7.np", pos=7)
    assert files.read(dst).transcript == bytes([1, *range(1, 40)])
    got = files.read(tmp_path / "bad7.np").transcript
    assert [i for i in range(40) if got[i] != i] == [7] and got[7] == 6
    assert files.read(src).transcript == bytes(range(40))


def test_recursion_spans():
    spans = [("groth16_setup", 20.5), ("groth16_prove", 30.0),
             ("groth16_verify", 2.0)]
    assert C.recursion_spans(spans) == dict(spans)
    cached = [("load_keys", 1.0), ("groth16_prove", 29.0),
              ("groth16_verify", 2.5)]
    assert C.recursion_spans(cached) == dict(cached)
    for bad in (spans[1:], cached[:2], [("load_keys", 1.0), *spans]):
        with pytest.raises(SystemExit):
            C.recursion_spans(bad)


def test_wrapper_counts():
    text = ("├─ groth16_verify 2.28 s\nrecursive verification: OK (102330 "
            "wrapper constraints, 161750 wires, 40 public inputs)\n")
    assert C.wrapper_counts(text) == {"constraints": 102330,
                                      "wires": 161750, "public_inputs": 40}
    with pytest.raises(SystemExit):
        C.wrapper_counts("recursive verification FAILED")


def test_budget_line():
    assert C.budget_line("phase 9", 250.25, 300) == \
        "phase 9 took 250.250 s, within its budget of 300 s"
    assert C.budget_line("phase 9", 300.0, 300).endswith(
        "within its budget of 300 s")
    assert "OVER its budget" in C.budget_line("phase 9", 300.5, 300)


# -- the fused sumcheck segments ---------------------------------------------


def test_segment_shapes_of_the_main_paths(monkeypatch):
    """poseidon2 x1000 (m = 20, m_0 = 19) and sha256 x100 (m = 24,
    m_0 = 22): every sumcheck is one segment launch over all of its rounds,
    none with a leading round one at a time: Spartan's whole sumcheck, the
    blinding polynomial's two WHIR calls, then the witness's five or six
    (its opening's first call on 2^20 or 2^24 elements included)."""
    whir = [("whir_segment", 256, 4), ("whir_segment", 16, 4)]
    tail = [("whir_segment", 1 << 16, 4), ("whir_segment", 4096, 4),
            ("whir_segment", 256, 4), ("whir_segment", 16, 4)]
    assert C.segment_shapes(C.scheme_for(515_003, 515_005)) == [
        ("spartan_segment", 1 << 19, 19), *whir,
        ("whir_segment", 1 << 20, 4), *tail]
    assert C.segment_shapes(C.scheme_for(3_138_745, 4_630_312)) == [
        ("spartan_segment", 1 << 22, 22), *whir,
        ("whir_segment", 1 << 24, 4), ("whir_segment", 1 << 20, 4), *tail]
    from provekit_tpu_torch.ops import fused
    monkeypatch.setattr(fused, "FUSE_MAX", 0)
    assert C.segment_shapes(C.scheme_for(515_003, 515_005)) == []


@pytest.mark.parametrize("fuse_max", [4, 1 << 14])
def test_segment_shapes_are_a_proves_launches(monkeypatch, fuse_max):
    """What segment_shapes predicts is what a prove launches, recorded by
    recorded_segments (phase 5's system of 8 steps, on the CPU)."""
    import random

    from provekit_tpu_torch.ops import fused
    r1cs, witness = C.build_tiny_system(seed=3, n_mults=8)
    scheme = C.tiny_scheme(r1cs, "cpu")
    monkeypatch.setattr(fused, "FUSE_MAX", fuse_max)
    segment = fused.whir_sumcheck_segment
    with C.recorded_segments() as calls:
        scheme.prove(r1cs, witness, rng=random.Random(11))
    assert fused.whir_sumcheck_segment is segment
    want = C.segment_shapes(scheme)
    assert calls == want
    assert want[0] == ("spartan_segment", 1 << scheme.m_0, scheme.m_0) \
        or fuse_max < 1 << scheme.m_0


def test_segment_work():
    # WHIR, n = 8, 3 rounds: 4 + 2 + 1 pairs of 6 products, 4 a round;
    # 9 permutations; 2 x 8 + 2 elements in, 2 + 2 + 12 out
    nbytes, ops, perms = C.segment_work("whir_segment", 8, 3)
    assert perms == 9
    assert nbytes == 64 * (18 + 16)
    assert ops == {"int32_muladd": (6 * 7 + 4 * 3) * 264 + 9 * 14 * 208}
    # Spartan, n = 8, 3 rounds: 7 pairs of 6 products, folds of 4 on the
    # 4 + 2 pairs before the last round, 21 a round; 12 permutations
    nbytes, ops, perms = C.segment_work("spartan_segment", 8, 3)
    assert perms == 12
    assert nbytes == 64 * (32 + 5 + 21 + 2 + 15)
    assert ops == {"int32_muladd": (6 * 7 + 4 * 6 + 21 * 3) * 264
                   + 12 * 14 * 208}
    assert C.segment_work("spartan_segment", 1, 0)[1:] == (
        {"int32_muladd": 0}, 0)


def test_path_segment_shapes_cover_the_four_paths():
    """Phase 3 runs the segments at the shapes of all four paths: the
    passport (m = 23, m_0 = 21) and the mul_chain inner prove (m_0 = 1)
    launch shapes that poseidon2 x1000 and sha256 x100 never do; every call
    takes all the rounds of its sumcheck."""
    from provekit_tpu_torch.ops import fused
    paths = C.path_segment_shapes()
    assert set(paths) == {"poseidon2_x1000", "sha256_x100", "passport_cli",
                          "recursion_cli"}
    assert paths["passport_cli"] == [
        ("spartan_segment", 1 << 21, 21),
        ("whir_segment", 256, 4), ("whir_segment", 16, 4),
        ("whir_segment", 1 << 23, 4), ("whir_segment", 1 << 19, 4),
        ("whir_segment", 1 << 15, 4), ("whir_segment", 2048, 4),
        ("whir_segment", 128, 4), ("whir_segment", 8, 3)]
    assert paths["recursion_cli"] == [("spartan_segment", 2, 1),
                                      ("whir_segment", 8, 3),
                                      ("whir_segment", 16, 4)]
    for calls in paths.values():
        assert all(fused.lead_rounds(n, r) == 0 for _, n, r in calls)
        assert max(n for _, n, _ in calls) <= fused.FUSE_MAX
    assert [c for c in paths["sha256_x100"] if c[1] <= 1 << 20] == \
        paths["poseidon2_x1000"][1:]


def test_segment_per_round_is_the_plain_version(monkeypatch):
    """Phase 3's reference above 2^20 elements, the per-round loop on the
    operands' device, gives the segment wrappers' outputs (here on the CPU,
    against the plain versions) and runs no kernel wrapper: mont_mul and
    the duplex are replaced by their plain versions while it runs, and put
    back after."""
    import numpy as np
    import torch

    from provekit_tpu_torch.fields import vector as V
    from provekit_tpu_torch.hash import skyscraper as S
    from provekit_tpu_torch.ops import fused

    def no_kernel(*args):
        raise AssertionError("a kernel wrapper ran in the reference")

    no_kernel.launches = 0
    rng = np.random.default_rng(5)
    cpu = torch.device("cpu")
    for kind, plain in (("whir_segment", fused.whir_sumcheck_segment_plain),
                        ("spartan_segment",
                         fused.spartan_sumcheck_fused_plain)):
        args = C.segment_args(torch, rng, cpu, kind, 16, 3, False)
        want = plain(*args)
        with monkeypatch.context() as m:
            m.setattr(V, "mont_mul", no_kernel)
            m.setattr(S, "duplex_v", no_kernel)
            got = C.segment_per_round(kind, args)
            assert V.mont_mul is no_kernel and S.duplex_v is no_kernel
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


def test_segment_spills_are_read_from_ptxas():
    report = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119whir_segment_kernelE5Polys' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119whir_segment_kernelE5Polys
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 800 bytes smem
ptxas info    : Function properties for _ZN12_GLOBAL__N_122spartan_segment_kernelE5Polys
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
"""
    assert C.ptxas_spills(report) == {
        "_ZN12_GLOBAL__N_119whir_segment_kernelE5Polys": (0, 0),
        "_ZN12_GLOBAL__N_122spartan_segment_kernelE5Polys": (12, 16)}
    with pytest.raises(SystemExit):
        C.check_segment_spills(report)
    C.check_segment_spills(report.replace("12 bytes spill stores, 16",
                                          "0 bytes spill stores, 0"))
    with pytest.raises(SystemExit):
        C.check_segment_spills(report.split("ptxas info    : Function "
                                            "properties for _ZN12_GLOBAL__N_122")[0])


def test_check_segments_fails_on_other_shapes(capsys):
    calls = [("whir_segment", 8, 3)]
    C.check_segments("[9] mul_chain", calls, list(calls))
    with pytest.raises(SystemExit):
        C.check_segments("[9] mul_chain", calls,
                         [("whir_segment", 16, 4)])


def test_recorded_segments_keep_the_launch_counts():
    """A wrapper counts under its module name, which inside the block is
    the recorder: what it counts there reaches the wrapper's own count, as
    the passport's and the inner prove's counts read after the block
    need."""
    from provekit_tpu_torch.ops import fused
    whir, spartan = fused.whir_sumcheck_segment, fused.spartan_sumcheck_fused
    before = (whir.launches, whir.permutations, spartan.launches)
    with C.recorded_segments():
        fused.whir_sumcheck_segment.launches += 1
        fused.whir_sumcheck_segment.permutations += 9
        fused.spartan_sumcheck_fused.launches += 1
    assert (whir.launches, whir.permutations, spartan.launches) == (
        before[0] + 1, before[1] + 9, before[2] + 1)
    whir.launches, whir.permutations, spartan.launches = before


# -- the host library's helpers (phases 3, 6 and 8) ---------------------------


def test_host_hash_pairs_are_edge_and_seeded():
    """Phase 3 holds the host library to K4 and K5 on every pair of the
    edge values, then on seeded pairs."""
    from provekit_tpu_torch.fields import bn254 as F
    from provekit_tpu_torch.hash import skyscraper as S
    pairs = C.host_hash_pairs(C.SEED, 10)
    edge = S.edge_values(C.SEED)
    assert pairs[:len(edge) ** 2] == [(l, r) for l in edge for r in edge]
    assert len(pairs) == len(edge) ** 2 + 10
    assert all(0 <= v < F.P for pair in pairs for v in pair)
    assert pairs == C.host_hash_pairs(C.SEED, 10)


def test_plain_host_hash_swaps_in_python(monkeypatch):
    """Inside the swap-in the verifier runs with the host library
    unloadable, and accepts and rejects as with it; after it, the library's
    entry points are back."""
    import random

    from provekit_tpu_torch import native
    from provekit_tpu_torch.hash import skyscraper as S
    r1cs, witness = C.build_tiny_system(seed=3, n_mults=1)
    scheme = C.tiny_scheme(r1cs, "cpu")
    proof = scheme.prove(r1cs, witness, rng=random.Random(11))
    saved = native.permute, native.compress, native.merkle_verify

    def no_library():
        raise AssertionError("the host library ran")

    monkeypatch.setattr(native, "load", no_library)
    with C.plain_host_hash():
        assert native.permute is S.permute and native.compress is S.compress
        scheme.verify(r1cs, proof)
        C.expect_rejected(scheme, r1cs, proof, [len(proof) // 2])
    assert (native.permute, native.compress, native.merkle_verify) == saved
    with pytest.raises(AssertionError, match="host library"):
        scheme.verify(r1cs, proof)


def ram_scheme():
    """tests/test_compiler.py's RAM gadget (Spice memory with its
    challenges) on the port, on the CPU."""
    from provekit_tpu_torch.acir import model as acir
    from provekit_tpu_torch.compiler import NoirProofScheme
    from tests.test_torch_compiler import ram
    circuit, vals, _ = ram(acir)
    return NoirProofScheme.from_program(
        acir.Program(functions=[circuit]), security_level=30,
        max_pow_bits=6, device="cpu"), vals


def test_compare_solves_and_recorded_solves(monkeypatch):
    """The recorder sees the solve a prove makes and puts the method back;
    the comparison passes on equal witnesses and fails on one that
    differs."""
    import random

    from provekit_tpu_torch import native
    from provekit_tpu_torch.compiler import NoirProofScheme
    scheme, vals = ram_scheme()
    solve = NoirProofScheme.solve_witness
    with C.recorded_solves() as solves:
        witness = scheme.solve_witness(vals, rng=random.Random(3))
    assert [(s, v) for s, v, _ in solves] == [(scheme, vals)]
    assert NoirProofScheme.solve_witness is solve
    assert witness == scheme.solve_witness(vals, rng=random.Random(3))
    native_s, plain_s = C.compare_solves(scheme, vals)
    assert native_s > 0 and plain_s > 0
    real = native.solve_witness

    def one_differs(*args):
        w = real(*args)
        w[-1] = (w[-1] or 0) + 1
        return w

    monkeypatch.setattr(native, "solve_witness", one_differs)
    with pytest.raises(SystemExit):
        C.compare_solves(scheme, vals)
