"""The port's gnark export (``io/gnark.py``) and Go-parse mirror
(``io/go_parse.py``) against the JAX package's, on the CPU.

Both packages export the same proof bytes: the port's, proved with a seeded
``rng`` (the JAX package's proofs of the same inputs are the same bytes, as
``tests/test_torch_e2e.py`` and ``tests/test_torch_files.py`` show), so no
JAX prove runs here.  Every comparison is exact: the same JSON text, the
same parsed transcript.  The inputs are the system and tiny scheme of
``tests/test_go_conformance.py`` and the compiled ``mul_chain`` and
``brillig_inverse`` fixtures.
"""

import functools
import json
import random

import pytest
import torch

import chip_smoke
from provekit_tpu import cli as jcli
from provekit_tpu.io import gnark as jgnark
from provekit_tpu.io import go_parse as jgo_parse
from provekit_tpu_torch import cli, convert
from provekit_tpu_torch.compiler import NoirProof
from provekit_tpu_torch.io import files, gnark, go_parse
from tests.test_e2e import build_system
from tests.test_torch_files import fixture_schemes
from tests.test_verifier_circuit import tiny_scheme

torch.set_num_threads(1)

CPU = torch.device("cpu")
CASES = ("tiny", "mul_chain", "brillig_inverse")


@functools.cache
def export_case(name):
    """(port WhirR1CSScheme, port R1CS, JAX WhirR1CSScheme, JAX R1CS, proof
    bytes, the port's NoirProofScheme or None) of one input, made once."""
    if name == "tiny":
        jr1cs, _ = build_system(seed=7, n_mults=3)
        jscheme = tiny_scheme(jr1cs, security=10, folding=2, max_pow=2)
        r1cs, witness = chip_smoke.build_tiny_system(7, 3)
        scheme = convert.scheme_from_fields(convert.scheme_fields(jscheme),
                                            CPU)
        proof = scheme.prove(r1cs, witness, rng=random.Random(5))
        return scheme, r1cs, jscheme, jr1cs, proof, None
    port, ref = fixture_schemes(name)
    inputs, _ = chip_smoke.fixture_cases()[name]
    wmap = port.generate_witness(chip_smoke.prover_toml(inputs))
    witness = port.solve_witness(wmap, rng=random.Random(5))
    proof = port.whir_for_witness.prove(port.r1cs, witness,
                                        rng=random.Random(6))
    return (port.whir_for_witness, port.r1cs, ref.whir_for_witness, ref.r1cs,
            proof, port)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return export_case(request.param)


def test_same_r1cs_and_io_pattern(case):
    scheme, r1cs, jscheme, jr1cs, _, _ = case
    assert convert.r1cs_to_coo(r1cs) == convert.r1cs_to_coo(jr1cs)
    for mat, jmat in zip((r1cs.a, r1cs.b, r1cs.c), (jr1cs.a, jr1cs.b,
                                                     jr1cs.c)):
        assert (mat.rows, mat.cols, mat.value_ids) == \
            (jmat.rows, jmat.cols, jmat.value_ids)
    assert r1cs.interner.values == jr1cs.interner.values
    assert scheme.create_io_pattern().as_bytes() == \
        jscheme.create_io_pattern().as_bytes()


def test_export_is_jax_text(case):
    scheme, r1cs, jscheme, jr1cs, proof, _ = case
    io = scheme.create_io_pattern().as_bytes()
    params = json.dumps(gnark.gnark_parameters(scheme, proof, io))
    assert params == json.dumps(jgnark.gnark_parameters(jscheme, proof, io))
    assert json.dumps(gnark.r1cs_to_gnark_json(r1cs)) == \
        json.dumps(jgnark.r1cs_to_gnark_json(jr1cs))


def test_go_parse_walk_is_jax_walk(case, tmp_path):
    scheme, r1cs, _, _, proof, _ = case
    io = scheme.create_io_pattern().as_bytes()
    gnark.write_gnark_inputs(scheme, r1cs, proof, io, tmp_path / "params",
                             tmp_path / "r1cs.json")
    config = json.loads((tmp_path / "params").read_text())
    r1cs_doc = json.loads((tmp_path / "r1cs.json").read_text())
    out = go_parse.prepare(config, r1cs_doc)
    ref = jgo_parse.prepare(config, r1cs_doc)
    parsed, jparsed = out["parsed"], ref["parsed"]
    for key in ("merkle_paths", "stir_answers", "deferred",
                "claimed_evaluations", "truncated"):
        assert getattr(parsed, key) == getattr(jparsed, key), key
    assert out["interner"] == ref["interner"] == list(r1cs.interner.values)
    for hint in ("hiding_spartan_hint", "witness_hint"):
        assert (out[hint].first_round, out[hint].rounds) == \
            (ref[hint].first_round, ref[hint].rounds)
    assert len(out["hiding_spartan_hint"].rounds) == \
        len(scheme.whir_for_hiding_spartan.rounds)
    assert len(out["witness_hint"].rounds) == len(scheme.whir_witness.rounds)
    ops = go_parse.parse_io_pattern(config["io_pattern"])
    assert [(o.kind, o.size, o.label) for o in ops] == \
        [(o.kind, o.size, o.label)
         for o in jgo_parse.parse_io_pattern(config["io_pattern"])]
    absorbed = sum(op.count if op.label == "pow-nonce" else op.count * 32
                   for op in scheme.create_io_pattern().ops
                   if op.kind == "A")
    assert len(parsed.truncated) == absorbed

    # a short transcript and a missing field break the walk in both
    bad = dict(config, transcript=config["transcript"][:-40])
    bad["transcript_len"] = len(bad["transcript"])
    for mod in (go_parse, jgo_parse):
        with pytest.raises(ValueError):
            mod.prepare(bad, r1cs_doc)
        with pytest.raises(ValueError, match="log_a_num_terms"):
            mod.prepare({k: v for k, v in config.items()
                         if k != "log_a_num_terms"}, r1cs_doc)


@pytest.mark.parametrize("name", ("mul_chain", "brillig_inverse"))
def test_cli_writes_jax_files(name, tmp_path, capsys):
    """``generate-gnark-inputs --device cpu`` writes the JAX CLI's two
    files from the same .nps and .np."""
    _, _, _, _, proof, port = export_case(name)
    nps, np_ = tmp_path / "scheme.nps", tmp_path / "proof.np"
    files.write(nps, port)
    files.write(np_, NoirProof(transcript=proof))
    cli.main(["generate-gnark-inputs", str(nps), str(np_), "-o",
              str(tmp_path / "port"), "--device", "cpu"])
    jcli.main(["generate-gnark-inputs", str(nps), str(np_), "-o",
               str(tmp_path / "jax")])
    for fname in ("params_for_recursive_verifier", "r1cs.json"):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "jax" / fname).read_bytes(), fname
    assert "wrote" in capsys.readouterr().out


def test_cli_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["generate-gnark-inputs", str(tmp_path / "s.nps"),
                  str(tmp_path / "p.np"), "-o", str(tmp_path / "out")])
