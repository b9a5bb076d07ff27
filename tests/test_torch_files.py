"""The port's artifact files, CLI and verify service against the JAX package.

* The decompressed ``.nps`` body of a scheme compiled by the port is byte
  for byte the JAX package's, for each Noir fixture (the passport
  circuit's in ``tests/test_torch_circuits.py``); the JSON forms are the
  same text.
* Each package reads the other's ``.nps`` and ``.np`` files (both written
  with zlib, the port's compressor where ``zstandard`` is missing) and gets
  back the same R1CS, builders, ABI and transcript.
* Bad magic, version and format gates, the legacy header, and a zstd body
  read where ``zstandard`` is missing raise clear errors.
* The CLI proves from ``Prover.toml`` through the port's ACVM and Brillig VM
  with ``--device cpu``; without it the entry points ask for the card.
* The library proof of the ``brillig_inverse`` fixture under
  ``random.Random(6)`` is the same bytes in both packages, and each
  package's CLI ``verify`` accepts the other's ``.nps`` and ``.np``.
* The verify service answers 200, 400, 400 and 404 (a valid proof, a
  flipped byte, a malformed body, a wrong path).
"""

import inspect
import json
import pathlib
import random
import threading
import zlib
from http.server import ThreadingHTTPServer

import pytest
import torch

import chip_smoke
from provekit_tpu import cli as jcli
from provekit_tpu.acir import parse as jparse
from provekit_tpu.compiler import NoirProof as JProof
from provekit_tpu.compiler import NoirProofScheme as JScheme
from provekit_tpu.io import files as jfiles
from provekit_tpu_torch import cli, convert, server
from provekit_tpu_torch.acir import brillig as B
from provekit_tpu_torch.acir import model as acir
from provekit_tpu_torch.acir import parse as tparse
from provekit_tpu_torch.acir.abi import Abi, AbiParameter
from provekit_tpu_torch.compiler import NoirProof, NoirProofScheme
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.io import files

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NAMES = ("mul_chain", "range_and_xor", "rom_reads", "brillig_inverse")


def fixture_schemes(name, security=30, max_pow=6):
    """(port scheme on the CPU, JAX scheme) of one Noir fixture."""
    path = FIXTURES / f"{name}.json"
    port = NoirProofScheme.from_program(
        tparse.parse_artifact(path), security, max_pow,
        abi=tparse.artifact_abi(path), device=CPU)
    ref = JScheme.from_program(jparse.parse_artifact(path), security,
                               max_pow, abi=jparse.artifact_abi(path))
    return port, ref


def body(path) -> bytes:
    """The decompressed body of an artifact file (20-byte header)."""
    return files._decompress_body(pathlib.Path(path).read_bytes()[20:])


def same_body(port, ref):
    """The body ``files.write`` compresses, for a port scheme and a JAX
    scheme, is the same bytes."""
    from provekit_tpu.io import binenc as jbinenc
    from provekit_tpu_torch.io import binenc
    assert binenc.encode(files.scheme_to_doc(port)) == \
        jbinenc.encode(jfiles.scheme_to_doc(ref))


def same_scheme(port, ref):
    """A port scheme and a JAX scheme hold the same circuit."""
    assert files._enc(port.program) == jfiles._enc(ref.program)
    assert convert.r1cs_to_coo(port.r1cs) == convert.r1cs_to_coo(ref.r1cs)
    assert port.acir_map == ref.acir_map
    assert [files._enc(b) for b in port.witness_builders] == \
        [jfiles._enc(b) for b in ref.witness_builders]
    assert files._enc(port.abi) == jfiles._enc(ref.abi)
    assert (port.whir_for_witness.m, port.whir_for_witness.m_0) == \
        (ref.whir_for_witness.m, ref.whir_for_witness.m_0)


@pytest.fixture
def zlib_only(monkeypatch):
    """Both packages write zlib bodies, as where zstandard is missing."""
    monkeypatch.setattr(files, "_zstd", None)
    monkeypatch.setattr(jfiles, "_compress", lambda d: zlib.compress(d, 6))


# -- proofs across the packages, and the verify service ------------------------
# (first in the file: the JAX prove compiles for minutes on a cold cache, and
# starting it early lets the other workers run beside it)


@pytest.fixture(scope="module")
def inverse_proofs():
    """The brillig_inverse fixture's library proof in both packages, as
    tests/test_acir_fixtures.py proves it: (port scheme, JAX scheme, port
    proof, JAX proof)."""
    from provekit_tpu import config
    from provekit_tpu.ops import ntt as ntt_mod
    from provekit_tpu.ops import sumcheck as sc_mod
    from provekit_tpu.parallel import make_mesh
    port, ref = fixture_schemes("brillig_inverse", security=3, max_pow=2)
    inputs, expected = chip_smoke.fixture_cases()["brillig_inverse"]
    toml = chip_smoke.prover_toml(inputs)
    wmap = port.generate_witness(toml)
    assert wmap == ref.generate_witness(toml)
    assert {k: wmap[k] for k in expected} == expected
    witness = port.solve_witness(wmap, rng=random.Random(5))
    proof = port.whir_for_witness.prove(port.r1cs, witness,
                                        rng=random.Random(6))
    saved = (config.CHEAP_SYNC, sc_mod.HOST_TAIL, ntt_mod.HOST_TAIL)
    config.CHEAP_SYNC = True
    sc_mod.HOST_TAIL = max(sc_mod.HOST_TAIL, 1 << 16)
    ntt_mod.HOST_TAIL = max(ntt_mod.HOST_TAIL, 1 << 16)
    try:
        jwitness = ref.solve_witness(wmap, rng=random.Random(5))
        jproof = ref.whir_for_witness.prove(ref.r1cs, jwitness,
                                            rng=random.Random(6),
                                            mesh=make_mesh(1))
    finally:
        config.CHEAP_SYNC, sc_mod.HOST_TAIL, ntt_mod.HOST_TAIL = saved
    return port, ref, proof, jproof


def test_brillig_inverse_proof_is_jax_bytes(inverse_proofs):
    _, _, proof, jproof = inverse_proofs
    assert proof == jproof


def test_cli_verify_across_packages(inverse_proofs, tmp_path, capsys):
    port, ref, proof, jproof = inverse_proofs
    files.write(tmp_path / "port.nps", port)
    files.write(tmp_path / "port.np", NoirProof(transcript=proof))
    jfiles.write(tmp_path / "jax.nps", ref)
    jfiles.write(tmp_path / "jax.np", JProof(transcript=jproof))
    jcli.main(["verify", str(tmp_path / "port.nps"),
               str(tmp_path / "port.np")])
    cli.main(["verify", str(tmp_path / "jax.nps"), str(tmp_path / "jax.np"),
              "--device", "cpu"])
    assert capsys.readouterr().out.count("verification: OK") == 2


def test_verify_service_answers(inverse_proofs):
    port, _, proof, _ = inverse_proofs
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(port))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        answers = [(code, chip_smoke.post(httpd.server_port, path, data))
                   for path, data, code in chip_smoke.verify_requests(proof)]
        # well-formed JSON of the wrong shape is malformed too
        odd = [chip_smoke.post(httpd.server_port, "/api/v1/verify", data)
               for data in (b"[1]", b'{"transcript": 5}', b"{}")]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert [got for _, got in answers] == [200, 400, 400, 404]
    assert all(want == got for want, got in answers)
    assert odd == [400, 400, 400]


def test_verify_service_reads_the_body_it_refuses():
    """A large body to an unknown path still gets its 404: the service
    reads the body before it replies and closes, as closing on unread
    bytes resets the connection and the client loses the answer."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(None))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        got = [chip_smoke.post(httpd.server_port, "/api/v1/prove",
                               b"0" * (8 << 20)) for _ in range(3)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert got == [404, 404, 404]


# -- bodies and JSON forms ----------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_nps_body_is_jax_bytes(name, tmp_path):
    port, ref = fixture_schemes(name)
    same_body(port, ref)
    if name == "mul_chain":  # and through the files, header and all
        files.write(tmp_path / "port.nps", port)
        jfiles.write(tmp_path / "jax.nps", ref)
        assert body(tmp_path / "port.nps") == body(tmp_path / "jax.nps")
        assert (tmp_path / "port.nps").read_bytes()[:20] == \
            (tmp_path / "jax.nps").read_bytes()[:20]


@pytest.mark.parametrize("name", ["mul_chain", "brillig_inverse"])
def test_json_form_is_jax_text(name, tmp_path):
    port, ref = fixture_schemes(name)
    files.write(tmp_path / "port.json", port)
    jfiles.write(tmp_path / "jax.json", ref)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    back = files.read(tmp_path / "port.json", device=CPU)
    assert back.witness_builders == port.witness_builders


# -- each package reads the other's files -------------------------------------


@pytest.mark.parametrize("name", ["rom_reads", "brillig_inverse"])
def test_each_package_reads_the_others_nps(name, tmp_path, zlib_only):
    port, ref = fixture_schemes(name)
    files.write(tmp_path / "port.nps", port)
    jfiles.write(tmp_path / "jax.nps", ref)
    for path in ("port.nps", "jax.nps"):
        assert (tmp_path / path).read_bytes()[20] == 0x78  # a zlib stream
    same_scheme(port, jfiles.read(tmp_path / "port.nps"))
    same_scheme(files.read(tmp_path / "jax.nps", device=CPU), ref)


def test_each_package_reads_the_others_np(tmp_path, zlib_only):
    transcript = bytes(range(256)) * 3
    files.write(tmp_path / "port.np", NoirProof(transcript=transcript))
    jfiles.write(tmp_path / "jax.np", JProof(transcript=transcript))
    assert (tmp_path / "port.np").read_bytes() == \
        (tmp_path / "jax.np").read_bytes()
    assert jfiles.read(tmp_path / "port.np").transcript == transcript
    assert files.read(tmp_path / "jax.np").transcript == transcript


# -- the binary body ------------------------------------------------------------


def test_binenc_matches_jax_on_every_node_kind():
    from provekit_tpu.io import binenc as jbinenc
    from provekit_tpu_torch.io import binenc
    rows = [0, 1, 2**32 - 1, 7]
    doc = {"none": None, "flags": [True, False], "small": [0, 63, 64, -1,
           -64, -65, 2**62 - 1, -(2**62)], "big": [2**62, -(2**62) - 1,
           F.P - 1, 2**300], "float": 2.5, "text": ["", "é" * 70, "k" * 200],
           "bytes": b"\x00\xff" * 40, "u32": binenc.U32Array(rows),
           "tuple": (1, "a"), "nested": {"a": [[], {}], 5: "int key"}}
    jdoc = dict(doc, u32=jbinenc.U32Array(rows))
    body = binenc.encode(doc)
    assert body == jbinenc.encode(jdoc)
    back = binenc.decode(body)
    assert back["u32"].tolist() == rows
    assert binenc.encode(back) == body
    assert back["tuple"] == [1, "a"] and back["big"] == doc["big"]
    for bad, match in ((body[:-1], "truncated"), (body[:40], "truncated"),
                       (body + b"\x00", "trailing"),
                       (binenc.MAGIC + b"\x7f", "unknown binary tag"),
                       (b"PKB0" + body[4:], "not a provekit-tpu"),
                       (binenc.MAGIC + b"\x03" + b"\xff" * 20, "too long")):
        with pytest.raises(ValueError, match=match):
            binenc.decode(bad)
        with pytest.raises(ValueError, match=match):
            jbinenc.decode(bad)


# -- header gates ---------------------------------------------------------------


def test_bad_magic_version_and_format(tmp_path):
    path = tmp_path / "x.np"
    files.write(path, NoirProof(transcript=b"abc"))
    blob = path.read_bytes()
    assert blob[:8] == b"\xDC\xDFOZkp\x01\x00" and blob[8:16] == b"NPSProof"
    assert blob[16:20] == bytes([1, 0, 0, 0])
    cases = {"magic": b"XXXXXXXX" + blob[8:],
             "version": blob[:16] + bytes([9]) + blob[17:],
             "format": blob[:12] + bytes([blob[12] ^ 0xFF]) + blob[13:]}
    for match, bad in cases.items():
        (tmp_path / "bad.np").write_bytes(bad)
        with pytest.raises(ValueError, match=match):
            files.read(tmp_path / "bad.np")
        with pytest.raises(ValueError, match=match):
            jfiles.read(tmp_path / "bad.np")


def test_legacy_header_proof_read(tmp_path):
    transcript = b"\x07" * 40 + b"legacy-read-check"
    cur = tmp_path / "cur.np"
    files.write(cur, NoirProof(transcript=transcript))
    compressed = cur.read_bytes()[20:]
    legacy = tmp_path / "legacy_bin.np"
    legacy.write_bytes(b"PKTPU\x00\x02\x00" + bytes([1, 0]) + compressed)
    assert files.read(legacy).transcript == transcript
    doc = {"format": "NPSProof", "transcript": transcript.hex()}
    old = tmp_path / "legacy_json.np"
    old.write_bytes(b"PKTPU\x00\x02\x00" + bytes([0, 9])
                    + zlib.compress(json.dumps(doc).encode()))
    assert files.read(old).transcript == transcript
    for bad in (b"PKTPU\x00\x09\x00" + bytes([1, 0]) + compressed,
                b"PKTPU\x00\x02\x00" + bytes([2, 0]) + compressed):
        (tmp_path / "bad.np").write_bytes(bad)
        with pytest.raises(ValueError):
            files.read(tmp_path / "bad.np")


def test_zstd_body_without_zstandard_is_a_clear_error(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    path = tmp_path / "jax.np"
    jfiles.write(path, JProof(transcript=b"zstd-body"))
    assert path.read_bytes()[20:24] == b"\x28\xb5\x2f\xfd"
    assert files.read(path).transcript == b"zstd-body"
    monkeypatch.setattr(files, "_zstd", None)
    with pytest.raises(ValueError, match="zstandard"):
        files.read(path)


# -- the CLI --------------------------------------------------------------------


def square_program():
    """tests/test_files.py::test_cli_prove_from_toml's circuit: w1 = w0^2
    computed by Brillig and constrained by one product."""
    D = B.MemoryAddress.direct
    w = acir.Witness
    square_code = B.BrilligBytecode(bytecode=[
        B.Const(D(10), 32, 1), B.Const(D(11), 32, 0),
        B.CalldataCopy(D(1), D(10), D(11)),
        B.BinaryFieldOp(D(2), "Mul", D(1), D(1)),
        B.Const(D(5), 32, 2), B.Const(D(6), 32, 1),
        B.Stop(B.HeapVector(pointer=D(5), size=D(6)))])
    c = acir.Circuit(opcodes=[
        acir.BrilligCall(
            id=0,
            inputs=[acir.BrilligInputSingle(acir.Expression.from_witness(w(0)))],
            outputs=[acir.BrilligOutputSimple(w(1))]),
        acir.AssertZero(acir.Expression(
            mul_terms=[(1, w(0), w(0))],
            linear_combinations=[(F.P - 1, w(1))])),
    ], private_parameters=[0])
    return acir.Program(functions=[c], unconstrained_functions=[square_code])


def test_cli_prove_from_toml(tmp_path, capsys):
    abi = Abi(parameters=[AbiParameter("x", {"kind": "field"})])
    circ = tmp_path / "circuit.json"
    circ.write_text(json.dumps({"program": files._enc(square_program()),
                                "abi": files._enc(abi)}))
    toml = tmp_path / "Prover.toml"
    toml.write_text(chip_smoke.prover_toml({"x": 11}))
    nps, np_ = tmp_path / "scheme.nps", tmp_path / "proof.np"
    cpu = ["--device", "cpu"]
    cli.main(["prepare", str(circ), "-o", str(nps), "--security", "30",
              "--max-pow-bits", "6", *cpu])
    cli.main(["prove", str(nps), str(toml), "-o", str(np_), "--verify", *cpu])
    cli.main(["verify", str(nps), str(np_), *cpu])
    out = capsys.readouterr().out
    assert "self-verify: OK" in out and "verification: OK" in out
    assert "├─ read_nps" in out or "└─ read_nps" in out
    scheme = files.read(nps, device=CPU)
    assert scheme.generate_witness(toml.read_text()) == {0: 11, 1: 121}
    # the JAX package's CLI verifies the port's files
    jcli.main(["verify", str(nps), str(np_)])


def test_entry_points_ask_for_the_card(tmp_path):
    assert inspect.signature(files.read).parameters["device"].default == \
        "cuda"
    assert inspect.signature(
        NoirProofScheme.from_program).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    port, _ = fixture_schemes("mul_chain")
    nps = tmp_path / "scheme.nps"
    files.write(nps, port)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        files.read(nps)
    for argv in (["prepare", str(FIXTURES / "mul_chain.json"), "-o",
                  str(tmp_path / "x.nps")],
                 ["verify", str(nps), str(tmp_path / "none.np")]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        server.main(["--scheme", str(nps), "--port", "0"])
