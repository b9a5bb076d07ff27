"""provekit-tpu-torch CLI: prepare | prove | verify | circuit-stats |
generate-gnark-inputs | recursive-verify.

Port of ``provekit_tpu/cli.py`` (the reference binary's subcommands,
``tooling/cli/src/cmd/mod.rs:22-28``).  Circuits are accepted as Noir build
artifacts (JSON with base64 bytecode; parsed by ``acir.parse``) or as
provekit-tpu circuit JSON.  ``prove`` accepts either a ``Prover.toml`` input
file (executed by the in-tree ACVM/Brillig VM, like the reference's
``nargo::ops::execute_program`` path) or a JSON map of ACIR witness index to
value (precomputed ``nargo execute`` output).

Every command runs on the CUDA card unless ``--device cpu`` asks for the
CPU; without a card and without that option it raises.  The gnark export
and the Groth16 wrap are host code; their commands read the scheme for the
device all the same.

Run as ``python -m provekit_tpu_torch.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _load_circuit_program(path: str):
    """Returns (program, abi-or-None)."""
    from .io.files import _dec
    doc = json.loads(Path(path).read_text())
    if "bytecode" in doc:
        from .acir.abi import Abi
        from .acir.parse import parse_artifact
        abi = Abi.from_json(doc["abi"]) if doc.get("abi") else None
        return parse_artifact(doc), abi
    if "program" in doc:
        return _dec(doc["program"]), _dec(doc.get("abi"))
    raise SystemExit(f"{path}: not a recognized circuit artifact")


def _load_witness(path: str) -> dict[int, int]:
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, list):
        return {i: int(v, 0) if isinstance(v, str) else int(v)
                for i, v in enumerate(doc)}
    return {int(k): int(v, 0) if isinstance(v, str) else int(v)
            for k, v in doc.items()}


def cmd_prepare(args):
    from .compiler import NoirProofScheme
    from .io import files
    from .utils.profiling import GLOBAL, span
    device = files.require_device(args.device)
    program, abi = _load_circuit_program(args.circuit)
    with span("prepare"):
        with span("noir_to_r1cs"):
            scheme = NoirProofScheme.from_program(
                program, security_level=args.security,
                max_pow_bits=args.max_pow_bits, abi=abi, device=device)
        with span("write_nps"):
            files.write(args.output, scheme)
    print(GLOBAL.report())
    r = scheme.r1cs
    print(f"R1CS: {r.num_constraints} constraints, {r.num_witnesses} "
          f"witnesses, nnz a/b/c = {r.a.nnz}/{r.b.nnz}/{r.c.nnz}")
    print(f"wrote {args.output}")


def cmd_prove(args):
    from .io import files
    from .utils.profiling import GLOBAL, span
    with span("prove"):
        with span("read_nps"):
            scheme = files.read(args.scheme, device=args.device)
        with span("read_witness"):
            if args.witness.endswith(".toml"):
                acir_values = scheme.generate_witness(
                    Path(args.witness).read_text())
            else:
                acir_values = _load_witness(args.witness)
        with span("prove_r1cs"):
            proof = scheme.prove(acir_values)
        with span("write_np"):
            files.write(args.output, proof)
    print(GLOBAL.report())
    print(f"wrote {args.output} ({len(proof.transcript)} transcript bytes)")
    if args.verify:
        scheme.verify(proof)
        print("self-verify: OK")


def cmd_verify(args):
    from .io import files
    from .utils.profiling import GLOBAL, span
    with span("verify"):
        scheme = files.read(args.scheme, device=args.device)
        proof = files.read(args.proof)
        scheme.verify(proof)
    print(GLOBAL.report())
    print("verification: OK")


def cmd_circuit_stats(args):
    """Static analyzer (reference circuit_stats.rs:63-664): blackbox variant
    histograms, AND/XOR bit widths + input classes, RANGE bits, memory-op
    ordering, projected R1CS — plus (with --compile) the ACTUAL compiled
    R1CS sizes, which the reference's projection-only analyzer lacks."""
    from collections import Counter
    from .compiler import circuit_stats as cs
    program, _abi = _load_circuit_program(args.circuit)
    circuit = program.functions[0]
    kinds = Counter(type(op).__name__ for op in circuit.opcodes)
    print(f"opcodes: {sum(kinds.values())}")
    for k, v in sorted(kinds.items()):
        print(f"  {k:<24} {v}")
    stats = cs.analyze(circuit)
    print(cs.report(stats))
    if args.json:
        stats_doc = {k: ({str(kk): vv for kk, vv in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in stats.items()}
        Path(args.json).write_text(json.dumps(stats_doc, indent=1))
        print(f"wrote {args.json}")
    if args.compile:
        from .compiler import NoirProofScheme
        from .io import files
        scheme = NoirProofScheme.from_program(
            program, device=files.require_device(args.device))
        r = scheme.r1cs
        print(f"compiled R1CS: {r.num_constraints} constraints, "
              f"{r.num_witnesses} witnesses, "
              f"nnz={r.a.nnz + r.b.nnz + r.c.nnz}")


def cmd_generate_gnark_inputs(args):
    from .io import files
    from .io.gnark import write_gnark_inputs
    from .utils.profiling import GLOBAL, span
    device = files.require_device(args.device)
    with span("generate_gnark_inputs"):
        with span("read_nps"):
            scheme = files.read(args.scheme, device=device)
            proof = files.read(args.proof)
        io_pattern = scheme.whir_for_witness.create_io_pattern().as_bytes()
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with span("write_gnark_inputs"):
            write_gnark_inputs(
                scheme.whir_for_witness, scheme.r1cs, proof.transcript,
                io_pattern, out / "params_for_recursive_verifier",
                out / "r1cs.json")
    print(GLOBAL.report())
    print(f"wrote {out}/params_for_recursive_verifier and {out}/r1cs.json")


def cmd_recursive_verify(args):
    """Wrap a .np proof in Groth16 (the reference's Go recursive-verifier
    CLI flow: build circuit, setup or load cached keys, prove, verify —
    recursive-verifier/cmd/cli/main.go:15-120, app/circuit/common.go)."""
    import pickle
    from .io import files
    from .recursion import wrap
    from .utils.profiling import GLOBAL, span
    device = files.require_device(args.device)
    scheme = files.read(args.scheme, device=device)
    proof = files.read(args.proof)
    inner = scheme.whir_for_witness
    keys_path = Path(args.keys) if args.keys else None
    rk = None
    if keys_path and keys_path.exists():
        with span("load_keys"):
            rk = pickle.loads(keys_path.read_bytes())
    if rk is None:
        with span("groth16_setup"):
            rk = wrap.setup(inner, scheme.r1cs, proof.transcript)
        if keys_path:
            keys_path.write_bytes(pickle.dumps(rk))
    with span("groth16_prove"):
        g16, publics = wrap.prove(rk, inner, scheme.r1cs, proof.transcript)
    with span("groth16_verify"):
        ok = wrap.verify(rk, g16, publics)
    print(GLOBAL.report())
    if not ok:
        raise SystemExit("recursive verification FAILED")
    w = rk.wrapper_r1cs
    print(f"recursive verification: OK "
          f"({w.num_constraints} wrapper constraints, {w.num_witnesses} "
          f"wires, {len(publics)} public inputs)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="provekit-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_option(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")

    sp = sub.add_parser("prepare", help="compile a circuit to a .nps scheme")
    sp.add_argument("circuit")
    sp.add_argument("-o", "--output", default="scheme.nps")
    sp.add_argument("--security", type=int, default=128)
    sp.add_argument("--max-pow-bits", type=int, default=None,
                    help="grinding cap; default: reference default_max_pow")
    device_option(sp)
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("prove", help="prove a .nps scheme with a witness")
    sp.add_argument("scheme")
    sp.add_argument("witness")
    sp.add_argument("-o", "--output", default="proof.np")
    sp.add_argument("--verify", action="store_true",
                    help="verify the proof after proving")
    device_option(sp)
    sp.set_defaults(fn=cmd_prove)

    sp = sub.add_parser("verify", help="verify a .np proof")
    sp.add_argument("scheme")
    sp.add_argument("proof")
    device_option(sp)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("circuit-stats", help="analyze a circuit artifact")
    sp.add_argument("circuit")
    sp.add_argument("--json", help="also write the stats as JSON")
    sp.add_argument("--compile", action="store_true",
                    help="additionally compile and print actual R1CS sizes")
    device_option(sp)
    sp.set_defaults(fn=cmd_circuit_stats)

    sp = sub.add_parser("generate-gnark-inputs",
                        help="export recursive-verifier inputs")
    sp.add_argument("scheme")
    sp.add_argument("proof")
    sp.add_argument("-o", "--output-dir", default="gnark-inputs")
    device_option(sp)
    sp.set_defaults(fn=cmd_generate_gnark_inputs)

    sp = sub.add_parser("recursive-verify",
                        help="wrap a proof in Groth16 and verify it")
    sp.add_argument("scheme")
    sp.add_argument("proof")
    sp.add_argument("--keys", help="Groth16 key cache path "
                    "(created on first run, like the reference's --ccs)")
    device_option(sp)
    sp.set_defaults(fn=cmd_recursive_verify)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
