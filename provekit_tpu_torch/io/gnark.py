"""Gnark recursive-verifier config export.

Port of ``provekit_tpu/io/gnark.py``.

Mirrors ``tooling/provekit-gnark/src/gnark_config.rs:11-149``: serializes the
two WHIR configs, scheme shape, IO pattern and transcript into the
``params_for_recursive_verifier`` JSON, plus the ``r1cs.json`` matrix dump.
Schemas are pinned by the Go verifier:

* config: ``recursive-verifier/app/circuit/types.go:88-99`` (including the
  ``witness_statement_evaluations`` / ``blinding_statement_evaluations``
  deferred-value fields).
* r1cs.json: the Rust serde layout of ``provekit_common::R1CS``
  (``common/src/r1cs.rs:8-14``, ``sparse_matrix.rs:12-27``: CSR with
  ``new_row_indices``/``col_indices``/``values``; interner values as a hex
  string of the ark-compressed ``Vec<Fr>`` — ``utils/serde_ark.rs:11-31``)
  as consumed by ``matrix_evaluation.go:9-33`` / ``common.go:109``.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..fields import bn254 as F
from ..protocol import WhirR1CSScheme
from ..r1cs import R1CS
from ..whir import WhirConfig
from ..whir.hints import deserialize_scalar_vec


def whir_config_gnark(config: WhirConfig) -> dict:
    d = config.describe()
    return {
        "n_rounds": d["n_rounds"],
        "rate": d["rate"],
        "n_vars": d["n_vars"],
        "folding_factor": d["folding_factor"],
        "ood_samples": d["ood_samples"],
        "num_queries": d["num_queries"],
        "pow_bits": d["pow_bits"],
        "final_queries": d["final_queries"],
        "final_pow_bits": d["final_pow_bits"],
        "final_folding_pow_bits": d["final_folding_pow_bits"],
        "domain_generator": d["domain_generator"],
        "batch_size": d["batch_size"],
    }


def _deferred_from_transcript(scheme: WhirR1CSScheme,
                              transcript: bytes) -> tuple[list, list]:
    """Extract the two deferred_weight_evaluations hints from a proof.

    Walks the declared IO pattern over the NARG bytes (the hint framing is
    u32-LE length + body) and returns (blinding_evals, witness_evals)."""
    io = scheme.create_io_pattern()
    pos = 0
    deferred = []
    for op in io.ops:
        if op.kind == "A":
            # pow-nonce absorbs raw wire bytes (spongefish-pow framing)
            pos += op.count if op.label == "pow-nonce" else 32 * op.count
        elif op.kind == "H":
            n = int.from_bytes(transcript[pos:pos + 4], "little")
            body = transcript[pos + 4:pos + 4 + n]
            pos += 4 + n
            if op.label == "deferred_weight_evaluations":
                deferred.append(deserialize_scalar_vec(body))
    if len(deferred) != 2:
        raise ValueError("expected two deferred_weight_evaluations hints")
    return deferred[0], deferred[1]


def gnark_parameters(scheme: WhirR1CSScheme, transcript: bytes,
                     io_pattern: bytes) -> dict:
    blinding_evals, witness_evals = _deferred_from_transcript(
        scheme, transcript)
    return {
        "whir_config_witness": whir_config_gnark(scheme.whir_witness),
        "whir_config_hiding_spartan":
            whir_config_gnark(scheme.whir_for_hiding_spartan),
        "log_num_constraints": scheme.m_0,
        "log_num_variables": scheme.m,
        "log_a_num_terms": scheme.a_num_terms,
        "io_pattern": io_pattern.decode("utf-8", errors="replace"),
        "transcript": list(transcript),
        "transcript_len": len(transcript),
        "witness_statement_evaluations": [str(v) for v in witness_evals],
        "blinding_statement_evaluations": [str(v) for v in blinding_evals],
    }


def _interner_hex(values: list[int]) -> str:
    """hex(ark-compressed Vec<Fr>): u64 LE count + 32-byte LE scalars."""
    out = bytearray(len(values).to_bytes(8, "little"))
    for v in values:
        out += F.to_bytes_le(v)
    return out.hex()


def _matrix_csr(m) -> dict:
    """COO -> the Rust SparseMatrix serde layout (CSR, row-sorted)."""
    order = sorted(range(len(m.rows)), key=lambda i: (m.rows[i], m.cols[i]))
    new_row_indices = []
    col_indices, values = [], []
    next_row = 0
    for k, i in enumerate(order):
        while next_row <= m.rows[i]:
            new_row_indices.append(k)
            next_row += 1
        col_indices.append(m.cols[i])
        values.append(m.value_ids[i])
    while next_row < m.num_rows:
        new_row_indices.append(len(order))
        next_row += 1
    return {
        "num_rows": m.num_rows,
        "num_cols": m.num_cols,
        "new_row_indices": new_row_indices,
        "col_indices": col_indices,
        "values": values,
    }


def r1cs_to_gnark_json(r1cs: R1CS) -> dict:
    """serde_json(provekit_common::R1CS) mirror (r1cs.rs:8-14)."""
    return {
        "num_public_inputs": r1cs.num_public_inputs,
        "interner": {"values": _interner_hex(list(r1cs.interner.values))},
        "a": _matrix_csr(r1cs.a),
        "b": _matrix_csr(r1cs.b),
        "c": _matrix_csr(r1cs.c),
    }


def write_gnark_inputs(scheme: WhirR1CSScheme, r1cs: R1CS, transcript: bytes,
                       io_pattern: bytes, params_path, r1cs_path) -> None:
    Path(params_path).write_text(
        json.dumps(gnark_parameters(scheme, transcript, io_pattern)))
    Path(r1cs_path).write_text(json.dumps(r1cs_to_gnark_json(r1cs)))
