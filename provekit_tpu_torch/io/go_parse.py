"""Python mirror of the Go recursive-verifier's input parse.

Port of ``provekit_tpu/io/go_parse.py``.

Field-for-field re-implementation of ``PrepareAndVerifyCircuit``'s parsing
phase (``recursive-verifier/app/circuit/common.go:15-130``) and
``consumeWhirData`` (``utilities.go:245-277``), operating on the EXPORTED
artifacts (``params_for_recursive_verifier`` JSON + ``r1cs.json``) exactly
as the unmodified Go binary would:

1. parse the Config JSON by its Go json tags (``types.go:88-99``);
2. parse the IO-pattern string (gnark-nimue format: NUL-separated ops,
   ``[ASH]<count><label>``);
3. walk the transcript: hints are ``u32-LE length || ark-canonical body``
   dispatched on the op label (``merkle_proof`` -> MultiPath,
   ``stir_answers`` -> Vec<Vec<Fp256>>, ``deferred_weight_evaluations`` ->
   Vec<Fp256>, ``claimed_evaluations`` -> ClaimedEvaluations); absorbs
   advance ``size * 32`` bytes (``size`` bytes for the ``pow-nonce`` label)
   and accumulate the truncated transcript; squeezes consume nothing;
4. hex-decode and ark-deserialize the interner (``common.go:109-119``);
5. distribute openings to the two WHIR instances in Go's consumption order
   (hiding-spartan first: one first-round opening + NRounds round openings
   each — ``common.go:122-124``).

Used by the conformance test to pin the export surface: any drift in
``io/gnark.py`` or the hint wire formats breaks this walk loudly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..whir.hints import (deserialize_claimed_evaluations,
                          deserialize_multipath, deserialize_scalar_vec,
                          deserialize_stir_answers)

CONFIG_KEYS = [
    # json tags of Go Config (types.go:88-99), in struct order
    "whir_config_witness", "whir_config_hiding_spartan",
    "log_num_constraints", "log_num_variables", "log_a_num_terms",
    "io_pattern", "transcript", "transcript_len",
    "witness_statement_evaluations", "blinding_statement_evaluations",
]

WHIR_CONFIG_KEYS = [
    # json tags of Go WHIRConfig (types.go:25-38), in struct order
    "n_rounds", "rate", "n_vars", "folding_factor", "ood_samples",
    "num_queries", "pow_bits", "final_queries", "final_pow_bits",
    "final_folding_pow_bits", "domain_generator", "batch_size",
]


@dataclass
class Op:
    kind: str   # "A" | "S" | "H"
    size: int
    label: str


def parse_io_pattern(pattern: str) -> list[Op]:
    """gnark-nimue IOPattern.Parse: NUL-separated, first part is the domain
    label, then ``<kind><count><label>`` ops (hints have no count)."""
    parts = pattern.split("\x00")
    ops = []
    for part in parts[1:]:
        kind = part[0]
        if kind == "H":
            ops.append(Op("H", 0, part[1:]))
            continue
        i = 1
        while i < len(part) and part[i].isdigit():
            i += 1
        if kind not in "AS" or i == 1:
            raise ValueError(f"malformed io-pattern op {part!r}")
        ops.append(Op(kind, int(part[1:i]), part[i:]))
    return ops


@dataclass
class ParsedTranscript:
    """Everything PrepareAndVerifyCircuit extracts before verifyCircuit."""
    merkle_paths: list = field(default_factory=list)   # (indexes, sibs, paths)
    stir_answers: list = field(default_factory=list)   # [[ [Fp], ... ], ...]
    deferred: list = field(default_factory=list)       # [Fp256]
    claimed_evaluations: tuple = ([], [])              # (f_sums, g_sums)
    truncated: bytes = b""                             # absorbed bytes only


def walk_transcript(ops: list[Op], transcript: bytes) -> ParsedTranscript:
    """The op loop of common.go:30-105."""
    out = ParsedTranscript()
    truncated = bytearray()
    pointer = 0
    for op in ops:
        if op.kind == "H":
            if pointer + 4 > len(transcript):
                raise ValueError("insufficient bytes for hint length")
            hint_len = int.from_bytes(
                transcript[pointer:pointer + 4], "little")
            start = pointer + 4
            end = start + hint_len
            if end > len(transcript):
                raise ValueError("insufficient bytes for hint body")
            body = transcript[start:end]
            if op.label == "merkle_proof":
                out.merkle_paths.append(deserialize_multipath(body))
            elif op.label == "stir_answers":
                out.stir_answers.append(deserialize_stir_answers(body))
            elif op.label == "deferred_weight_evaluations":
                out.deferred.extend(deserialize_scalar_vec(body))
            elif op.label == "claimed_evaluations":
                out.claimed_evaluations = deserialize_claimed_evaluations(body)
            pointer = end
        elif op.kind == "A":
            start = pointer
            if op.label == "pow-nonce":
                pointer += op.size
            else:
                pointer += op.size * 32
            if pointer > len(transcript):
                raise ValueError("absorb exceeds transcript length")
            truncated += transcript[start:pointer]
        # Squeeze consumes no transcript bytes
    if pointer != len(transcript):
        raise ValueError(
            f"{len(transcript) - pointer} unconsumed transcript bytes")
    out.truncated = bytes(truncated)
    return out


def deserialize_interner(hex_values: str) -> list[int]:
    """common.go:109-119: hex string -> ark Vec<Fp256>."""
    return deserialize_scalar_vec(bytes.fromhex(hex_values))


@dataclass
class ZKHint:
    first_round: tuple   # (multipath, stir_answers) or None
    rounds: list         # [(multipath, stir_answers)]


def consume_whir_data(whir_config: dict, merkle_paths: list,
                      stir_answers: list) -> ZKHint:
    """utilities.go:245-277: pop one first-round opening, then up to
    NRounds round openings, from the front of the shared queues."""
    first = None
    if merkle_paths and stir_answers:
        first = (merkle_paths.pop(0), stir_answers.pop(0))
    rounds = []
    for _ in range(whir_config["n_rounds"]):
        if not (merkle_paths and stir_answers):
            break
        rounds.append((merkle_paths.pop(0), stir_answers.pop(0)))
    return ZKHint(first_round=first, rounds=rounds)


def prepare(config: dict, r1cs_doc: dict) -> dict:
    """The full pre-verifyCircuit parse (common.go:15-130).

    Returns the artifacts verifyCircuit receives; raises on any structural
    mismatch a Go run would hit.
    """
    for key in CONFIG_KEYS:
        if key not in config:
            raise ValueError(f"Config missing json field {key!r}")
    for cfg_key in ("whir_config_witness", "whir_config_hiding_spartan"):
        for key in WHIR_CONFIG_KEYS:
            if key not in config[cfg_key]:
                raise ValueError(f"{cfg_key} missing json field {key!r}")

    ops = parse_io_pattern(config["io_pattern"])
    transcript = bytes(config["transcript"])
    if len(transcript) != config["transcript_len"]:
        raise ValueError("transcript_len mismatch")
    parsed = walk_transcript(ops, transcript)

    interner = deserialize_interner(r1cs_doc["interner"]["values"])

    mp = list(parsed.merkle_paths)
    sa = list(parsed.stir_answers)
    hiding = consume_whir_data(config["whir_config_hiding_spartan"], mp, sa)
    witness = consume_whir_data(config["whir_config_witness"], mp, sa)
    if mp or sa:
        raise ValueError(
            f"{len(mp)} merkle paths / {len(sa)} stir answers unconsumed")

    return {
        "parsed": parsed,
        "interner": interner,
        "hiding_spartan_hint": hiding,
        "witness_hint": witness,
    }
