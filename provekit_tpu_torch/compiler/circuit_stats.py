"""Static ACIR circuit analyzer (the ``circuit-stats`` subcommand).

Port of ``provekit_tpu/compiler/circuit_stats.py``.

Python counterpart of the reference's analyzer
(``tooling/cli/src/cmd/circuit_stats.rs:63-664``): opcode and blackbox
variant histograms, AND/XOR input bit-width tables and constant/witness
input classes, RANGE bit-width histogram, memory-op ordering (write-after-
read detection), Brillig/Call counts, and a projected R1CS size from
per-gadget cost formulas.  ``analyze`` returns a structured dict;
``report`` renders it as text.
"""

from __future__ import annotations

from collections import Counter

from ..acir import model as acir

# Reference per-gadget projections (circuit_stats.rs:630-646): the analyzer
# estimates blackbox costs with fixed constants measured on the reference
# gadget implementations.
SHA256_COMPRESSION_CONSTRAINTS = 31264
SHA256_COMPRESSION_WITNESSES = 30959
POSEIDON2_CONSTRAINTS = 415
POSEIDON2_WITNESSES = 417

# Blackbox names the reference tracks (circuit_stats.rs:90-113).
BLACKBOX_NAMES = [
    "AES128Encrypt", "AND", "XOR", "RANGE", "Blake2s", "Blake3",
    "EcdsaSecp256k1", "EcdsaSecp256r1", "MultiScalarMul", "EmbeddedCurveAdd",
    "Keccakf1600", "RecursiveAggregation", "BigIntAdd", "BigIntSub",
    "BigIntMul", "BigIntDiv", "BigIntFromLeBytes", "BigIntToLeBytes",
    "Poseidon2Permutation", "Sha256Compression",
]


def _input_class(lhs: acir.FunctionInput, rhs: acir.FunctionInput) -> str:
    lc, rc = lhs.is_constant(), rhs.is_constant()
    if lc and rc:
        return "homogeneous_constant"
    if not lc and not rc:
        return "homogeneous_witness"
    return "heterogeneous"


def _expr_key(e: acir.Expression):
    """Hashable identity of an index Expression (for read/write tracking)."""
    return (tuple((c, a.index, b.index) for c, a, b in e.mul_terms),
            tuple((c, w.index) for c, w in e.linear_combinations), e.q_c)


def analyze(circuit: acir.Circuit) -> dict:
    """Single pass over the opcodes (circuit_stats.rs:152-538)."""
    blackbox = Counter()
    and_bits = Counter()      # (lhs_bits, rhs_bits) -> count
    xor_bits = Counter()
    and_classes = Counter()   # homogeneous_witness / _constant / heterogeneous
    xor_classes = Counter()
    range_bits = Counter()    # num_bits -> count

    mem_reads = mem_writes = mem_inits = mem_alloc_total = 0
    read_locs: set = set()
    write_after_read: list = []
    all_reads_after_writes = True

    num_assert_zero = 0
    num_mul_terms = 0
    brillig_calls = 0
    unique_brillig: set = set()
    unsupported = Counter()

    for op in circuit.opcodes:
        if isinstance(op, acir.AssertZero):
            num_assert_zero += 1
            num_mul_terms += len(op.expr.mul_terms)
        elif isinstance(op, acir.BlackBoxAnd):
            blackbox["AND"] += 1
            and_bits[(op.lhs.num_bits, op.rhs.num_bits)] += 1
            and_classes[_input_class(op.lhs, op.rhs)] += 1
        elif isinstance(op, acir.BlackBoxXor):
            blackbox["XOR"] += 1
            xor_bits[(op.lhs.num_bits, op.rhs.num_bits)] += 1
            xor_classes[_input_class(op.lhs, op.rhs)] += 1
        elif isinstance(op, acir.BlackBoxRange):
            blackbox["RANGE"] += 1
            range_bits[op.input.num_bits] += 1
        elif isinstance(op, acir.MemoryInit):
            mem_inits += 1
            mem_alloc_total += len(op.init)
        elif isinstance(op, acir.MemoryOp):
            key = (op.block_id, _expr_key(op.op.index))
            if op.op.operation == 0:
                mem_reads += 1
                read_locs.add(key)
            else:
                mem_writes += 1
                if key in read_locs:
                    all_reads_after_writes = False
                    write_after_read.append(op.block_id)
        elif isinstance(op, acir.BrilligCall):
            brillig_calls += 1
            unique_brillig.add(op.id)
        elif isinstance(op, acir.BlackBoxUnsupported):
            blackbox[op.name] += 1
            unsupported[op.name] += 1

    # --- projected R1CS (circuit_stats.rs:620-663) -------------------------
    projections = []
    rows = num_assert_zero + num_mul_terms
    wits = 0
    projections.append(("AssertZero", rows, 0))
    if blackbox["Sha256Compression"]:
        k = blackbox["Sha256Compression"]
        projections.append(("Sha256Compression",
                            SHA256_COMPRESSION_CONSTRAINTS * k,
                            SHA256_COMPRESSION_WITNESSES * k))
    if blackbox["Poseidon2Permutation"]:
        k = blackbox["Poseidon2Permutation"]
        projections.append(("Poseidon2Permutation",
                            POSEIDON2_CONSTRAINTS * k,
                            POSEIDON2_WITNESSES * k))
    rc_rows = sum(2 * v for v in range_bits.values())
    rc_wits = sum(k * v for k, v in range_bits.items())
    if rc_rows:
        projections.append(("range checks", rc_rows, rc_wits))
    rows = sum(r for _, r, _ in projections)
    wits = sum(w for _, _, w in projections)

    return {
        "private_inputs": len(circuit.private_parameters),
        "public_inputs": len(circuit.public_parameters),
        "return_values": len(circuit.return_values),
        "num_assert_zero": num_assert_zero,
        "num_mul_terms": num_mul_terms,
        "blackbox": {k: v for k, v in blackbox.items() if v},
        "and_bit_counts": dict(and_bits),
        "xor_bit_counts": dict(xor_bits),
        "and_input_classes": dict(and_classes),
        "xor_input_classes": dict(xor_classes),
        "range_bit_counts": dict(range_bits),
        "mem_inits": mem_inits,
        "mem_alloc_total": mem_alloc_total,
        "mem_reads": mem_reads,
        "mem_writes": mem_writes,
        "read_only": all_reads_after_writes,
        "write_after_read_blocks": sorted(set(write_after_read)),
        "brillig_calls": brillig_calls,
        "unique_brillig_functions": len(unique_brillig),
        "unsupported_blackbox": dict(unsupported),
        "projections": projections,
        "projected_constraints": rows,
        "projected_witnesses": wits,
    }


def report(stats: dict) -> str:
    """Text rendering in the reference's print order."""
    import math
    lines = []
    put = lines.append
    put(f"Private inputs len: {stats['private_inputs']}")
    put(f"Public inputs len:  {stats['public_inputs']}")
    put(f"Return values len:  {stats['return_values']}")
    put(f"Num AssertZero: {stats['num_assert_zero']}")
    put(f"Num mul_terms:  {stats['num_mul_terms']}")
    for k, v in sorted(stats["blackbox"].items()):
        put(f"Blackbox fn {k}: {v}")
    for k, v in sorted(stats["range_bit_counts"].items(),
                       key=lambda kv: -kv[1]):
        put(f"RANGE check: {k} bits had {v} lookups")
    for name, bits, classes in (("AND", stats["and_bit_counts"],
                                 stats["and_input_classes"]),
                                ("XOR", stats["xor_bit_counts"],
                                 stats["xor_input_classes"])):
        for (lb, rb), v in sorted(bits.items()):
            put(f"{name} with input dims ({lb}, {rb}): {v} calls")
        for cls, v in sorted(classes.items()):
            put(f"{name} {cls}_inputs_count: {v}")
    put(f"Num Memory inits: {stats['mem_inits']}")
    put(f"Total memory alloc size: {stats['mem_alloc_total']}")
    put(f"Num Memory writes: {stats['mem_writes']}")
    put(f"Num Memory reads: {stats['mem_reads']}")
    put(f"Read-only: {stats['read_only']}")
    for b in stats["write_after_read_blocks"]:
        put(f"  write-after-read in block {b}")
    put(f"Num Brillig calls: {stats['brillig_calls']}")
    put(f"Num unique Brillig functions: {stats['unique_brillig_functions']}")
    for k, v in sorted(stats["unsupported_blackbox"].items()):
        put(f"UNSUPPORTED blackbox {k}: {v}")
    put("-" * 64)
    for name, rows, wits in stats["projections"]:
        put(f"{rows} constraints, {wits} witnesses from {name}")
    pc, pw = stats["projected_constraints"], stats["projected_witnesses"]
    lgc = math.log2(pc) if pc else 0.0
    lgw = math.log2(pw) if pw else 0.0
    put(f"{pc} projected R1CS constraints ({lgc:.2f} num vars)")
    put(f"{pw} projected extra witnesses ({lgw:.2f} num vars)")
    return "\n".join(lines)
