"""NoirProofScheme: the compiled artifact (circuit + R1CS + witness program).

Port of ``provekit_tpu/compiler/scheme.py`` (reference
``provekit/common/src/noir_proof_scheme.rs`` and the prove flow of
``provekit/prover/src/noir_proof_scheme.rs``): a separate witness sponge
("📜") absorbs the circuit shape and public inputs and supplies the
challenges drawn during witness solving; the main proof then runs the
WhirR1CSScheme over the solved witness on the scheme's device (the card
unless the caller passes ``device="cpu"``).  The witness solve runs on the
host in the port's native library (``native.solve_witness`` over
``native/encode.py``); ``use_native=False`` runs the Python
``witness_builder.solve``, its plain version.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .. import native
from ..acir import model as acir
from ..fields import bn254 as F
from ..fs import DomainSeparator
from ..native.encode import encode_program
from ..protocol import WhirR1CSScheme
from ..r1cs import R1CS
from ..r1cs import witness_builder as wb
from .noir_to_r1cs import noir_to_r1cs


@dataclass
class NoirProof:
    transcript: bytes


@dataclass
class NoirProofScheme:
    program: acir.Program
    r1cs: R1CS
    acir_map: dict[int, int]
    witness_builders: list
    whir_for_witness: WhirR1CSScheme
    abi: object = None  # acir.abi.Abi when compiled from a Noir artifact

    @classmethod
    def from_program(cls, program: acir.Program, security_level: int = 128,
                     max_pow_bits: int | None = None, abi=None, *,
                     device="cuda") -> "NoirProofScheme":
        assert len(program.functions) == 1, "only one ACIR function supported"
        circuit = program.functions[0]
        r1cs, acir_map, builders = noir_to_r1cs(circuit)
        scheme = WhirR1CSScheme.new_for_r1cs(
            r1cs, security_level=security_level, max_pow_bits=max_pow_bits,
            device=device)
        return cls(program=program, r1cs=r1cs, acir_map=acir_map,
                   witness_builders=builders, whir_for_witness=scheme,
                   abi=abi)

    @property
    def circuit(self) -> acir.Circuit:
        return self.program.functions[0]

    # -- witness sponge ----------------------------------------------------

    def create_witness_io_pattern(self) -> DomainSeparator:
        ds = DomainSeparator("📜")
        ds.absorb(2, "shape")
        n_pub = len(self.circuit.public_inputs())
        if n_pub:
            ds.absorb(n_pub, "public_inputs")
        for _ in range(wb.num_challenges(self.witness_builders)):
            ds.squeeze(1, "logup_challenge")
        return ds

    def _witness_seed_scalars(self, acir_values: dict[int, int]) -> list[int]:
        """What the witness sponge absorbs before the solve: the shape,
        then the public inputs."""
        seeds = [self.r1cs.num_constraints % F.P,
                 self.r1cs.num_witnesses % F.P]
        seeds += [acir_values[i] % F.P for i in self.circuit.public_inputs()]
        return seeds

    def _seed_witness_sponge(self, tr, acir_values: dict[int, int]) -> None:
        seeds = self._witness_seed_scalars(acir_values)
        tr.add_scalars(seeds[:2])
        if seeds[2:]:
            tr.add_scalars(seeds[2:])

    # -- solve / prove / verify -------------------------------------------

    def solve_witness(self, acir_values: dict[int, int], rng=None,
                      use_native: bool = True) -> list[int]:
        ds = self.create_witness_io_pattern()
        if use_native:
            partial = native.solve_witness(
                encode_program(self.witness_builders), acir_values,
                self.r1cs.num_witnesses, ds.iv(),
                self._witness_seed_scalars(acir_values))
        else:
            tr = ds.to_prover_state()
            self._seed_witness_sponge(tr, acir_values)
            partial = wb.solve(self.witness_builders, acir_values,
                               self.r1cs.num_witnesses, tr)
        rng = rng if rng is not None else secrets.SystemRandom()
        return wb.fill_witness(partial, rng)

    def prove(self, acir_values: dict[int, int], rng=None) -> NoirProof:
        witness = self.solve_witness(acir_values, rng)
        transcript = self.whir_for_witness.prove(self.r1cs, witness, rng)
        return NoirProof(transcript=transcript)

    def verify(self, proof: NoirProof) -> None:
        self.whir_for_witness.verify(self.r1cs, proof.transcript)

    # -- witness generation (in-tree ACVM/Brillig) --------------------------

    def generate_witness(self, inputs, foreign_handler=None) -> dict[int, int]:
        """Execute the ACIR program to the full witness map.

        ``inputs`` is either Prover.toml text, a flattened list of field
        values in ABI order, or an already-initial witness dict (the
        reference's ``nargo::ops::execute_program`` call, in tree).
        """
        from ..acir import execute as acvm
        if isinstance(inputs, dict):
            initial = inputs
        else:
            if isinstance(inputs, str):
                from ..acir.abi import input_from_toml
                if self.abi is None:
                    raise ValueError(
                        "TOML inputs need an ABI; attach one via scheme.abi "
                        "or pass a flattened input list")
                inputs = input_from_toml(self.abi, inputs)
            initial = acvm.initial_witness_from_inputs(self.circuit, inputs)
        return acvm.execute_program(self.program, initial, foreign_handler)
