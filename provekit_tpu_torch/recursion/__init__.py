"""Recursive-verification subsystem: Groth16 wrapping of provekit-tpu proofs.

Port of ``provekit_tpu/recursion/`` (host code: Python ints, with the
multiplications over the curve in the port's own native engine,
``native/curve.cpp``). Counterpart of the reference's Go/gnark recursive
verifier (``recursive-verifier/`` — ~2.4 kLoC Go: gnark circuit + Groth16
setup/prove/verify + CLI/HTTP server, SURVEY §2.9).  Design differences:

* The pairing/Groth16 engine is implemented in-tree over the existing
  ``R1CS`` type (the reference delegates to gnark).
* The verifier circuit is compiled with the same ACIR->R1CS compiler used
  for application circuits, so "recursion" is just another R1CS.
"""

from .curve import G1, G2, g1_generator, g2_generator
from .pairing import pairing
from .groth16 import Groth16Keys, setup, prove, verify
from .builder import LC, CircuitBuilder
