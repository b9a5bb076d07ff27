"""provekit-tpu-torch: the PyTorch and CUDA port of provekit_tpu.

The same prover (Noir ACIR -> R1CS -> ZK-Spartan sumcheck -> WHIR polynomial
commitment with the Skyscraper hash over BN254-Fr), written in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).  It emits the same
proof bytes as the JAX package for the same circuit, witness and ``rng``.
It imports neither JAX nor ``provekit_tpu``.
"""

__version__ = "0.1.0"
