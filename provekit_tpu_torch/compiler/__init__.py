from .noir_to_r1cs import NoirToR1CSCompiler, noir_to_r1cs
from .scheme import NoirProof, NoirProofScheme
from . import binops, digits, memory, range_check

__all__ = ["NoirToR1CSCompiler", "noir_to_r1cs", "NoirProof",
           "NoirProofScheme", "binops", "digits", "memory", "range_check"]
