from .noir_to_r1cs import NoirToR1CSCompiler, noir_to_r1cs
from .scheme import NoirProof, NoirProofScheme

__all__ = ["NoirToR1CSCompiler", "noir_to_r1cs", "NoirProof", "NoirProofScheme"]
