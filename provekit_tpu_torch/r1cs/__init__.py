from .r1cs import R1CS, Interner, SparseMatrix

__all__ = ["R1CS", "Interner", "SparseMatrix"]
