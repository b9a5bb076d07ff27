from . import poseidon

__all__ = ["poseidon"]
