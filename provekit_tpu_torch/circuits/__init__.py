from . import poseidon, sha256

__all__ = ["poseidon", "sha256"]
