from . import p256, passport, poseidon, sha256

__all__ = ["p256", "passport", "poseidon", "sha256"]
