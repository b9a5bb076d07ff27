from . import fused, merkle, ntt, pow, sumcheck

__all__ = ["fused", "merkle", "ntt", "pow", "sumcheck"]
