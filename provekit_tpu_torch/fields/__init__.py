from . import bn254, vector, wide

__all__ = ["bn254", "vector", "wide"]
