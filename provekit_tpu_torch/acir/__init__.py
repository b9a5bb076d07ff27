from . import model

__all__ = ["model"]
