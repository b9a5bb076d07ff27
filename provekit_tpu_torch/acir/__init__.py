from . import abi, model, parse

__all__ = ["abi", "model", "parse"]
