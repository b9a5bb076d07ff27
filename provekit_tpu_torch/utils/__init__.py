from . import profiling

__all__ = ["profiling"]
