from . import binenc, files

__all__ = ["binenc", "files"]
