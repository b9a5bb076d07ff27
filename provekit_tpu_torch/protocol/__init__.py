from .scheme import WhirR1CSScheme
from . import spartan

__all__ = ["WhirR1CSScheme", "spartan"]
