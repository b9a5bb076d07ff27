"""The sharded prover: SPMD over ``torch.distributed`` (see
:mod:`.context`).  The six sharded functions are in :mod:`.mesh`, which
imports the ops layer; the ops layer imports :mod:`.context` and
:mod:`.collectives`, so this package imports neither ``mesh`` nor
``ops``."""

from .context import active_mesh, use_mesh
from .launch import Mesh, launch, make_mesh

__all__ = ["Mesh", "make_mesh", "launch", "use_mesh", "active_mesh"]
