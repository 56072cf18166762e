"""Several sequences at once: the replica-fused batched driver on one card
(``batched``), multi-bag replay (``replay``) and device grids (``mesh``);
one sequence point-sharded across ranks (``sharded``)."""
from . import batched, mesh, replay, sharded

__all__ = ["batched", "mesh", "replay", "sharded"]
