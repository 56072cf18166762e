"""Several sequences at once: the replica-fused batched driver on one card
(``batched``), multi-bag replay (``replay``) and device grids (``mesh``)."""
from . import batched, mesh, replay

__all__ = ["batched", "mesh", "replay"]
