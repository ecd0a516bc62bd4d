"""contrib optimizers: the deprecated scale-aware `FusedAdam`.

The JAX package's ``contrib/optimizers`` also holds the ZeRO-style
distributed optimizers (``distributed.py``: `DistributedFusedAdam`,
`DistributedFusedLAMB`). They shard the optimizer state over a data
axis, so they come with the rest of the distributed training stack
(ROADMAP.md Queue 1 item 10) and are not exported here yet.
"""

from rocm_apex_tpu_torch.contrib.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
)

__all__ = ["FusedAdam"]
