"""contrib optimizers: the deprecated scale-aware `FusedAdam`, and the
ZeRO-style distributed optimizers (`DistributedFusedAdam`,
`DistributedFusedLAMB`, their transforms and states), which shard the
masters and moments over the data axis.
"""

from rocm_apex_tpu_torch.contrib.optimizers.distributed import (  # noqa: F401
    DistributedAdamState,
    DistributedFusedAdam,
    DistributedFusedLAMB,
    DistributedLAMBState,
    distributed_fused_adam,
    distributed_fused_lamb,
)
from rocm_apex_tpu_torch.contrib.optimizers.fused_adam import (  # noqa: F401
    FusedAdam,
)

__all__ = [
    "FusedAdam",
    "DistributedFusedAdam",
    "DistributedFusedLAMB",
    "DistributedAdamState",
    "DistributedLAMBState",
    "distributed_fused_adam",
    "distributed_fused_lamb",
]
