"""The ResNet bottleneck, plain and fused (`FusedBottleneck`, on the
hand-written conv+BN kernels of ``ops.fused_bottleneck``).

`SpatialBottleneck` and `halo_exchange` of the JAX package need process
groups and are not ported yet (ROADMAP.md Queue 1 item 10).
"""

from rocm_apex_tpu_torch.contrib.bottleneck.bottleneck import (
    Bottleneck,
    FusedBottleneck,
)

__all__ = ["Bottleneck", "FusedBottleneck"]
