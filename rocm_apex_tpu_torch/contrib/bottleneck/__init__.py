"""The ResNet bottleneck, plain, fused (`FusedBottleneck`, on the
hand-written conv+BN kernels of ``ops.fused_bottleneck``) and spatially
partitioned (`SpatialBottleneck` over `halo_exchange`).
"""

from rocm_apex_tpu_torch.contrib.bottleneck.bottleneck import (
    Bottleneck,
    FusedBottleneck,
    SpatialBottleneck,
    halo_exchange,
)

__all__ = ["Bottleneck", "FusedBottleneck", "SpatialBottleneck",
           "halo_exchange"]
