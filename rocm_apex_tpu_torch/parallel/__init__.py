"""Data parallelism: gradient synchronization, SyncBatchNorm, LARC.

Port of ``rocm_apex_tpu/parallel`` (the reference's `apex.parallel`):
the sync policy over the data axis's process group (`sync_gradients`,
`DistributedDataParallel`, `Reducer`, `broadcast_params`),
`SyncBatchNorm` and `convert_syncbn_model`, `LARC` and `larc`, and the
one-process-a-rank launcher `multiproc`.
"""

from rocm_apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    broadcast_params,
    sync_gradients,
)
from rocm_apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)
from rocm_apex_tpu_torch.parallel.larc import LARC, larc  # noqa: F401

__all__ = [
    "DistributedDataParallel",
    "Reducer",
    "broadcast_params",
    "sync_gradients",
    "SyncBatchNorm",
    "convert_syncbn_model",
    "LARC",
    "larc",
]
