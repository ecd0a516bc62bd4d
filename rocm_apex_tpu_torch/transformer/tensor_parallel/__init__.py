"""Tensor-parallel layers, the region mappings, the vocab-parallel
cross-entropy, the seeds (`random`), `broadcast_data` and the memory
buffers, over `parallel_state`'s tensor group."""

from rocm_apex_tpu_torch.ops.linear_xentropy import (
    vocab_parallel_linear_cross_entropy,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.data import (
    broadcast_data,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.memory import (
    MemoryBuffer,
    RingMemBuffer,
    allocate_mem_buff,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel.random import (
    CheckpointPolicy,
    RngStateTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_prng_keys,
    model_parallel_seed,
)

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "copy_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "vocab_parallel_cross_entropy",
    "vocab_parallel_linear_cross_entropy",
    "broadcast_data",
    "MemoryBuffer",
    "RingMemBuffer",
    "allocate_mem_buff",
    "RngStateTracker",
    "get_rng_tracker",
    "get_cuda_rng_tracker",
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",
    "model_parallel_prng_keys",
    "checkpoint",
    "CheckpointPolicy",
]
