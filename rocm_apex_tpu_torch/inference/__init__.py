"""Serving tier: the KV caches (contiguous and paged), sampling, the
continuous-batching engine (chunked prefill, speculative decoding, the
request lifecycle, multi-LoRA, migration, tensor parallelism with
`shard_tp1_params`), the n-gram drafter, the fault plans, the adapter
pool and the multi-replica router."""

from rocm_apex_tpu_torch.inference.adapters import (  # noqa: F401
    BASE_ADAPTER_ID,
    AdapterPool,
)

from rocm_apex_tpu_torch.inference.drafting import NGramDrafter  # noqa: F401

from rocm_apex_tpu_torch.inference.engine import (  # noqa: F401
    FINISH_REASONS,
    GenerationResult,
    InferenceEngine,
    Request,
    SamplingParams,
    shard_tp1_params,
)
from rocm_apex_tpu_torch.inference.faults import (  # noqa: F401
    NO_FAULTS,
    Fault,
    FaultInjected,
    FaultPlan,
)
from rocm_apex_tpu_torch.inference.kv_cache import KVCache  # noqa: F401
from rocm_apex_tpu_torch.inference.paging import (  # noqa: F401
    PageAllocator,
    PagedKVCache,
    PrefixStore,
)
from rocm_apex_tpu_torch.inference.router import (  # noqa: F401
    REPLICA_CLASSES,
    REPLICA_STATES,
    ReplicaRouter,
    SharedPrefixRegistry,
)
from rocm_apex_tpu_torch.inference.sampling import (  # noqa: F401
    greedy,
    sample,
    top_k_logits,
    top_p_logits,
)

__all__ = [
    "AdapterPool",
    "BASE_ADAPTER_ID",
    "FINISH_REASONS",
    "Fault",
    "FaultInjected",
    "FaultPlan",
    "GenerationResult",
    "InferenceEngine",
    "KVCache",
    "NGramDrafter",
    "NO_FAULTS",
    "PageAllocator",
    "PagedKVCache",
    "PrefixStore",
    "REPLICA_CLASSES",
    "REPLICA_STATES",
    "ReplicaRouter",
    "Request",
    "SamplingParams",
    "SharedPrefixRegistry",
    "greedy",
    "sample",
    "shard_tp1_params",
    "top_k_logits",
    "top_p_logits",
]
