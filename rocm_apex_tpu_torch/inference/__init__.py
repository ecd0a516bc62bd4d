"""Serving tier: the KV caches (contiguous and paged), sampling and the
continuous-batching engine (chunked prefill)."""

from rocm_apex_tpu_torch.inference.engine import (  # noqa: F401
    FINISH_REASONS,
    GenerationResult,
    InferenceEngine,
    Request,
    SamplingParams,
)
from rocm_apex_tpu_torch.inference.kv_cache import KVCache  # noqa: F401
from rocm_apex_tpu_torch.inference.paging import (  # noqa: F401
    PageAllocator,
    PagedKVCache,
    PrefixStore,
)
from rocm_apex_tpu_torch.inference.sampling import (  # noqa: F401
    greedy,
    sample,
    top_k_logits,
    top_p_logits,
)

__all__ = [
    "FINISH_REASONS",
    "GenerationResult",
    "InferenceEngine",
    "KVCache",
    "PageAllocator",
    "PagedKVCache",
    "PrefixStore",
    "Request",
    "SamplingParams",
    "greedy",
    "sample",
    "top_k_logits",
    "top_p_logits",
]
