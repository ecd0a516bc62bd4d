"""Serving tier: the KV caches (contiguous and paged), sampling, the
continuous-batching engine (chunked prefill, speculative decoding, the
request lifecycle), the n-gram drafter and the fault plans."""

from rocm_apex_tpu_torch.inference.drafting import NGramDrafter  # noqa: F401

from rocm_apex_tpu_torch.inference.engine import (  # noqa: F401
    FINISH_REASONS,
    GenerationResult,
    InferenceEngine,
    Request,
    SamplingParams,
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
from rocm_apex_tpu_torch.inference.sampling import (  # noqa: F401
    greedy,
    sample,
    top_k_logits,
    top_p_logits,
)

__all__ = [
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
    "Request",
    "SamplingParams",
    "greedy",
    "sample",
    "top_k_logits",
    "top_p_logits",
]
