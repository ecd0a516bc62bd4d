"""Serving tier: the KV cache, sampling and the continuous-batching
engine (chunked prefill on the contiguous cache)."""

from rocm_apex_tpu_torch.inference.engine import (  # noqa: F401
    FINISH_REASONS,
    GenerationResult,
    InferenceEngine,
    Request,
    SamplingParams,
)
from rocm_apex_tpu_torch.inference.kv_cache import KVCache  # noqa: F401
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
    "Request",
    "SamplingParams",
    "greedy",
    "sample",
    "top_k_logits",
    "top_p_logits",
]
