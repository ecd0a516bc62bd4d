"""PyTorch and CUDA port of ``rocm_apex_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rocm_apex_tpu`` is the reference; this package keeps
its module names so each part can be found beside its counterpart, and
imports nothing from it. Ported so far, the KV-cached serving path:

    ops            hand-written sm_90a CUDA kernels (csrc/), built with
                   nvcc at first use and bound with ctypes, each with a
                   plain PyTorch version used for CPU tensors
    normalization  `MixedFusedLayerNorm` (forward)
    transformer    tensor-parallel linear/embedding layers at world size 1
    models         `GPTModel` on its cached chunk and decode branches
    inference      `KVCache`, sampling, the continuous-batching
                   `InferenceEngine` (chunked prefill)
    convert        the weight bridge from the JAX GPT's param tree

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
