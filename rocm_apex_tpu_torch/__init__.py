"""PyTorch and CUDA port of ``rocm_apex_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rocm_apex_tpu`` is the reference; this package keeps
its module names so each part can be found beside its counterpart, and
imports nothing from it. Ported so far, the KV-cached serving path and
the GPT training step:

    ops            hand-written sm_90a CUDA kernels (csrc/), built with
                   nvcc at first use and bound with ctypes, each with a
                   plain PyTorch version used for CPU tensors; the
                   chunked fused linear+cross-entropy head (plain PyTorch)
    normalization  `MixedFusedLayerNorm` (forward and backward)
    transformer    tensor-parallel linear/embedding layers at world size 1
    models         `GPTModel`: the uncached (training) forward and the
                   cached chunk and decode branches
    inference      `KVCache`, sampling, the continuous-batching
                   `InferenceEngine` (chunked prefill)
    amp            the dynamic `LossScaler`
    optimizers     `MixedPrecisionAdam` (fp32 masters, compute-dtype model)
    train          `make_train_step`, one mixed-precision training step
    convert        the weight bridge from the JAX GPT's param tree

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
