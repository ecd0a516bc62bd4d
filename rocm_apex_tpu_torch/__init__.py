"""PyTorch and CUDA port of ``rocm_apex_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rocm_apex_tpu`` is the reference; this package keeps
its module names so each part can be found beside its counterpart, and
imports nothing from it. Ported so far, the KV-cached serving path, the
GPT training step (with the per-leaf or the packed optimizer step), the
BERT masked-LM training step and the ResNet training step (with the
fused bottleneck):

    ops            hand-written sm_90a CUDA kernels (csrc/), built with
                   nvcc at first use and bound with ctypes, each with a
                   plain PyTorch version used for CPU tensors (LayerNorm,
                   the attention kernels, the scaled causal and masked
                   softmax, the label-smoothed cross-entropy, the LAMB
                   stage pair, the packed-buffer multi-tensor passes and
                   optimizer updates, the fused bottleneck's 1x1 and 3x3
                   conv+BN forward and backward); the packed layout; the
                   chunked fused linear+cross-entropy head (plain PyTorch)
    normalization  `FusedLayerNorm`, `MixedFusedLayerNorm` and the
                   functional forms (affine or not, forward and backward)
    transformer    tensor-parallel linear/embedding layers at world size 1;
                   `functional.FusedScaleMaskSoftmax`, the enums; ring and
                   Ulysses attention over torch.distributed groups
                   (`context_parallel`, `parallel_state`)
    models         `GPTModel`: the uncached (training) forward and the
                   cached chunk and decode branches, flash,
                   ``attention_impl="fused_softmax"`` or ``"jnp"``, and
                   context-parallel training; `BertModel`: the
                   masked-LM forward, with or without a padding mask;
                   the ResNet family (NHWC, flax-semantics BatchNorm)
    inference      `KVCache`, sampling, the continuous-batching
                   `InferenceEngine` (chunked prefill)
    amp            the O0/O2/O3/O5 policies (`initialize`), fp32 master
                   weights, the loss-scaling flow, the `LossScaler`
    contrib        `fmha`, `xentropy`, `bottleneck` (`FusedBottleneck`),
                   `multihead_attn`
    optimizers     `MixedPrecisionAdam`, `MixedPrecisionLamb` (fp32 masters,
                   compute-dtype model); `PackedOptimizerStep`,
                   `packed_adam`, `packed_lamb` (masters and moments in
                   packed buffers); the tree-form `FusedAdam`
    multi_tensor_apply  `multi_tensor_applier` over the packed ops
    train          `make_train_step` (GPT), `make_bert_train_step`,
                   `make_rn50_train_step`: one mixed-precision training step
    convert        the weight (and optimizer-state) bridge from the JAX
                   GPT's, BERT's, ResNet's and multi-head attention's
                   variables

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
