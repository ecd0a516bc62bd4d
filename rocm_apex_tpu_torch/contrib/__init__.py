"""contrib: the port of the JAX package's ``rocm_apex_tpu.contrib``.

One subpackage per kernel family, each importable on its own, as the JAX
package lays them out. Ported so far: ``fmha`` (packed variable-length
attention), ``xentropy`` (label-smoothed softmax cross-entropy) and
``bottleneck`` (the ResNet bottleneck, plain and fused).
"""
