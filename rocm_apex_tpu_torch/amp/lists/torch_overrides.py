"""Cast lists: which op families run in low precision and which in fp32.

Port of ``rocm_apex_tpu/amp/lists/jnp_overrides.py`` under upstream
Apex's name for the same file (apex/amp/lists/torch_overrides.py). The
lists are data that the modules and the policy decorators consult, not a
table of functions to patch: a module asks `is_low_precision_op` /
`is_fp32_op` for an op family's compute dtype under an O1/O4 policy.

The low-precision list holds the matmul and convolution families (the
Tensor-Core list of the reference, torch_overrides.py:7-27, and its bf16
list, :29-48). The fp32 list holds reductions and the numerically
sensitive ops (softmax, norms, losses; torch_overrides.py:50-82). The
names are the JAX package's, so both packages answer alike.
"""

# matmul-friendly ops: the policy's compute dtype (fp16 under O1, bf16
# under O4)
FP16_FUNCS = [
    "conv1d", "conv2d", "conv3d", "conv_transpose",
    "dot", "dot_general", "matmul", "einsum", "tensordot",
    "conv_general_dilated",
    "linear", "dense",
    "attention", "scaled_dot_product_attention",
]

# the ROCm fork's bf16 list is the fp16 one (torch_overrides.py:29-48)
BFLOAT16_FUNCS = list(FP16_FUNCS)

# numerically sensitive ops: fp32 inputs under O1/O4
FP32_FUNCS = [
    "softmax", "log_softmax", "logsumexp",
    "layer_norm", "group_norm", "batch_norm", "normalize", "rms_norm",
    "cross_entropy", "nll_loss", "l1_loss", "mse_loss", "kl_div",
    "smooth_l1_loss", "cosine_similarity",
    "exp", "expm1", "log", "log1p", "log2", "log10",
    "pow", "rsqrt", "sqrt", "reciprocal",
    "sum", "mean", "prod", "cumsum", "cumprod", "var", "std", "norm",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "erf", "erfc", "erfinv", "gelu",
]

# multi-argument promotion: the widest dtype wins
CASTS = [
    "add", "subtract", "multiply", "divide", "true_divide",
    "equal", "not_equal", "greater", "greater_equal", "less", "less_equal",
    "maximum", "minimum", "atan2", "hypot", "nextafter",
    "where",
]

# sequence promotion (cat/stack in the reference)
SEQUENCE_CASTS = ["concatenate", "stack", "hstack", "vstack", "dstack"]

# ops that are unsafe in low precision (the reference's BANNED_FUNCS,
# functional_overrides.py), with the message the policy layer raises
BANNED_FUNCS = [
    ("binary_cross_entropy",
     "amp does not work out-of-the-box with binary_cross_entropy on "
     "low-precision logits: it requires the output of sigmoid and is "
     "unsafe to run in fp16/bf16. Use a fused sigmoid+BCE-with-logits "
     "formulation (optax.sigmoid_binary_cross_entropy) instead."),
]

_LOW = frozenset(FP16_FUNCS)
_F32 = frozenset(FP32_FUNCS)


def is_low_precision_op(name: str) -> bool:
    return name in _LOW


def is_fp32_op(name: str) -> bool:
    return name in _F32
