"""Tree helpers of the amp layer: the port's own copy of
``rocm_apex_tpu/utils/tree.py``'s `is_batchnorm_path` and `tree_cast`,
and the leaf-wise map and select the functional optimizer step uses.

A tree is a dict of name -> tensor (names the JAX paths joined with "."
or "/"), or tuples, lists and NamedTuples of trees; None is a leaf that
stays None.
"""

import re
from typing import Any, Callable, Mapping, Optional

import torch

__all__ = ["is_batchnorm_path", "tree_cast", "tree_map", "tree_leaves"]

# path segments that name batch-norm parameters (keep_batchnorm_fp32)
_BN_PATH_TOKENS = ("batchnorm", "batch_norm", "bn", "batch_stats",
                   "syncbatchnorm")


def is_batchnorm_path(path: str) -> bool:
    """True when a segment of ``path`` is a batch-norm token, alone or
    numbered (``bn1``, ``batchnorm_0``), or a flat BN leaf (``bn1_scale``,
    ``bn4_bias``, ``bn_mean``): whole segments, so ``subnet`` and
    ``conv1_kernel`` do not match."""
    segments = re.split(r"[./]", path.lower())
    return any(
        re.fullmatch(tok + r"_?\d*", seg)
        or re.fullmatch(tok + r"_?\d*_(scale|bias|mean|var)", seg)
        for seg in segments
        for tok in _BN_PATH_TOKENS
    )


def tree_cast(tree: Mapping[str, Any], dtype: torch.dtype,
              keep_fp32_predicate: Optional[Callable[[str], bool]] = None
              ) -> dict:
    """Every floating leaf of the dict ``tree`` in ``dtype``; leaves whose
    name ``keep_fp32_predicate`` accepts in float32 instead."""
    def cast(name, x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        keep = keep_fp32_predicate is not None and keep_fp32_predicate(name)
        return x.to(torch.float32 if keep else dtype)

    return {k: cast(k, v) for k, v in tree.items()}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out
