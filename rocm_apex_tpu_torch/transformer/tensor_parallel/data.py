"""Cross-rank broadcast of a keyed batch dict.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/data.py``: each
``data[key]`` from rank 0 of the tensor group to the others, where JAX
sums a mask (every rank but rank 0 contributes zeros). Here it is one
`parallel_state.broadcast` a key, the same bits on every rank. Shapes
must already agree across ranks, as in JAX.
"""

from typing import Dict, List, Optional

import torch

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["broadcast_data"]


def _check_data_types(keys: List[str], data: Dict[str, torch.Tensor],
                      target_dtype):
    """Reference data.py:17-26."""
    for key in keys:
        if data[key].dtype != target_dtype:
            raise ValueError(
                f"{key} has data type {data[key].dtype} which "
                f"is different than {target_dtype}"
            )


def broadcast_data(keys: List[str], data: Dict[str, torch.Tensor], dtype,
                   axis_name: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """Rank 0's ``data[key]`` for each key, on every rank of the group
    bound to ``axis_name`` (None: the tensor axis), in ``dtype``."""
    axis_name = parallel_state.TENSOR_AXIS if axis_name is None else axis_name
    _check_data_types(keys, data, dtype)
    group = parallel_state.resolve_group(axis_name)
    return {key: parallel_state.broadcast(data[key], group, 0).to(dtype)
            for key in keys}
