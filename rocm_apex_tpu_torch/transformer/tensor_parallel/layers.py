"""Column/row-parallel linear layers and the vocab-parallel embedding,
at tensor-parallel world size 1.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/layers.py``
(forward only). The GEMMs stay ``torch.matmul``: the JAX package leaves
them to XLA, outside any Pallas kernel. Parameters keep the JAX layers' names
and layouts (``kernel`` is (in, out)). The JAX layers cast the input and
the fp32 kernel to the compute dtype on every call and add the bias in
it; these layers hold their parameters in the compute dtype already (the
weight bridge casts once at load), which gives the same values. World
size > 1 raises.
"""

from typing import Optional, Union

import torch
from torch import nn

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding"]

Device = Optional[Union[str, torch.device]]


def _require_tp1(world_size: Optional[int], cls: str) -> None:
    if world_size not in (None, 1):
        raise NotImplementedError(
            f"{cls} with world_size={world_size}: tensor parallelism is not "
            f"ported yet (ROADMAP Queue 1 item 6, tp>1 serving)"
        )


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype, world_size: Optional[int],
                 device: Device):
        super().__init__()
        _require_tp1(world_size, type(self).__name__)
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(input_size, output_size, dtype=dtype, device=device),
            requires_grad=False,
        )
        self.bias = nn.Parameter(
            torch.zeros(output_size, dtype=dtype, device=device),
            requires_grad=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel) + self.bias


class ColumnParallelLinear(_Linear):
    """Y = XA + b with A (in, out) (at world size 1 the column split is
    the whole matrix)."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None):
        super().__init__(input_size, output_size, dtype, world_size, device)


class RowParallelLinear(_Linear):
    """Y = XA + b with A (in, out), the bias added once after the
    (trivial at world size 1) reduction."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None):
        super().__init__(input_size, output_size, dtype, world_size, device)


class VocabParallelEmbedding(nn.Module):
    """Word embedding (vocab, hidden) in the compute dtype; ``attend``
    projects hidden states back onto the vocabulary with the tied table
    (``hidden @ weight.T`` in hidden's dtype)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None):
        super().__init__()
        _require_tp1(world_size, "VocabParallelEmbedding")
        self.weight = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim, dtype=dtype,
                        device=device),
            requires_grad=False,
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.matmul(hidden, self.weight.to(hidden.dtype).t())
