"""Column/row-parallel linear layers and the vocab-parallel embedding,
at tensor-parallel world size 1.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/layers.py``. The
GEMMs stay ``torch.matmul``: the JAX package leaves them to XLA, outside
any Pallas kernel. Parameters keep the JAX layers' names and layouts
(``kernel`` is (in, out)) and are trainable. The JAX layers cast the
input and the fp32 kernel to the compute dtype on every call and add
the bias in it; these layers hold their parameters in the compute dtype
already (the weight bridge and the optimizer write them so), which gives
the same values. Like the JAX layers, the linears return ``(y, bias)``:
``bias`` is None unless ``skip_bias_add`` hands it to the caller (the
packed attention adds it on tile load). World size > 1 raises.
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn

from rocm_apex_tpu_torch.ops.linear_xentropy import (
    linear_cross_entropy_loss,
    linear_cross_entropy_mean,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding"]

Device = Optional[Union[str, torch.device]]


def _require_tp1(world_size: Optional[int], cls: str) -> None:
    if world_size not in (None, 1):
        raise NotImplementedError(
            f"{cls} with world_size={world_size}: tensor parallelism is not "
            f"ported yet (ROADMAP Queue 1 item 8, tp>1 serving)"
        )


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype, world_size: Optional[int],
                 device: Device, skip_bias_add: bool):
        super().__init__()
        _require_tp1(world_size, type(self).__name__)
        self.dtype = dtype
        self.skip_bias_add = skip_bias_add
        self.kernel = nn.Parameter(
            torch.zeros(input_size, output_size, dtype=dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(output_size, dtype=dtype, device=device)
        )

    def forward(
        self, x: torch.Tensor, skip_bias_add: Optional[bool] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x @ kernel + bias, None)``, or ``(x @ kernel, bias)`` when
        ``skip_bias_add`` (the call's, else the layer's) is set."""
        y = torch.matmul(x.to(self.kernel.dtype), self.kernel)
        skip = self.skip_bias_add if skip_bias_add is None else skip_bias_add
        if skip:
            return y, self.bias
        return y + self.bias, None


class ColumnParallelLinear(_Linear):
    """Y = XA + b with A (in, out) (at world size 1 the column split is
    the whole matrix)."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None,
                 skip_bias_add: bool = False):
        super().__init__(input_size, output_size, dtype, world_size, device,
                         skip_bias_add)


class RowParallelLinear(_Linear):
    """Y = XA + b with A (in, out), the bias added once after the
    (trivial at world size 1) reduction."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None,
                 skip_bias_add: bool = False):
        super().__init__(input_size, output_size, dtype, world_size, device,
                         skip_bias_add)


class VocabParallelEmbedding(nn.Module):
    """Word embedding (vocab, hidden) in the compute dtype; ``attend``
    projects hidden states back onto the vocabulary with the tied table
    (``hidden @ weight.T`` in hidden's dtype); ``attend_loss`` fuses that
    projection with the cross-entropy so the logits never exist whole."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None):
        super().__init__()
        _require_tp1(world_size, "VocabParallelEmbedding")
        self.weight = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim, dtype=dtype,
                        device=device)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.matmul(hidden, self.weight.to(hidden.dtype).t())

    def attend_loss(self, hidden: torch.Tensor, labels: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None,
                    reduction: Optional[str] = None, smoothing: float = 0.0,
                    padding_idx: Optional[int] = None,
                    chunk_size: Optional[int] = None) -> torch.Tensor:
        """`attend` fused with cross-entropy (ops/linear_xentropy.py).
        ``reduction=None`` returns per-row fp32 losses shaped like
        ``labels`` (the caller applies ``loss_mask``); ``"mean"`` returns
        the masked-mean scalar, whose gradients finish in the forward."""
        if reduction not in (None, "mean"):
            raise ValueError(f"unknown reduction {reduction!r}")
        w = self.weight.to(hidden.dtype)
        if reduction == "mean":
            return linear_cross_entropy_mean(
                hidden, w, labels, loss_mask, smoothing, padding_idx,
                chunk_size,
            )
        return linear_cross_entropy_loss(
            hidden, w, labels, smoothing, padding_idx, chunk_size
        )
