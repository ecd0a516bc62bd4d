"""Column/row-parallel linear layers and the vocab-parallel embedding.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/layers.py``. Each
layer holds this rank's shard of its weight: ``world_size`` (None: the
`parallel_state` tensor size once initialized, else 1) ranks of the
process group bound to ``axis_name`` (`parallel_state`), whose edges are
`mappings` and, under ``sequence_parallel`` with ``collective_matmul``,
the rings of `ops.collective_matmul`. At world size 1 every edge is the
identity and no group is needed.

The GEMMs stay ``torch.matmul``: the JAX package leaves them to XLA,
outside any Pallas kernel. Parameters keep the JAX layers' names and
local layouts (``kernel`` is (in, out/tp) column-parallel, (in/tp, out)
row-parallel; the row layer's bias is whole; the embedding (vocab/tp,
hidden)) and are trainable. The JAX layers cast the input and the fp32
kernel to the compute dtype on every call and add the bias in it; these
layers hold their parameters in the compute dtype already (the weight
bridge and the optimizer write them so), which gives the same values.
Like the JAX layers, the linears return ``(y, bias)``: ``bias`` is None
unless ``skip_bias_add`` hands it to the caller (the packed attention
adds it on tile load).

``sequence_parallel`` (world size > 1): the activations outside a
column -> row pair hold this rank's block of the rows (axis -2). The
column layer all-gathers its input into the matmul (``gather_output``
must be False), the row layer reduce-scatters its output
(``input_is_parallel`` must be True) and adds the whole bias to its
block; ``collective_matmul`` makes both edges rings
(``collective_matmul_chunk`` rows a piece). Every edge is
differentiable: the mappings' and the rings' backwards are JAX's
``custom_vjp`` rules, so the layers train at world size > 1.
``comm_dtype="int8"`` quantizes the rings' hop payloads
(`ops.collective_matmul`, `ops.quantized_collectives`); the plain edges
stay full precision, as JAX's.
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn

from rocm_apex_tpu_torch.ops.collective_matmul import (
    all_gather_matmul,
    check_comm_dtype,
    matmul_reduce_scatter,
)
from rocm_apex_tpu_torch.ops.linear_xentropy import (
    linear_cross_entropy_loss,
    linear_cross_entropy_mean,
    vocab_parallel_linear_cross_entropy,
)
from rocm_apex_tpu_torch.transformer import parallel_state
from rocm_apex_tpu_torch.transformer.tensor_parallel import mappings

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding"]

Device = Optional[Union[str, torch.device]]


def _divide(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} {n} is not divisible by world size {tp}")
    return n // tp


def _require_axis(axis_name: str, tp: int, cls: str) -> None:
    """tp > 1 needs its group: fail with the layer's name, not a bare
    KeyError inside a collective."""
    try:
        parallel_state.resolve_group(axis_name)
    except KeyError:
        raise ValueError(
            f"{cls} with world_size={tp} needs a process group bound to "
            f"axis {axis_name!r} (parallel_state.initialize_model_parallel "
            f"or set_axis_group)") from None


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype, world_size: Optional[int],
                 device: Device, skip_bias_add: bool, axis_name: str,
                 sequence_parallel: bool, collective_matmul: bool,
                 collective_matmul_chunk: Optional[int], comm_dtype: str,
                 column: bool):
        super().__init__()
        check_comm_dtype(comm_dtype)
        self.tp = parallel_state.resolve_tensor_parallel_size(world_size)
        self.dtype = dtype
        self.skip_bias_add = skip_bias_add
        self.axis_name = axis_name
        self.sequence_parallel = sequence_parallel
        self.collective_matmul = collective_matmul
        self.collective_matmul_chunk = collective_matmul_chunk
        self.comm_dtype = comm_dtype
        name = type(self).__name__
        if column:
            output_size = _divide(output_size, self.tp,
                                  f"{name} output_size")
        else:
            input_size = _divide(input_size, self.tp, f"{name} input_size")
        self.kernel = nn.Parameter(
            torch.zeros(input_size, output_size, dtype=dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(output_size, dtype=dtype, device=device)
        )

    @property
    def _sp(self) -> bool:
        return self.tp > 1 and self.sequence_parallel

    @property
    def _ring(self) -> bool:
        return self._sp and self.collective_matmul

    def _finish(self, y, bias, skip_bias_add):
        skip = self.skip_bias_add if skip_bias_add is None else skip_bias_add
        if skip:
            return y, bias
        return y + bias, None


class ColumnParallelLinear(_Linear):
    """Y = XA + b with A (in, out) split by columns: this rank's columns
    of Y (all of them with ``gather_output``, the JAX default)."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None,
                 skip_bias_add: bool = False, gather_output: bool = True,
                 axis_name: str = parallel_state.TENSOR_AXIS,
                 sequence_parallel: bool = False,
                 collective_matmul: bool = False,
                 collective_matmul_chunk: Optional[int] = None,
                 comm_dtype: str = "fp32"):
        super().__init__(input_size, output_size, dtype, world_size, device,
                         skip_bias_add, axis_name, sequence_parallel,
                         collective_matmul, collective_matmul_chunk,
                         comm_dtype, column=True)
        if sequence_parallel and gather_output:
            raise ValueError(
                "sequence_parallel=True shards the rows the caller "
                "sees; it requires gather_output=False")
        self.gather_output = gather_output

    def forward(
        self, x: torch.Tensor, skip_bias_add: Optional[bool] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(x @ kernel + bias, None)``, or ``(x @ kernel, bias)`` when
        ``skip_bias_add`` (the call's, else the layer's) is set."""
        x = x.to(self.kernel.dtype)
        if self.tp > 1:
            _require_axis(self.axis_name, self.tp, "ColumnParallelLinear")
        if self._ring:
            y = all_gather_matmul(x, self.kernel, self.axis_name,
                                  self.collective_matmul_chunk,
                                  self.comm_dtype)
        else:
            if self._sp:
                x = mappings.gather_from_sequence_parallel_region(
                    x, self.axis_name, dim=-2)
            elif self.tp > 1:
                x = mappings.copy_to_tensor_model_parallel_region(
                    x, self.axis_name)
            y = torch.matmul(x, self.kernel)
        y, bias = self._finish(y, self.bias, skip_bias_add)
        if self.gather_output and self.tp > 1:
            y = mappings.gather_from_tensor_model_parallel_region(
                y, self.axis_name)
            if bias is not None:
                bias = mappings.gather_from_tensor_model_parallel_region(
                    bias, self.axis_name)
        return y, bias


class RowParallelLinear(_Linear):
    """Y = XA + b with A (in, out) split by rows: this rank's partial
    product, reduced over the group (reduce-scattered over the rows
    under ``sequence_parallel``), the bias added once after the
    reduction."""

    def __init__(self, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None,
                 skip_bias_add: bool = False, input_is_parallel: bool = False,
                 axis_name: str = parallel_state.TENSOR_AXIS,
                 sequence_parallel: bool = False,
                 collective_matmul: bool = False,
                 collective_matmul_chunk: Optional[int] = None,
                 comm_dtype: str = "fp32"):
        super().__init__(input_size, output_size, dtype, world_size, device,
                         skip_bias_add, axis_name, sequence_parallel,
                         collective_matmul, collective_matmul_chunk,
                         comm_dtype, column=False)
        if sequence_parallel and not input_is_parallel:
            raise ValueError(
                "sequence_parallel=True requires input_is_parallel=True "
                "(the producer must be a ColumnParallelLinear with "
                "gather_output=False)")
        self.input_is_parallel = input_is_parallel

    def forward(
        self, x: torch.Tensor, skip_bias_add: Optional[bool] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x.to(self.kernel.dtype)
        if self.tp > 1:
            _require_axis(self.axis_name, self.tp, "RowParallelLinear")
            if not self.input_is_parallel:
                x = mappings.scatter_to_tensor_model_parallel_region(
                    x, self.axis_name)
        if self._ring:
            y = matmul_reduce_scatter(x, self.kernel, self.axis_name,
                                      self.collective_matmul_chunk,
                                      self.comm_dtype)
        else:
            y = torch.matmul(x, self.kernel)
            if self._sp:
                y = mappings.reduce_scatter_to_sequence_parallel_region(
                    y, self.axis_name, dim=-2)
            elif self.tp > 1:
                y = mappings.reduce_from_tensor_model_parallel_region(
                    y, self.axis_name)
        bias = self.bias
        if self._sp:
            # the whole bias on this rank's rows: its gradient is a
            # partial row sum (identity forward, all-reduce backward)
            bias = mappings.copy_to_tensor_model_parallel_region(
                bias, self.axis_name)
        return self._finish(y, bias, skip_bias_add)


class VocabParallelEmbedding(nn.Module):
    """Word embedding (vocab, hidden) split by vocabulary rows, in the
    compute dtype: the forward looks up the ids in this rank's range
    (the others masked to 0) and sums the ranks' lookups; ``attend``
    projects hidden states onto this rank's vocabulary rows with the
    tied table (``hidden @ weight.T`` in hidden's dtype: vocab-parallel
    logits); ``attend_loss`` fuses that projection with the
    cross-entropy so the logits never exist whole (at world size > 1
    over this rank's vocabulary block,
    `vocab_parallel_linear_cross_entropy`)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 world_size: Optional[int] = None, device: Device = None,
                 axis_name: str = parallel_state.TENSOR_AXIS):
        super().__init__()
        self.tp = parallel_state.resolve_tensor_parallel_size(world_size)
        self.axis_name = axis_name
        self.per_partition = _divide(num_embeddings, self.tp,
                                     "VocabParallelEmbedding num_embeddings")
        self.weight = nn.Parameter(
            torch.zeros(self.per_partition, embedding_dim, dtype=dtype,
                        device=device)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return self.weight[ids]
        _require_axis(self.axis_name, self.tp, "VocabParallelEmbedding")
        start = (parallel_state.axis_rank(self.axis_name)
                 * self.per_partition)
        local = ids - start
        in_range = (local >= 0) & (local < self.per_partition)
        out = self.weight[local.clamp(0, self.per_partition - 1)]
        out = torch.where(in_range[..., None], out, 0)
        return mappings.reduce_from_tensor_model_parallel_region(
            out, self.axis_name)

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.tp > 1:
            _require_axis(self.axis_name, self.tp, "VocabParallelEmbedding")
            hidden = mappings.copy_to_tensor_model_parallel_region(
                hidden, self.axis_name)
        return torch.matmul(hidden, self.weight.to(hidden.dtype).t())

    def attend_loss(self, hidden: torch.Tensor, labels: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None,
                    reduction: Optional[str] = None, smoothing: float = 0.0,
                    padding_idx: Optional[int] = None,
                    chunk_size: Optional[int] = None) -> torch.Tensor:
        """`attend` fused with cross-entropy (ops/linear_xentropy.py).
        ``reduction=None`` returns per-row fp32 losses shaped like
        ``labels`` (the caller applies ``loss_mask``); ``"mean"`` returns
        the masked-mean scalar, whose gradients finish in the forward at
        world size 1. At world size > 1 the head is
        `vocab_parallel_linear_cross_entropy` (the hidden gradient summed
        over the group inside), and ``"mean"`` reduces its per-row
        losses the `gpt_loss_fn` way, as JAX does: the forward-gradient
        form needs a replicated weight."""
        if reduction not in (None, "mean"):
            raise ValueError(f"unknown reduction {reduction!r}")
        w = self.weight.to(hidden.dtype)
        if self.tp > 1:
            _require_axis(self.axis_name, self.tp, "VocabParallelEmbedding")
            losses = vocab_parallel_linear_cross_entropy(
                hidden, w, labels, self.axis_name, smoothing, padding_idx,
                chunk_size)
            if reduction is None:
                return losses
            if loss_mask is not None:
                m = loss_mask.detach().float()
                return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)
            return losses.mean()
        if reduction == "mean":
            return linear_cross_entropy_mean(
                hidden, w, labels, loss_mask, smoothing, padding_idx,
                chunk_size,
            )
        return linear_cross_entropy_loss(
            hidden, w, labels, smoothing, padding_idx, chunk_size
        )
