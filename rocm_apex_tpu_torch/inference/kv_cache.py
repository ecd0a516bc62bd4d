"""Preallocated slot KV cache for autoregressive decoding.

Port of ``rocm_apex_tpu/inference/kv_cache.py`` (the contiguous
layout). Per-layer ``(num_slots, capacity, heads, head_dim)`` key/value
buffers plus one ``(num_slots,)`` int32 length vector, allocated once.
A slot is a batch lane the engine leases to one request at a time;
eviction forgets its length, and stale rows past a new request's prefix
are never attended (every read is bounded by ``lengths``). The paged
sibling, whose memory follows live tokens (block tables, int8 pages,
prefix sharing), is `inference/paging.py`'s `PagedKVCache`.

UPDATES HAPPEN IN PLACE. Where the JAX cache is an immutable pytree
whose writes return a new cache (in place only under ``jit`` with
donated buffers), the two writes here — `scatter_chunk` and
`write_at_lengths`, which the model's cached forward calls per layer —
write into the buffers they are given, and the `KVCache` methods return
``self``.
"""

import dataclasses
from typing import List, NamedTuple, Optional, Union

import torch

from rocm_apex_tpu_torch._device import resolve_device

__all__ = [
    "KVCache",
    "ChunkRows",
    "chunk_rows",
    "scatter_chunk",
    "write_at_lengths",
]


class ChunkRows(NamedTuple):
    """A packed chunk's per-token slot ids and positions, plus the rows
    whose K/V land in the cache."""

    slots: torch.Tensor  # (budget,) int32
    positions: torch.Tensor  # (budget,)
    keep: torch.Tensor  # (kept,) long row indices into the chunk
    keep_slots: torch.Tensor  # (kept,) long
    keep_positions: torch.Tensor  # (kept,) long


def chunk_rows(slots, positions, num_slots: int, capacity: int) -> ChunkRows:
    """The scatter's drop rule (the JAX ``.at[slots, pos].set(mode=
    "drop")``): a row lands only if its slot and position are both in
    range. Pads carry slot id ``num_slots``; they are dropped, never
    clamped onto a live row. Torch indexing has no drop mode, so the
    kept rows are selected explicitly (one host read of the mask)."""
    keep = torch.nonzero(
        (slots >= 0) & (slots < num_slots)
        & (positions >= 0) & (positions < capacity)
    ).squeeze(1)
    return ChunkRows(
        slots, positions, keep, slots[keep].long(), positions[keep].long(),
    )


def scatter_chunk(buf: torch.Tensor, rows: ChunkRows,
                  new: torch.Tensor) -> None:
    """Write a packed ``(budget, heads, head_dim)`` chunk into ``buf``
    (``(num_slots, capacity, heads, head_dim)``) at its kept rows'
    ``(slot, position)``, in place."""
    buf[rows.keep_slots, rows.keep_positions] = new[rows.keep].to(buf.dtype)


def write_at_lengths(buf: torch.Tensor, lengths: torch.Tensor,
                     new: torch.Tensor) -> None:
    """Write ``(num_slots, t, heads, head_dim)`` rows into ``buf`` at
    each slot's length, in place, dead slots included; the start clamps
    to ``capacity - t``, as ``dynamic_update_slice`` does."""
    num_slots, t = new.shape[0], new.shape[1]
    start = lengths.clamp(0, buf.shape[1] - t).long()
    cols = start[:, None] + torch.arange(t, device=buf.device)[None, :]
    rows = torch.arange(num_slots, device=buf.device)[:, None]
    buf[rows, cols] = new.to(buf.dtype)


@dataclasses.dataclass
class KVCache:
    """``k``/``v``: one ``(num_slots, capacity, heads, head_dim)`` buffer
    per layer. ``lengths``: ``(num_slots,)`` int32 — tokens materialized
    in each slot, the next decode write offset and the read bound."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    lengths: torch.Tensor

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_slots: int,
        capacity: int,
        num_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "KVCache":
        dev = resolve_device(device)
        shape = (num_slots, capacity, num_heads, head_dim)
        return cls(
            k=[torch.zeros(shape, dtype=dtype, device=dev)
               for _ in range(num_layers)],
            v=[torch.zeros(shape, dtype=dtype, device=dev)
               for _ in range(num_layers)],
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        )

    @classmethod
    def for_model(
        cls,
        cfg,
        num_slots: int,
        capacity: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "KVCache":
        """Cache sized for a `GPTConfig` (tensor-parallel world size 1),
        in the model's compute dtype unless ``dtype`` says otherwise."""
        return cls.create(
            cfg.num_layers,
            num_slots,
            capacity or cfg.max_position_embeddings,
            cfg.num_attention_heads,
            cfg.head_dim,
            dtype if dtype is not None else cfg.dtype,
            device,
        )

    @property
    def num_slots(self) -> int:
        return self.k[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.k[0].shape[1]

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
              ) -> "KVCache":
        """`write_at_lengths` into ``layer``; does not advance
        ``lengths``."""
        write_at_lengths(self.k[layer], self.lengths, k_new)
        write_at_lengths(self.v[layer], self.lengths, v_new)
        return self

    def write_at(
        self,
        layer: int,
        slots: torch.Tensor,
        positions: torch.Tensor,
        k_new: torch.Tensor,
        v_new: torch.Tensor,
    ) -> "KVCache":
        """`scatter_chunk` into ``layer`` at per-token ``(slot,
        position)`` rows; rows with an out-of-range slot id (padding
        carries ``num_slots``) or position are dropped. Does not advance
        ``lengths``."""
        rows = chunk_rows(slots, positions, self.num_slots, self.capacity)
        scatter_chunk(self.k[layer], rows, k_new)
        scatter_chunk(self.v[layer], rows, v_new)
        return self
