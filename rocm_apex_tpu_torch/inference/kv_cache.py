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
``self``. `KVCache.slot_view` (the whole-prompt prefill's unit) is a
view: its buffers are slices of the cache's, so a forward against it
writes the slot's rows in place, and `KVCache.write_back` commits only
its length.
"""

import dataclasses
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.transformer import parallel_state

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
        """Cache sized for a `GPTConfig` (this rank's heads, as
        `PagedKVCache.for_model`), in the model's compute dtype unless
        ``dtype`` says otherwise."""
        tp = parallel_state.resolve_tensor_parallel_size(
            cfg.tensor_parallel_size)
        return cls.create(
            cfg.num_layers,
            num_slots,
            capacity or cfg.max_position_embeddings,
            cfg.num_attention_heads // tp,
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

    def slot_view(self, slot: int) -> "KVCache":
        """A one-slot cache (``num_slots == 1``) over slot ``slot``: its
        buffers are views of this cache's (writes land in place), its
        ``lengths`` a copy of the slot's. The in-place counterpart of the
        JAX ``slot_view`` (rocm_apex_tpu/inference/kv_cache.py:196)."""
        return KVCache(
            k=[b[slot:slot + 1] for b in self.k],
            v=[b[slot:slot + 1] for b in self.v],
            lengths=self.lengths[slot:slot + 1].clone(),
        )

    def write_back(self, slot: int, sub: "KVCache") -> "KVCache":
        """Commit a `slot_view`'s length into slot ``slot``: its rows were
        written in place (the JAX ``write_back`` scatters them back)."""
        self.lengths[slot:slot + 1] = sub.lengths.to(self.lengths.dtype)
        return self

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
        rows: Optional[ChunkRows] = None,
    ) -> "KVCache":
        """`scatter_chunk` into ``layer`` at per-token ``(slot,
        position)`` rows; rows with an out-of-range slot id (padding
        carries ``num_slots``) or position are dropped. Does not advance
        ``lengths``. ``rows``: the destinations resolved already (from
        `host_rows`), shared by every layer of one commit. The drop
        rule is the speculative engine's deferred commit: draft rows
        ride the chunk with the pad id, and the engine replays this
        write after verification with the accepted rows' real slots, so
        a rejected draft is never written rather than undone."""
        if rows is None:
            rows = chunk_rows(slots, positions, self.num_slots,
                              self.capacity)
        scatter_chunk(self.k[layer], rows, k_new)
        scatter_chunk(self.v[layer], rows, v_new)
        return self

    def host_rows(self, slots: np.ndarray, positions: np.ndarray):
        """`chunk_rows`' drop rule on host-held destinations, in numpy:
        ``(keep, keep_slots, keep_positions)``. With `rows_from` the
        engine resolves a write without reading a device value."""
        slots, positions = np.asarray(slots), np.asarray(positions)
        keep = np.flatnonzero((slots >= 0) & (slots < self.num_slots)
                              & (positions >= 0)
                              & (positions < self.capacity))
        return keep, slots[keep], positions[keep]

    @staticmethod
    def rows_from(slots, positions, keep, keep_slots, keep_positions
                  ) -> ChunkRows:
        """`ChunkRows` of device tensors: `host_rows`' arrays sent to
        the device, with ``slots`` the segment ids of the rows."""
        return ChunkRows(slots, positions, keep.long(), keep_slots.long(),
                         keep_positions.long())
