"""The paged KV cache's device-side primitives: block-table indirection.

Port of ``rocm_apex_tpu/ops/paging.py``. A paged cache keeps K/V in one
pool of fixed-size pages per layer, ``(num_pages, heads, page_size,
head_dim)``, and a ``(num_slots, pages_per_slot)`` int32 table maps each
slot's logical positions onto pool pages (unmapped entries hold the
sentinel ``num_pages``). This module owns the math the model and the
cache share:

* `paged_destinations`: per-token ``(slot, position)`` to ``(page,
  offset)``; an invalid token (pad slot, position outside ``[0,
  capacity)``, unmapped entry) gets the sentinel page ``num_pages``.
* `paged_rows`, `paged_scatter`, `quantized_paged_scatter`: the write
  path, IN PLACE. Invalid destinations DROP and never clamp: a paged
  write must not land in a live (maybe shared) page. Torch indexing has
  no ``mode="drop"``, so the kept rows are selected explicitly with one
  ``nonzero`` (one host read of the mask, as `kv_cache.chunk_rows` does).
  The model resolves `paged_rows` once per forward and hands them to
  every layer's writes.
* `paged_view`: the reference read, the pool gathered through the table
  back into the contiguous ``(num_slots, capacity, heads, head_dim)``
  layout (dequantized when int8). The plain attention versions read it;
  the CUDA kernel never builds it.
* `paged_fork`: the copy-on-write primitive, one page copied onto
  another, in place.

int8 pools carry one fp32 scale per (page, head). Scales only GROW: a
write that raises a page's scale first requantizes the page's existing
rows by ``round(q * old / new)`` (ratio <= 1, so nothing overflows), then
quantizes the new rows with the new scale. ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the bytes match the JAX package's.
"""

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "PagedRows",
    "paged_destinations",
    "paged_rows",
    "paged_scatter",
    "quantized_paged_scatter",
    "paged_view",
    "paged_fork",
]


class PagedRows(NamedTuple):
    """The kept write destinations of one batch of tokens."""

    slots: torch.Tensor  # (tokens,) int32, every token's slot id
    keep: torch.Tensor  # (kept,) long indices of the tokens that land
    pages: torch.Tensor  # (kept,) long pool pages
    offsets: torch.Tensor  # (kept,) long rows within the page


def paged_destinations(
    page_table: torch.Tensor,
    slots: torch.Tensor,
    positions: torch.Tensor,
    page_size: int,
    num_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pages, offsets)`` of each token; an invalid token's page is the
    sentinel ``num_pages`` (the value an unmapped entry holds)."""
    num_slots, pages_per_slot = page_table.shape
    capacity = pages_per_slot * page_size
    slots = slots.to(torch.long)
    positions = positions.to(torch.long)
    valid = (
        (slots >= 0) & (slots < num_slots)
        & (positions >= 0) & (positions < capacity)
    )
    sl = slots.clamp(0, num_slots - 1)
    pos = positions.clamp(0, capacity - 1)
    pages = torch.where(
        valid, page_table[sl, pos // page_size].to(torch.long), num_pages
    )
    return pages, pos % page_size


def paged_rows(
    page_table: torch.Tensor,
    slots: torch.Tensor,
    positions: torch.Tensor,
    page_size: int,
    num_pages: int,
) -> PagedRows:
    """The destinations that land: the drop rule, applied once."""
    pages, offs = paged_destinations(
        page_table, slots, positions, page_size, num_pages
    )
    keep = torch.nonzero((pages >= 0) & (pages < num_pages)).squeeze(1)
    return PagedRows(slots, keep, pages[keep], offs[keep])


def paged_scatter(
    pool: torch.Tensor,
    page_table: torch.Tensor,
    slots: torch.Tensor,
    positions: torch.Tensor,
    x: torch.Tensor,
    rows: Optional[PagedRows] = None,
) -> torch.Tensor:
    """Write ``x`` (tokens, heads, head_dim) into ``pool`` at the
    table-resolved destinations, in place (``rows``: the destinations
    from `paged_rows`, when the caller has resolved them already).
    Exact: the stored values are ``x`` cast to the pool's dtype."""
    num_pages, _, page_size, _ = pool.shape
    if rows is None:
        rows = paged_rows(page_table, slots, positions, page_size, num_pages)
    pool[rows.pages, :, rows.offsets] = x[rows.keep].to(pool.dtype)
    return pool


def quantized_paged_scatter(
    pool: torch.Tensor,
    scale: torch.Tensor,
    page_table: torch.Tensor,
    slots: torch.Tensor,
    positions: torch.Tensor,
    x: torch.Tensor,
    rows: Optional[PagedRows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 write with per-(page, head) fp32 scales, in place on
    ``pool`` (int8 ``(num_pages, heads, page_size, head_dim)``) and
    ``scale`` (``(num_pages, heads)``): raise each touched page's scale
    to the new rows' absmax / 127, requantize the touched pages' rows
    by old / new, then quantize and write the new rows."""
    num_pages, _, page_size, _ = pool.shape
    if rows is None:
        rows = paged_rows(page_table, slots, positions, page_size, num_pages)
    pages = rows.pages
    xf = x[rows.keep].float()
    absmax = xf.abs().amax(dim=-1)  # (kept, heads)
    contrib = torch.zeros_like(scale).scatter_reduce_(
        0, pages[:, None].expand_as(absmax), absmax, "amax"
    )
    new_scale = torch.maximum(scale, contrib / 127.0)
    positive = new_scale > 0.0
    safe = torch.where(positive, new_scale, 1.0)
    ratio = torch.where(positive, scale / safe, 1.0)
    # every kept token rewrites its whole page (duplicates write the same
    # bytes); a page whose scale did not move rewrites itself unchanged
    old = pool[pages].float()
    pool[pages] = torch.round(old * ratio[pages][:, :, None, None]).to(
        pool.dtype
    )
    q = torch.clamp(torch.round(xf / safe[pages][:, :, None]), -127.0, 127.0)
    pool[pages, :, rows.offsets] = q.to(pool.dtype)
    scale.copy_(new_scale)
    return pool, scale


def paged_view(
    pool: torch.Tensor,
    page_table: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The pool gathered through the table into ``(num_slots,
    pages_per_slot * page_size, heads, head_dim)``; dequantized to fp32
    with ``scale``; cast to ``out_dtype`` if given. Unmapped entries
    clamp onto the last pool page (reads are bounded by lengths)."""
    num_pages, heads, page_size, head_dim = pool.shape
    num_slots, pages_per_slot = page_table.shape
    tab = page_table.to(torch.long).clamp(0, num_pages - 1)
    g = pool[tab]  # (slots, P, heads, ps, hd)
    if scale is not None:
        g = g.float() * scale[tab][:, :, :, None, None]
    g = g.transpose(2, 3).reshape(
        num_slots, pages_per_slot * page_size, heads, head_dim
    )
    if out_dtype is not None:
        g = g.to(out_dtype)
    return g


def paged_fork(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy page ``src`` onto page ``dst``, in place."""
    pool[dst].copy_(pool[src])
    return pool
