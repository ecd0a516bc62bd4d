"""Paged KV cache: block tables, int8 per-page scales, prefix sharing.

Port of ``rocm_apex_tpu/inference/paging.py``. All slots draw fixed-size
pages from one shared pool per layer, and a ``(num_slots,
pages_per_slot)`` int32 table maps each slot's positions onto pool
pages, so cache memory follows live tokens rather than slots x capacity.
Pools may be int8 with one fp32 scale per (page, head), and a prefix
store lets a request whose prompt extends an already-materialized chain
of pages map those pages by reference (copy-on-write when it would write
into one).

`PageAllocator` and `PrefixStore` are host-only bookkeeping, copied from
the JAX package (whose module imports jax at the top). `PagedKVCache` is
the device half: per-layer pools, scales, the table and the lengths, as
torch tensors. Its writes happen IN PLACE (`ops.paging`), as
`KVCache`'s do, and keep `KVCache`'s signatures, so the model's cached
attention calls one protocol for both layouts. The engine is the only
place the two halves meet: it owns the table's host mirror and pushes it
to the device when it changed.
"""

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.ops.paging import (
    PagedRows,
    paged_fork,
    paged_rows,
    paged_scatter,
    quantized_paged_scatter,
)

__all__ = ["PageAllocator", "PrefixStore", "PagedKVCache"]


class PageAllocator:
    """Host-side free-list + ref-count bookkeeping for the page pool.

    Pages are integers in ``[0, num_pages)``. A mapped page holds one
    ref per slot whose table points at it (prefix sharing = ref > 1).
    When the last ref drops the page either returns to the free list
    or — if it is registered in a `PrefixStore` — is PARKED on a
    reclaimable LRU: its bytes stay valid so a later request with the
    same prefix can revive it for free, but allocation pressure may
    reclaim it at any time (``on_evict`` fires so the store entry is
    dropped in the same motion). Allocation NEVER raises on
    exhaustion: ``alloc`` returns None and the engine backpressures
    (the request waits in prefill; nothing crashes).
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: collections.deque = collections.deque(range(num_pages))
        self._ref = [0] * num_pages
        # insertion order = LRU order (parked pages re-park at the end)
        self._parked: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )
        # called with the page id when a PARKED page is reclaimed for a
        # fresh allocation (the engine unregisters it from the store)
        self.on_evict = None

    @property
    def available(self) -> int:
        return len(self._free) + len(self._parked)

    @property
    def pages_used(self) -> int:
        """Pages currently holding a reference (live mappings only —
        parked prefix-cache pages are reclaimable, not 'used')."""
        return self.num_pages - self.available

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n fresh pages (ref = 1 each), or None if fewer than n are
        available — all-or-nothing, so a partial grab never deadlocks
        two half-satisfied requests."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if self.available < n:
            return None
        out = []
        for _ in range(n):
            if self._free:
                page = self._free.popleft()
            else:
                page, _ = self._parked.popitem(last=False)  # LRU
                if self.on_evict is not None:
                    self.on_evict(page)
            self._ref[page] = 1
            out.append(page)
        return out

    def ref(self, page: int) -> None:
        """Add a reference — reviving the page off the parked LRU if a
        prefix match picked it up there."""
        if self._ref[page] == 0:
            if page not in self._parked:
                raise ValueError(
                    f"page {page} is free, not shareable; alloc() it"
                )
            del self._parked[page]
        self._ref[page] += 1

    def decref(self, page: int, park: bool = False) -> None:
        """Drop one reference. At zero the page returns to the free
        list, or parks on the reclaimable LRU when ``park`` (the
        engine parks store-registered pages). Refs can never go
        negative — that is a corrupted table, not a recoverable
        state."""
        if self._ref[page] <= 0:
            raise RuntimeError(
                f"page {page} decref below zero (double free)"
            )
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if park:
                self._parked[page] = None
            else:
                self._free.append(page)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def snapshot(self) -> Dict[str, int]:
        """Counters for leak checks: a drained engine must return to
        the baseline snapshot (every page free or parked, no refs)."""
        return {
            "free": len(self._free),
            "parked": len(self._parked),
            "available": self.available,
            "refs": sum(self._ref),
        }

    def assert_consistent(self) -> None:
        """The allocator invariants, as one assertable check:

        * free, parked, and referenced pages partition the pool
          (no page in two states, none lost);
        * no parked or free page holds a reference;
        * no referenced page sits on the free list or the parked LRU.

        Raises AssertionError naming the corrupted page otherwise."""
        free = set(self._free)
        parked = set(self._parked)
        assert len(free) == len(self._free), (
            f"free list holds duplicates: {sorted(self._free)}"
        )
        assert not (free & parked), (
            f"pages both free and parked: {sorted(free & parked)}"
        )
        for page in range(self.num_pages):
            refs = self._ref[page]
            assert refs >= 0, f"page {page} has negative refs ({refs})"
            if page in free or page in parked:
                assert refs == 0, (
                    f"page {page} is free/parked with refs={refs}"
                )
            else:
                assert refs > 0, (
                    f"page {page} leaked: not free, not parked, "
                    f"refs=0"
                )


class _StoreEntry:
    __slots__ = ("key", "parent", "tokens", "page")

    def __init__(self, key, parent, tokens, page):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.page = page


class PrefixStore:
    """Chain-hash registry of immutable, fully-written prompt pages.

    A page is registerable once it holds ``page_size`` PROMPT tokens
    (appends only ever land past a full page, so its bytes are final;
    pages mixing prompt and generated tokens are never registered).
    The key of a page is the chain ``(parent_key, its page_size token
    ids)`` — two requests share a page only if their ENTIRE token
    history up to that page matches, which is exactly the condition
    under which the K/V bytes are identical (absolute positions).

    `match` walks a prompt down the chain: full-page hits map by
    reference; after the last full hit, the longest token-level prefix
    of any CHILD page is matched PARTIALLY — the borrower reads the
    shared page's first j rows and must copy-on-write before its own
    tokens land in that page. At least one prompt token is always left
    unmatched (the final token must run through the model to produce
    the first sampled logits).
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._by_chain: Dict[Any, _StoreEntry] = {}
        # a parent's children in registration order (the JAX store keeps
        # a set): a tie between partial matches goes to the oldest page
        self._children: Dict[Any, Dict[_StoreEntry, None]] = {}
        self._by_page: Dict[int, _StoreEntry] = {}

    def __len__(self) -> int:
        return len(self._by_page)

    def is_registered(self, page: int) -> bool:
        return page in self._by_page

    def register(
        self, parent_key, tokens: Sequence[int], page: int
    ):
        """Register a full page (its ``page_size`` token ids) under
        ``parent_key`` (None for the first page of a prompt); returns
        the new chain key for the NEXT page's parent. First
        registration wins: a duplicate chain keeps the existing page
        (the caller's page simply stays private)."""
        tokens = tuple(int(t) for t in tokens)
        if len(tokens) != self.page_size:
            raise ValueError(
                f"register needs exactly page_size={self.page_size} "
                f"tokens, got {len(tokens)}"
            )
        key = (parent_key, tokens)
        if key in self._by_chain:
            return key
        entry = _StoreEntry(key, parent_key, tokens, page)
        self._by_chain[key] = entry
        self._children.setdefault(parent_key, {})[entry] = None
        self._by_page[page] = entry
        return key

    def chain_key(self, parent_key, tokens: Sequence[int]):
        """The key `register` would produce — lets a slot continue a
        chain it is re-walking without registering anything."""
        return (parent_key, tuple(int(t) for t in tokens))

    def unregister_page(self, page: int) -> None:
        entry = self._by_page.pop(page, None)
        if entry is None:
            return
        del self._by_chain[entry.key]
        kids = self._children.get(entry.parent)
        if kids is not None:
            kids.pop(entry, None)
            if not kids:
                del self._children[entry.parent]
        # orphaned descendants (their parent chain is gone) can no
        # longer be matched — drop them so they do not pin pages
        for child in list(self._children.get(entry.key, ())):
            self.unregister_page(child.page)

    def match(
        self, prompt: Sequence[int]
    ) -> Tuple[List[int], int, int, Any]:
        """Longest shared prefix of ``prompt`` already materialized.

        Returns ``(pages, matched_tokens, partial_tokens, chain_key)``:
        the shared pages in order, how many prompt tokens they cover
        (``< len(prompt)``), how many of those are a PARTIAL borrow of
        the last page (0 = every matched page is fully covered), and
        the chain key of the last FULL page matched (the parent under
        which the borrower registers its next full page).
        """
        ps = self.page_size
        limit = len(prompt) - 1  # leave >= 1 token to prefill
        pages: List[int] = []
        key = None
        m = 0
        while m + ps <= limit:
            entry = self._by_chain.get(
                (key, tuple(int(t) for t in prompt[m:m + ps]))
            )
            if entry is None:
                break
            pages.append(entry.page)
            key = entry.key
            m += ps
        best = None
        best_len = 0
        rest = [int(t) for t in prompt[m:limit]]
        if rest:
            for child in self._children.get(key, ()):
                n = 0
                for a, b in zip(child.tokens, rest):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best, best_len = child, n
        if best is not None:
            pages.append(best.page)
            m += best_len
        return pages, m, best_len, key


@dataclasses.dataclass
class PagedKVCache:
    """The device half of the paged cache.

    ``k``/``v``: one pool per layer, ``(num_pages, heads, page_size,
    head_dim)`` (heads ahead of the page rows: one (page, head) tile is
    ``page_size`` rows ``head_dim`` apart). ``k_scale``/``v_scale``: one
    ``(num_pages, heads)`` fp32 tensor per layer when the pools are int8,
    else None. ``page_table``: ``(num_slots, pages_per_slot)`` int32,
    unmapped entries hold the sentinel ``num_pages`` (writes there
    drop). ``lengths`` as in `KVCache`. ``host_capacity``: the capacity
    the cache was made for (the engine's host bound; `capacity` rounds
    it up to whole pages), on which the paged decode reads bound and
    split their keys (None: `capacity`).
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]]
    v_scale: Optional[List[torch.Tensor]]
    page_table: torch.Tensor
    lengths: torch.Tensor
    page_size: int = 16
    host_capacity: Optional[int] = None

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_slots: int,
        capacity: int,
        num_heads: int,
        head_dim: int,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        quantized: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "PagedKVCache":
        """Pools for ``capacity`` rows per slot, rounded up to whole
        pages; ``num_pages`` defaults to the worst case (every slot
        full)."""
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        dev = resolve_device(device)
        pool_dtype = torch.int8 if quantized else dtype
        pages_per_slot = -(-capacity // page_size)  # ceil
        if num_pages is None:
            num_pages = num_slots * pages_per_slot
        shape = (num_pages, num_heads, page_size, head_dim)

        def pools(dt):
            return [torch.zeros(shape, dtype=dt, device=dev)
                    for _ in range(num_layers)]

        def scales():
            return [torch.zeros((num_pages, num_heads), dtype=torch.float32,
                                device=dev) for _ in range(num_layers)]

        return cls(
            k=pools(pool_dtype),
            v=pools(pool_dtype),
            k_scale=scales() if quantized else None,
            v_scale=scales() if quantized else None,
            page_table=torch.full((num_slots, pages_per_slot), num_pages,
                                  dtype=torch.int32, device=dev),
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
            page_size=page_size,
            host_capacity=capacity,
        )

    @classmethod
    def for_model(
        cls,
        cfg,
        num_slots: int,
        capacity: Optional[int] = None,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        quantized: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "PagedKVCache":
        """Paged cache sized for a `GPTConfig` (tensor-parallel world
        size 1), float pools in the compute dtype unless ``dtype`` says
        otherwise."""
        return cls.create(
            cfg.num_layers,
            num_slots,
            capacity or cfg.max_position_embeddings,
            cfg.num_attention_heads,
            cfg.head_dim,
            page_size=page_size,
            num_pages=num_pages,
            dtype=dtype if dtype is not None else cfg.dtype,
            quantized=quantized,
            device=device,
        )

    @property
    def num_layers(self) -> int:
        return len(self.k)

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def num_pages(self) -> int:
        return self.k[0].shape[0]

    @property
    def capacity(self) -> int:
        """Rows addressable per slot. May exceed a requested capacity
        that page_size does not divide (the engine's host bound stays
        authoritative)."""
        return self.pages_per_slot * self.page_size

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def cache_bytes(self) -> int:
        """Device bytes this cache allocates: pools, scales, the table
        and the lengths."""
        tensors = [*self.k, *self.v, *(self.k_scale or ()),
                   *(self.v_scale or ()), self.page_table, self.lengths]
        return sum(t.numel() * t.element_size() for t in tensors)

    def _scatter(self, layer, slots, positions, k_new, v_new, rows=None):
        if rows is None:
            rows = paged_rows(self.page_table, slots, positions,
                              self.page_size, self.num_pages)
        if self.quantized:
            quantized_paged_scatter(self.k[layer], self.k_scale[layer],
                                    self.page_table, slots, positions,
                                    k_new, rows)
            quantized_paged_scatter(self.v[layer], self.v_scale[layer],
                                    self.page_table, slots, positions,
                                    v_new, rows)
        else:
            paged_scatter(self.k[layer], self.page_table, slots, positions,
                          k_new, rows)
            paged_scatter(self.v[layer], self.page_table, slots, positions,
                          v_new, rows)
        return self

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor
              ) -> "PagedKVCache":
        """`KVCache.write` semantics — ``(num_slots, t, heads, hd)`` new
        rows land at each slot's current length — through the table.
        Positions at or past capacity DROP (a paged write never clamps
        into a live page); lengths do not advance."""
        num_slots, t, h, hd = k_new.shape
        dev = self.lengths.device
        slots = torch.arange(num_slots, dtype=torch.int32,
                             device=dev).repeat_interleave(t)
        positions = (self.lengths[:, None]
                     + torch.arange(t, dtype=torch.int32, device=dev)
                     ).reshape(-1)
        return self._scatter(layer, slots, positions,
                             k_new.reshape(num_slots * t, h, hd),
                             v_new.reshape(num_slots * t, h, hd))

    def write_at(
        self,
        layer: int,
        slots: torch.Tensor,
        positions: torch.Tensor,
        k_new: torch.Tensor,
        v_new: torch.Tensor,
        rows: Optional[PagedRows] = None,
    ) -> "PagedKVCache":
        """`KVCache.write_at` semantics (a packed chunk at per-token
        destinations; pads carry slot id >= num_slots and drop) through
        the table; int8 pools through `quantized_paged_scatter`.
        ``rows``: the destinations resolved already (`host_rows`). As
        the speculative engine's deferred commit, a rejected draft row
        is never scattered: it can never have touched a shared page or
        raised an int8 page's scale."""
        return self._scatter(layer, slots, positions, k_new, v_new, rows)

    def host_rows(self, slots: np.ndarray, positions: np.ndarray,
                  table: np.ndarray):
        """`ops.paging.paged_rows`' drop rule on host-held destinations,
        through ``table`` (the engine's host mirror of `page_table`, equal
        to it), in numpy: ``(keep, pages, offsets)``. With `rows_from`
        the engine resolves a write without reading a device value."""
        slots, positions = np.asarray(slots), np.asarray(positions)
        ps = self.page_size
        valid = np.flatnonzero((slots >= 0) & (slots < self.num_slots)
                               & (positions >= 0)
                               & (positions < self.capacity))
        pages = table[slots[valid], positions[valid] // ps]
        mapped = (pages >= 0) & (pages < self.num_pages)
        keep = valid[mapped]
        return keep, pages[mapped], positions[keep] % ps

    @staticmethod
    def rows_from(slots, positions, keep, pages, offsets) -> PagedRows:
        """`PagedRows` of device tensors: `host_rows`' arrays sent to the
        device, with ``slots`` the segment ids of the rows."""
        return PagedRows(slots, keep.long(), pages.long(), offsets.long(),
                         positions)

    def advance(self, t: int, active: Optional[torch.Tensor] = None
                ) -> "PagedKVCache":
        """Lengths += t, clamped to capacity; only ``active`` slots when
        given. The engine never lets a live request reach capacity."""
        new = torch.clamp(self.lengths + t, max=self.capacity)
        if active is not None:
            new = torch.where(active, new, self.lengths)
        self.lengths = new.to(torch.int32)
        return self

    def reset_slot(self, slot: int) -> "PagedKVCache":
        """Forget a slot's length. Its table row is host state: the
        engine sentinels its mirror and pushes it with the next step."""
        self.lengths[slot] = 0
        return self

    def fork_page(self, src: int, dst: int) -> "PagedKVCache":
        """Copy-on-write, device half: page ``src`` onto ``dst`` in every
        layer's pools and scales."""
        for bufs in (self.k, self.v, self.k_scale or (), self.v_scale or ()):
            for buf in bufs:
                paged_fork(buf, src, dst)
        return self
