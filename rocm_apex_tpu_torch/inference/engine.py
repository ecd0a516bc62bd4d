"""Continuous-batching generation engine over the KV-cached GPT.

Port of the core of ``rocm_apex_tpu/inference/engine.py``: a fixed grid
of batch slots (the preallocated `KVCache`), a host-side request queue,
per-tick admit/evict, and the CHUNKED-prefill scheduler. Each tick packs
up to ``prefill_token_budget`` pending prompt tokens — pieces of one or
more prompts, tracked by a per-slot prefill cursor — into one
``(budget,)`` buffer with per-token slot ids and positions, and runs one
MIXED step: the packed chunk through the model (`GPTModel` ``chunk=``
path), then the whole decode grid. A prompt that completes in the tick
has its first sampled token fed straight into the same tick's decode
grid. Ticks with no pending prompt token take the decode-only path.

Inactive slots ride along as dead rows: their sampled tokens are
discarded, their cache writes land in rows no live request reads (on a
paged cache they sit at capacity and drop), and their lengths are
pinned. The host's cursors are the truth for the lengths a mixed step
starts from.

``prefill_token_budget=None`` is the legacy whole-prompt path, the A/B
baseline of ``bench.py serve`` (the JAX engine's `_step_whole`): each
admitted request runs one padded ``(1, max_prompt_len)`` prefill through
a one-slot view of the contiguous cache (the model's causal unpacked
flash forward over the window), its first token sampled at ``length -
1``; the slot's length is then set to the real prompt length (decode
overwrites the pad rows); one host fetch takes every admit's first token,
then one decode step runs the grid. Every other slot's decode waits on
the admits: the head-of-line blocking the chunked scheduler removes.

``paged=True`` serves from a `PagedKVCache` (``page_size``,
``num_pages``; ``kv_dtype=torch.int8`` for int8 pools with per-(page,
head) scales, or a float dtype for the pools): the engine owns the page
table's host mirror (pushed to the device once per tick when it
changed), allocates pages as prompts and generations grow, backpressures
a slot whose page the pool cannot supply (``page_stalls``), and breaks a
pool deadlock by preempting the youngest page-holding request, whose
tokens are kept and whose cache is recomputed on re-admission.
``prefix_sharing=True`` maps a prompt's already-materialized page chain
by reference (`PrefixStore`) and copy-on-write forks a borrowed page
before the borrower writes into it.

Not ported yet, and refused at construction: speculative decoding
(``spec_k``; with it the speculative commits into pages), the fault
harness (``faults``; with it the ``page_alloc`` site), multi-LoRA
(``adapter_pool``; with it tier preemption), tracing and the metric
registry (``tracer``, ``registry``), tensor parallelism (tp>1
head-sharded pools) and page shipping between engines. A row whose
logits are not finite is quarantined (finish reason ``error``), as the
JAX engine does.

Sampling draws from an engine-owned `torch.Generator` seeded with
``seed``: a fixed seed replays the same stream on one device, but not
the JAX engine's stream. Greedy decoding draws nothing.
"""

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from rocm_apex_tpu_torch.inference.kv_cache import KVCache
from rocm_apex_tpu_torch.inference.paging import (
    PageAllocator,
    PagedKVCache,
    PrefixStore,
)
from rocm_apex_tpu_torch.inference.sampling import sample

__all__ = [
    "SamplingParams",
    "Request",
    "GenerationResult",
    "InferenceEngine",
    "FINISH_REASONS",
]

FINISH_REASONS = ("eos", "length", "capacity", "error")

_NOT_PORTED = (
    "{what} is not ported yet (ROADMAP Queue 1, {item}); the engine "
    "serves the contiguous or the paged cache with the chunked scheduler, "
    "and the contiguous one on the whole-prompt path"
)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling config, fixed per engine. ``temperature=0`` is greedy."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    # enqueue wall time (perf_counter): the queue-wait and TTFT anchor
    enqueued_at: float = 0.0


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]  # generated ids (includes the eos when hit)
    finish_reason: str  # one of FINISH_REASONS


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one leased cache slot."""

    req: Request
    generated: List[int]
    pos: int = 0  # tokens materialized in the cache for this slot
    cursor: int = 0  # prefix tokens committed to the cache so far
    # the tokens to prefill before decoding: the prompt, or for a
    # request re-admitted after preemption prompt + generated[:-1]
    prefix: List[int] = dataclasses.field(default_factory=list)
    resumed: bool = False  # re-admitted after preemption mid-decode
    leased_at: float = 0.0
    first_token_at: float = 0.0
    chunks: int = 0  # mixed ticks that carried this prompt
    # paged cache: page indices borrowed from the prefix store (shared
    # until a copy-on-write fork), the chain key of the last full prompt
    # page walked or registered, and how many full prompt pages that is
    borrowed: Set[int] = dataclasses.field(default_factory=set)
    chain_key: Any = None
    reg_pages: int = 0

    @property
    def prefilling(self) -> bool:
        return self.cursor < len(self.prefix)


class InferenceEngine:
    """Continuous-batching serving loop for a `GPTModel`.

    ``model`` is the port's `GPTModel` with its weights loaded (see
    `rocm_apex_tpu_torch.convert`); the engine runs on the model's
    device; the cache is in the model's compute dtype (a paged cache's
    float pools in ``kv_dtype`` if given).
    ``prefill_token_budget`` is the prompt tokens absorbed per tick
    across requests (None: the whole-prompt path, prompts padded to
    ``max_prompt_len``, default the capacity); ``prefill_chunk``
    optionally caps one request's share of it.
    """

    # consecutive ticks without token progress before generate() gives up
    _GENERATE_STALL_TICKS = 1000
    # per-request samples kept for the exact percentiles of stats()
    _STATS_RETENTION = 4096

    def __init__(
        self,
        model,
        *,
        num_slots: int = 8,
        max_prompt_len: Optional[int] = None,
        capacity: Optional[int] = None,
        eos_id: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        prefill_token_budget: Optional[int] = 64,
        prefill_chunk: Optional[int] = None,
        paged: bool = False,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        kv_dtype: Optional[torch.dtype] = None,
        prefix_sharing: bool = False,
        spec_k: int = 0,
        faults=None,
        adapter_pool=None,
        tracer=None,
        registry=None,
    ):
        refused = [
            (spec_k, "speculative decoding (spec_k), and with it "
             "speculative commits into pages", "item 6"),
            (faults is not None, "the fault harness (faults), and with "
             "it the page_alloc site", "item 6"),
            (adapter_pool is not None, "multi-LoRA serving (adapter_pool)"
             ", and with it tier preemption", "item 6"),
            (tracer is not None or registry is not None,
             "request tracing and the metric registry", "item 7"),
        ]
        for asked, what, item in refused:
            if asked:
                raise NotImplementedError(
                    _NOT_PORTED.format(what=what, item=item)
                )
        cfg = model.cfg
        self.model = model
        self.device = model.device
        self.capacity = int(capacity or cfg.max_position_embeddings)
        if self.capacity > cfg.max_position_embeddings:
            raise ValueError(
                f"capacity {self.capacity} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}"
            )
        self.max_prompt_len = int(max_prompt_len or self.capacity)
        if not 0 < self.max_prompt_len <= self.capacity:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must be in "
                f"(0, capacity={self.capacity}]"
            )
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget must be >= 1 (or None for the "
                f"whole-prompt path), got {prefill_token_budget}"
            )
        self.prefill_token_budget = (
            int(prefill_token_budget) if prefill_token_budget is not None
            else None
        )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.eos_id = eos_id
        self.sampling = sampling or SamplingParams()
        self.paged = bool(paged)
        self.prefix_sharing = bool(prefix_sharing)
        self._allocator: Optional[PageAllocator] = None
        self._store: Optional[PrefixStore] = None
        # preempted-request carryover: request_id -> (generated tokens,
        # first_token_at, chunk count), restored on re-admission
        self._preempted: Dict[int, Any] = {}
        if not self.paged:
            if prefix_sharing:
                raise ValueError("prefix_sharing requires paged=True")
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype requires paged=True (the contiguous cache is "
                    "in the model's compute dtype)"
                )
            self.cache = KVCache.for_model(
                cfg, num_slots, self.capacity, device=self.device
            )
        else:
            if self.prefill_token_budget is None:
                raise ValueError(
                    "the paged cache serves the chunked-prefill scheduler "
                    "only (the legacy whole-prompt path needs contiguous "
                    "slot rows); set prefill_token_budget"
                )
            quantized = kv_dtype == torch.int8
            self.cache = PagedKVCache.for_model(
                cfg, num_slots, self.capacity, page_size=page_size,
                num_pages=num_pages,
                dtype=None if quantized else kv_dtype,
                quantized=quantized, device=self.device,
            )
            self._allocator = PageAllocator(self.cache.num_pages)
            if prefix_sharing:
                self._store = PrefixStore(page_size)
                self._allocator.on_evict = self._store.unregister_page
            # the page table's host mirror, the source of truth, pushed
            # to the device once per tick when it changed
            self._table = np.full(
                (num_slots, self.cache.pages_per_slot),
                self.cache.num_pages, np.int32,
            )
            self._table_dirty = False
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._queue: Deque[Request] = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._next_id = 0
        self.reset_stats()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def chunked(self) -> bool:
        """The chunked scheduler (a token budget), not the whole-prompt
        path."""
        return self.prefill_token_budget is not None

    @property
    def num_slots(self) -> int:
        return len(self._slots)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    def has_work(self) -> bool:
        return bool(self._queue) or self.num_active > 0

    @property
    def completions(self) -> List[Dict[str, float]]:
        """Per-request completion records in finish order:
        ``request_id``, ``finish_reason``, ``prompt_tokens``,
        ``new_tokens``, ``chunks``, ``queue_wait_ms``, ``ttft_ms``,
        ``tpot_ms`` (mean inter-token time after the first), ``e2e_ms``."""
        return list(self._completions)

    def reset_stats(self) -> None:
        """Zero the counters and per-request samples (the cache and the
        queue are untouched): a benchmark warms up, resets, then times."""
        self._admitted = 0
        self._evicted = 0
        self._quarantined = 0
        self._prompt_tokens = 0
        self._generated_tokens = 0
        self._prefill_seconds = 0.0
        self._decode_seconds = 0.0
        self._decode_steps = 0  # ticks that ran the decode grid
        self._decode_only_steps = 0
        self._mixed_steps = 0
        self._cow_forks = 0
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0
        self._page_stalls = 0
        self._preemptions = 0
        self._queue_waits: Deque[float] = collections.deque(
            maxlen=self._STATS_RETENTION
        )
        self._ttfts: Deque[float] = collections.deque(
            maxlen=self._STATS_RETENTION
        )
        self._completions: Deque[Dict[str, float]] = collections.deque(
            maxlen=self._STATS_RETENTION
        )

    def stats(self) -> Dict[str, float]:
        """Serving telemetry as one flat name -> float dict: the gauges
        ``queue_depth``, ``slots_active``, ``slot_occupancy``; the
        counters ``admitted``, ``evicted``, ``quarantined``,
        ``prompt_tokens``, ``generated_tokens``, ``mixed_steps`` (ticks
        that carried prompt tokens), ``decode_steps`` (ticks that ran the
        decode grid, mixed ones included), ``decode_only_steps``; the
        mean host time of a mixed tick (``prefill_ms_avg``; on the
        whole-prompt path, of one admit's prefill) and of a decode-only
        tick (``decode_ms_avg``), tokens/s over each phase's time; and the
        exact percentiles ``queue_wait_ms_p50/95`` (enqueue -> slot
        lease) and ``ttft_ms_p50/95`` (enqueue -> first token) over the
        newest ``_STATS_RETENTION`` requests. The paged cache's gauges
        ``pages_total``, ``pages_used``, ``page_occupancy``,
        ``shared_page_ratio`` (mapped table entries on a page with more
        than one reference) and counters ``cow_forks``, ``prefix_hits``,
        ``prefix_hit_tokens``, ``page_stalls``, ``preemptions`` are zeros
        on the contiguous cache."""

        def pct_ms(samples, q):
            if not samples:
                return 0.0
            return 1e3 * float(np.percentile(np.asarray(samples), q))

        pages_total = float(self.cache.num_pages) if self.paged else 0.0
        pages_used = float(self.pages_used)
        shared_ratio = 0.0
        if self.paged:
            mapped = self._table[self._table != self.cache.num_pages]
            if mapped.size:
                shared = sum(1 for p in mapped
                             if self._allocator.refcount(int(p)) > 1)
                shared_ratio = shared / mapped.size
        decode_generated = self._generated_tokens - self._admitted
        prefill_ticks = self._mixed_steps if self.chunked else self._admitted
        return {
            "pages_total": pages_total,
            "pages_used": pages_used,
            "page_occupancy": (pages_used / pages_total if pages_total
                               else 0.0),
            "shared_page_ratio": shared_ratio,
            "cow_forks": float(self._cow_forks),
            "prefix_hits": float(self._prefix_hits),
            "prefix_hit_tokens": float(self._prefix_hit_tokens),
            "page_stalls": float(self._page_stalls),
            "preemptions": float(self._preemptions),
            "queue_depth": float(self.num_queued),
            "slots_active": float(self.num_active),
            "slot_occupancy": self.num_active / self.num_slots,
            "admitted": float(self._admitted),
            "evicted": float(self._evicted),
            "quarantined": float(self._quarantined),
            "prompt_tokens": float(self._prompt_tokens),
            "generated_tokens": float(self._generated_tokens),
            "decode_steps": float(self._decode_steps),
            "mixed_steps": float(self._mixed_steps),
            "decode_only_steps": float(self._decode_only_steps),
            "prefill_ms_avg": (
                1e3 * self._prefill_seconds / prefill_ticks
                if prefill_ticks else 0.0
            ),
            "decode_ms_avg": (
                1e3 * self._decode_seconds / self._decode_only_steps
                if self._decode_only_steps else 0.0
            ),
            "prefill_tokens_per_sec": (
                self._prompt_tokens / self._prefill_seconds
                if self._prefill_seconds > 0 else 0.0
            ),
            "decode_tokens_per_sec": (
                decode_generated / self._decode_seconds
                if self._decode_seconds > 0 else 0.0
            ),
            "queue_wait_ms_p50": pct_ms(self._queue_waits, 50),
            "queue_wait_ms_p95": pct_ms(self._queue_waits, 95),
            "ttft_ms_p50": pct_ms(self._ttfts, 50),
            "ttft_ms_p95": pct_ms(self._ttfts, 95),
        }

    def cache_bytes(self) -> int:
        """Device bytes the KV cache holds: buffers or pools, scales,
        the page table and the lengths."""
        if self.paged:
            return self.cache.cache_bytes()
        c = self.cache
        return sum(t.numel() * t.element_size()
                   for t in (*c.k, *c.v, c.lengths))

    @property
    def pages_used(self) -> int:
        """Pages holding a live mapping (0 on the contiguous cache)."""
        return self._allocator.pages_used if self.paged else 0

    def add_request(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        request_id: Optional[int] = None,
    ) -> int:
        """Queue a prompt; returns the request id. A later `step`
        leases it a free slot and streams its prompt through the
        prefill budget. A prompt must fit in ``capacity`` cache rows."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) > self.capacity:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the cache "
                f"capacity {self.capacity} (rows per slot)"
            )
        if not self.chunked and len(prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the whole-prompt "
                f"pad width max_prompt_len={self.max_prompt_len}; the "
                f"chunked engine (prefill_token_budget) streams prompts of "
                f"any length"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        self._queue.append(
            Request(request_id, prompt, int(max_new_tokens),
                    enqueued_at=time.perf_counter())
        )
        return request_id

    def step(self) -> List[GenerationResult]:
        """One engine tick. Chunked: admit queued requests into free
        slots, pack up to the token budget of pending prompt tokens, run
        the mixed chunk+decode step (or the decode-only step when nothing
        is prefilling). Whole-prompt: one padded prefill per admit, then
        the decode step. Returns the requests that finished this tick;
        their slots are already free for the next."""
        if self.chunked:
            return self._step_chunked()
        return self._step_whole()

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int
    ) -> List[GenerationResult]:
        """Queue every prompt, run the loop dry, and return the results
        in prompt order. Raises after ``_GENERATE_STALL_TICKS`` ticks in
        a row without token progress."""
        ids = [self.add_request(p, max_new_tokens) for p in prompts]
        done: Dict[int, GenerationResult] = {}
        stale = 0
        mark = (self._prompt_tokens, self._generated_tokens, self._evicted)
        while self.has_work():
            results = self.step()
            for r in results:
                done[r.request_id] = r
            work = (self._prompt_tokens, self._generated_tokens,
                    self._evicted)
            if results or work != mark:
                stale, mark = 0, work
                continue
            stale += 1
            if stale >= self._GENERATE_STALL_TICKS:
                raise RuntimeError(
                    f"generate() stalled: {stale} consecutive ticks "
                    f"without token progress"
                )
        return [done[i] for i in ids]

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor):
        """Tokens and per-row nonfinite flags for ``(rows, vocab)``."""
        sp = self.sampling
        bad = ~torch.isfinite(logits).all(dim=-1)
        tok = sample(logits, sp.temperature, sp.top_k, sp.top_p,
                     generator=self._gen)
        return tok, bad

    def _decode_body(self, tokens, active):
        """The decode grid: every slot writes its token at its length
        and reads its prefix; inactive slots' lengths are pinned. On a
        paged cache a dead row runs at the device capacity, so its write
        drops: at its own length it could land in a live page, maybe a
        shared one, and raise an int8 page's scale."""
        lengths0 = self.cache.lengths
        if self.paged:
            self.cache.lengths = torch.where(
                active, lengths0, self.cache.capacity
            ).to(torch.int32)
        logits, _ = self.model(tokens[:, None], cache=self.cache)
        self.cache.lengths = torch.where(active, self.cache.lengths, lengths0)
        tok, bad = self._sample(logits[:, -1, :])
        return torch.where(active, tok, 0), bad

    @torch.no_grad()
    def _mixed(self, chunk_tokens, chunk_slots, chunk_pos, lengths_before,
               lengths_after, completion_idx, dec_tokens, dec_active):
        """The packed prompt chunk, then the whole decode grid, with the
        first token of every prompt that completed fed straight in."""
        t = self._tensor
        self.cache.lengths = t(lengths_before)
        logits_c, _ = self.model(
            t(chunk_tokens)[None, :], cache=self.cache,
            chunk=(t(chunk_slots), t(chunk_pos)),
        )
        chunk_tok, chunk_bad = self._sample(logits_c[0])
        # commit the chunk: cursors advance by what was packed
        self.cache.lengths = t(lengths_after)
        comp = t(completion_idx)
        has_comp = comp >= 0
        first_tok = chunk_tok[comp.clamp(0, chunk_tokens.shape[0] - 1)]
        dec = torch.where(has_comp, first_tok, t(dec_tokens))
        dec_tok, dec_bad = self._decode_body(dec, t(dec_active) | has_comp)
        # ONE fetch per tick (the device sync)
        out = torch.stack([
            torch.cat([chunk_tok, dec_tok]),
            torch.cat([chunk_bad, dec_bad]).to(chunk_tok.dtype),
        ]).cpu().numpy()
        b = chunk_tokens.shape[0]
        return out[0, :b], out[0, b:], out[1, :b] != 0, out[1, b:] != 0

    @torch.no_grad()
    def _prefill(self, tokens: np.ndarray, slot: int, length: int):
        """One request's padded ``(1, max_prompt_len)`` prompt through a
        one-slot view of the cache (JAX engine.py:839-857): the model
        writes the window's K/V at rows ``[0, max_prompt_len)`` and
        advances the view by the padded width; the slot's length is then
        the real prompt's, so decode overwrites the pad rows and never
        reads them. Returns the first token, sampled from the logits at
        ``length - 1``, as a device tensor (no sync)."""
        sub = self.cache.slot_view(slot)
        sub.lengths = torch.zeros_like(sub.lengths)
        logits, sub = self.model(self._tensor(tokens), cache=sub)
        sub.lengths = torch.full_like(sub.lengths, length)
        self.cache.write_back(slot, sub)
        tok, _ = self._sample(logits[0, length - 1][None, :])
        return tok

    @torch.no_grad()
    def _decode(self, dec_tokens, dec_active):
        tok, bad = self._decode_body(
            self._tensor(dec_tokens), self._tensor(dec_active)
        )
        out = torch.stack([tok, bad.to(tok.dtype)]).cpu().numpy()
        return out[0], out[1] != 0

    # ------------------------------------------------------------------
    # the chunked scheduler
    # ------------------------------------------------------------------

    def _admit_free_slots(self, now: float) -> None:
        """Lease free slots to queued requests. A preempted request gets
        its tokens back and recomputes prompt + generated[:-1]; with
        prefix sharing, a prompt that extends a materialized page chain
        maps those pages by reference and starts past them."""
        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._admitted += 1
            self._queue_waits.append(now - req.enqueued_at)
            st = _Slot(req=req, generated=[], prefix=list(req.prompt),
                       leased_at=now)
            carried = self._preempted.pop(req.request_id, None)
            if carried is not None:
                generated, first_at, chunks = carried
                st.generated = list(generated)
                st.first_token_at = first_at
                st.chunks = chunks
                if generated:
                    # the last generated token stays unwritten, as in a
                    # live slot: it is the next decode's input
                    st.prefix = list(req.prompt) + list(generated[:-1])
                    st.resumed = True
            self._slots[slot] = st
            if self._store is None:
                continue
            pages, matched, partial, key = self._store.match(req.prompt)
            if matched > 0:
                for idx, page in enumerate(pages):
                    self._allocator.ref(page)
                    self._map_page(slot, idx, page)
                    st.borrowed.add(idx)
                st.cursor = st.pos = matched
                st.chain_key = key
                st.reg_pages = len(pages) - (1 if partial else 0)
                self._prefix_hits += 1
                self._prefix_hit_tokens += matched

    # -- the paged cache's host bookkeeping ------------------------------

    def _page_registered(self, page: int) -> bool:
        return self._store is not None and self._store.is_registered(page)

    def _map_page(self, slot: int, idx: int, page: int) -> None:
        self._table[slot, idx] = page
        self._table_dirty = True

    def _push_table(self) -> None:
        """The host mirror to the device table: one copy, only when the
        mapping changed."""
        if self._table_dirty:
            self.cache.page_table.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    def _ensure_writable(self, st: _Slot, slot: int, idx: int) -> bool:
        """Page ``idx`` of ``slot`` is mapped and privately owned after
        this call: a fresh page for an unmapped entry, or a copy-on-write
        fork of a borrowed one. False when the pool cannot supply a page
        (the caller backpressures; nothing clamps)."""
        page = int(self._table[slot, idx])
        if page == self.cache.num_pages:
            got = self._allocator.alloc(1)
            if got is None:
                return False
            self._map_page(slot, idx, got[0])
            return True
        if idx in st.borrowed:
            got = self._allocator.alloc(1)
            if got is None:
                return False
            # device copy first, then remap: the sharers keep reading
            # the source page, whose bytes are never touched
            self.cache.fork_page(page, got[0])
            self._allocator.decref(page, park=self._page_registered(page))
            st.borrowed.discard(idx)
            self._map_page(slot, idx, got[0])
            self._cow_forks += 1
        return True

    def _secure_prefill_pages(self, st: _Slot, slot: int, n: int) -> int:
        """Make pages writable for prefix positions ``[cursor, cursor +
        n)``; returns how many of the n tokens have one (maybe 0)."""
        ps = self.cache.page_size
        secured_end = st.cursor
        for idx in range(st.cursor // ps, (st.cursor + n - 1) // ps + 1):
            if not self._ensure_writable(st, slot, idx):
                self._page_stalls += 1
                break
            secured_end = min(st.cursor + n, (idx + 1) * ps)
        return secured_end - st.cursor

    def _register_full_pages(self, st: _Slot, slot: int) -> None:
        """Walk the slot's prefix chain over every page now FULL of
        prompt tokens: owned pages register in the store (immutable from
        here on), borrowed ones advance the chain key."""
        ps = self.cache.page_size
        prompt = st.req.prompt
        while ((st.reg_pages + 1) * ps <= st.cursor
               and (st.reg_pages + 1) * ps <= len(prompt)):
            idx = st.reg_pages
            tokens = prompt[idx * ps:(idx + 1) * ps]
            if idx in st.borrowed:
                st.chain_key = self._store.chain_key(st.chain_key, tokens)
            else:
                st.chain_key = self._store.register(
                    st.chain_key, tokens, int(self._table[slot, idx])
                )
            st.reg_pages += 1

    def _release_slot_pages(self, st: _Slot, slot: int) -> None:
        """Drop the slot's page references: store-registered pages park
        (a later request with the same prefix revives them), private
        pages free."""
        sentinel = self.cache.num_pages
        for idx in range(self._table.shape[1]):
            page = int(self._table[slot, idx])
            if page == sentinel:
                continue
            self._allocator.decref(page, park=self._page_registered(page))
            self._table[slot, idx] = sentinel
        self._table_dirty = True
        st.borrowed.clear()

    def _preempt_for_pages(self) -> None:
        """Break a pool deadlock: preempt page-holding slots, youngest
        lease first, until a page is free. A preempted request keeps its
        tokens and rejoins the head of the queue. With one request in
        flight there is nobody to free pages for: that raises."""
        sentinel = self.cache.num_pages
        while self._allocator.available < 1:
            victim, vslot = None, -1
            for slot, st in enumerate(self._slots):
                if st is None or not (self._table[slot] != sentinel).any():
                    continue
                if victim is None or st.leased_at >= victim.leased_at:
                    victim, vslot = st, slot
            if self.num_active <= 1:
                victim = None
            if victim is None:
                raise RuntimeError(
                    "paged KV pool deadlock: every in-flight request is "
                    "stalled waiting for pages, no decode can run to free "
                    "any, and no slot holds reclaimable pages (pages="
                    f"{self.cache.num_pages}, used="
                    f"{self._allocator.pages_used}); size num_pages for "
                    "the expected live tokens, or admit less concurrency"
                )
            self._release_slot_pages(victim, vslot)
            self._slots[vslot] = None
            self._preempted[victim.req.request_id] = (
                list(victim.generated), victim.first_token_at,
                victim.chunks,
            )
            self._queue.appendleft(victim.req)
            self._preemptions += 1

    def _guard_capacity(self, active: np.ndarray) -> None:
        """A live slot about to decode at a position >= capacity is an
        engine fault (it must have been evicted with 'capacity')."""
        for slot, st in enumerate(self._slots):
            if st is not None and active[slot] and st.pos >= self.capacity:
                raise RuntimeError(
                    f"slot {slot} (request {st.req.request_id}) would "
                    f"write cache position {st.pos} >= capacity "
                    f"{self.capacity}"
                )

    def _step_chunked(self) -> List[GenerationResult]:
        finished: List[GenerationResult] = []
        self._admit_free_slots(time.perf_counter())

        budget = self.prefill_token_budget
        S = self.num_slots
        chunk_tokens = np.zeros((budget,), np.int32)
        # slot id == num_slots marks padding: the scatter drops it and
        # the segment mask keeps pads attending only each other
        chunk_slots = np.full((budget,), S, np.int32)
        chunk_pos = np.zeros((budget,), np.int32)
        lengths_before = np.zeros((S,), np.int32)
        lengths_after = np.zeros((S,), np.int32)
        completions = []  # (slot, chunk index of its last prompt token, fed)
        reg_pending = []  # paged slots whose full prompt pages register
        used = 0
        for slot in range(S):
            st = self._slots[slot]
            if st is not None:
                lengths_before[slot] = st.pos
                lengths_after[slot] = st.pos
            if st is None or used >= budget or not st.prefilling:
                continue
            n = min(budget - used, len(st.prefix) - st.cursor)
            if self.prefill_chunk is not None:
                n = min(n, self.prefill_chunk)
            if self.paged:
                # pool backpressure: only tokens whose pages exist (or
                # could be allocated or forked) are scheduled
                n = self._secure_prefill_pages(st, slot, n)
                if n <= 0:
                    continue
            chunk_tokens[used:used + n] = st.prefix[st.cursor:st.cursor + n]
            chunk_slots[used:used + n] = slot
            chunk_pos[used:used + n] = np.arange(st.cursor, st.cursor + n)
            st.cursor += n
            st.pos = st.cursor
            st.chunks += 1
            lengths_after[slot] = st.cursor
            self._prompt_tokens += n
            if self._store is not None:
                reg_pending.append((st, slot))
            if not st.prefilling and not st.resumed:
                # the first sampled token feeds the same tick's decode,
                # unless that decode write has nowhere to land: a prompt
                # that exactly fills capacity (evicted after its first
                # token instead) or a paged slot whose next page the pool
                # cannot supply yet (it decodes on a later tick). A
                # resumed request's tokens exist already: it rejoins the
                # decode grid below.
                fed = st.cursor < self.capacity
                if fed and self.paged:
                    fed = self._ensure_writable(
                        st, slot, st.cursor // self.cache.page_size
                    )
                    if not fed:
                        self._page_stalls += 1
                completions.append((slot, used + n - 1, fed))
            used += n

        active = np.array(
            [s is not None and bool(s.generated) and not s.prefilling
             for s in self._slots],
            dtype=bool,
        )
        self._guard_capacity(active)
        if self.paged:
            for slot, st in enumerate(self._slots):
                if active[slot] and not self._ensure_writable(
                    st, slot, st.pos // self.cache.page_size
                ):
                    # this slot's decode stalls for the tick; it rides
                    # along as a dead row
                    active[slot] = False
                    self._page_stalls += 1
        dec_tokens = np.array(
            [s.generated[-1] if s is not None and s.generated else 0
             for s in self._slots],
            np.int32,
        )
        completion_idx = np.full((S,), -1, np.int32)
        for slot, idx, fed in completions:
            completion_idx[slot] = idx if fed else -1
        if self.paged:
            if used == 0 and not active.any() and not completions \
                    and self.has_work():
                # every in-flight request waits for pages and no decode
                # can run to free any: preempt and requeue
                self._preempt_for_pages()
            self._push_table()

        chunk_out = chunk_bad = dec_out = dec_bad = None
        if used > 0:
            t0 = time.perf_counter()
            chunk_out, dec_out, chunk_bad, dec_bad = self._mixed(
                chunk_tokens, chunk_slots, chunk_pos, lengths_before,
                lengths_after, completion_idx, dec_tokens, active,
            )
            self._prefill_seconds += time.perf_counter() - t0
            self._mixed_steps += 1
            if active.any() or completions:
                self._decode_steps += 1
        elif active.any():
            t0 = time.perf_counter()
            dec_out, dec_bad = self._decode(dec_tokens, active)
            self._decode_seconds += time.perf_counter() - t0
            self._decode_steps += 1
            self._decode_only_steps += 1

        # the step ran: the tick's full prompt pages may register now
        for st, slot in reg_pending:
            self._register_full_pages(st, slot)

        now = time.perf_counter()
        for slot, idx, fed in completions:
            st = self._slots[slot]
            if chunk_bad[idx]:
                finished.append(self._quarantine(slot, st))
                continue
            st.generated.append(int(chunk_out[idx]))
            self._generated_tokens += 1
            st.first_token_at = now
            self._ttfts.append(now - st.req.enqueued_at)
            done = self._finish_reason(st)
            if done is not None:
                finished.append(self._evict(slot, st, done))
                continue
            if not fed:
                continue
            if dec_bad[slot]:
                finished.append(self._quarantine(slot, st))
                continue
            # the second token arrives in the same tick
            st.pos += 1
            st.generated.append(int(dec_out[slot]))
            self._generated_tokens += 1
            done = self._finish_reason(st)
            if done is not None:
                finished.append(self._evict(slot, st, done))
        if dec_out is not None:
            for slot, st in enumerate(self._slots):
                if st is None or not active[slot]:
                    continue
                if dec_bad[slot]:
                    finished.append(self._quarantine(slot, st))
                    continue
                st.pos += 1  # the input token was written this step
                st.generated.append(int(dec_out[slot]))
                self._generated_tokens += 1
                done = self._finish_reason(st)
                if done is not None:
                    finished.append(self._evict(slot, st, done))
        return finished

    # ------------------------------------------------------------------
    # the whole-prompt path
    # ------------------------------------------------------------------

    def _step_whole(self) -> List[GenerationResult]:
        """The legacy whole-prompt tick (JAX engine.py:3717): a padded
        prefill per admitted request, ONE host fetch of every admit's
        first token, then one decode step for the grid."""
        finished: List[GenerationResult] = []
        t_admit = time.perf_counter()
        pending = []  # (slot, the first token on the device)
        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._queue_waits.append(t_admit - req.enqueued_at)
            toks = np.zeros((1, self.max_prompt_len), np.int64)
            toks[0, :len(req.prompt)] = req.prompt
            tok = self._prefill(toks, slot, len(req.prompt))
            self._admitted += 1
            self._prompt_tokens += len(req.prompt)
            self._slots[slot] = _Slot(
                req=req, generated=[], pos=len(req.prompt),
                cursor=len(req.prompt), prefix=list(req.prompt),
                leased_at=t_admit, chunks=1,
            )
            pending.append((slot, tok))
        if pending:
            first = torch.cat([t for _, t in pending]).cpu().numpy()
            now = time.perf_counter()
            self._prefill_seconds += now - t_admit
            for (slot, _), tok in zip(pending, first):
                st = self._slots[slot]
                st.generated.append(int(tok))
                self._generated_tokens += 1
                st.first_token_at = now
                self._ttfts.append(now - st.req.enqueued_at)
                done = self._finish_reason(st)
                if done is not None:
                    finished.append(self._evict(slot, st, done))

        active = np.array([s is not None for s in self._slots], dtype=bool)
        self._guard_capacity(active)
        if active.any():
            tokens = np.array(
                [s.generated[-1] if s is not None else 0
                 for s in self._slots],
                np.int32,
            )
            t0 = time.perf_counter()
            dec_out, dec_bad = self._decode(tokens, active)
            self._decode_seconds += time.perf_counter() - t0
            self._decode_steps += 1
            self._decode_only_steps += 1
            for slot, st in enumerate(self._slots):
                if st is None:
                    continue
                if dec_bad[slot]:
                    finished.append(self._quarantine(slot, st))
                    continue
                st.pos += 1  # the input token was written this step
                st.generated.append(int(dec_out[slot]))
                self._generated_tokens += 1
                done = self._finish_reason(st)
                if done is not None:
                    finished.append(self._evict(slot, st, done))
        return finished

    def _finish_reason(self, st: _Slot) -> Optional[str]:
        if self.eos_id is not None and st.generated[-1] == self.eos_id:
            return "eos"
        if len(st.generated) >= st.req.max_new_tokens:
            return "length"
        if st.pos >= self.capacity:
            # the next decode would need cache row `pos`: evict, never
            # clamp a live write
            return "capacity"
        return None

    def _quarantine(self, slot: int, st: _Slot) -> GenerationResult:
        self._quarantined += 1
        return self._evict(slot, st, "error")

    def _evict(self, slot: int, st: _Slot, reason: str) -> GenerationResult:
        self._slots[slot] = None
        self._evicted += 1
        if self.paged:
            self._release_slot_pages(st, slot)
        finished_at = time.perf_counter()
        req = st.req
        n_new = len(st.generated)
        first_at = st.first_token_at or finished_at
        self._completions.append({
            "request_id": req.request_id,
            "finish_reason": reason,
            "prompt_tokens": len(req.prompt),
            "new_tokens": n_new,
            "chunks": st.chunks,
            "queue_wait_ms": 1e3 * (st.leased_at - req.enqueued_at),
            "ttft_ms": 1e3 * (first_at - req.enqueued_at),
            "tpot_ms": 1e3 * (finished_at - first_at) / max(n_new - 1, 1),
            "e2e_ms": 1e3 * (finished_at - req.enqueued_at),
        })
        return GenerationResult(
            request_id=req.request_id,
            prompt=list(req.prompt),
            tokens=list(st.generated),
            finish_reason=reason,
        )
