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
pinned. The host's cursors are the truth for the lengths every device
step starts from, and the host resolves every cache write's destination
(`KVCache.host_rows`, `PagedKVCache.host_rows`): a tick sends its inputs
in one copy, reads no device value but its one fetch of the sampled
tokens, and, with speculation, adds one commit call that reads none.

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

Speculative decoding (``spec_k``, JAX engine.py:954-1001, 3136-3420,
3621-3716): each decoding slot's span — its last generated token plus up
to k tokens a drafter proposes (`NGramDrafter` on the slot's history,
host numpy) — rides the tick's chunk. Attention follows the span's slot;
its K/V writes do not happen in the forward (the row carries the pad id
in ``commit_slots``), and the model hands back each layer's packed chunk
K/V. The accept walk keeps the longest prefix of drafts the model's own
samples agree with, plus the model's next token, and ONE commit call
(`write_at`) writes the accepted rows after the decode grid: a rejected
draft is never written, so it cannot touch a shared prefix page or raise
an int8 page's scale, and the contiguous grid's dead-row write at the
span's first position cannot clobber a committed row. Speculative
engines run the mixed step every tick, with the host cursors as lengths.

The robustness layer (JAX engine.py:1723-2043, 2887-3124): per-request
deadlines and queue TTLs (``add_request(timeout=, queue_ttl=)``,
checked at tick boundaries), `cancel`, `drain`/`reopen`, a bounded queue
(``max_queue``: an arrival at a full queue is shed with a ``queue_full``
result the next `step` delivers), a stall watchdog (``watchdog_timeout``
seconds without token progress raises with the stuck slots named, after
writing a JSON dump to ``watchdog_dump_path``), device-step retry with a
capped exponential backoff (``max_step_retries``,
``step_retry_backoff``; exhaustion requeues the in-flight requests, then
raises), and quarantine of a slot whose logits are not finite (finish
reason ``error``). ``faults`` takes a seeded `FaultPlan` that injects
failures at the ``page_alloc``, ``device_step``, ``logits`` and
``host_fetch`` sites.

The port's cache is written IN PLACE inside the forward, where the JAX
engine's functional cache "only moves forward on success". A retry
therefore re-runs the tick from the host cursors over the rows the
failed attempt may have written: the writes are the same values at the
same rows, the sampling generator's state is restored, and the one
int8 page a tick writes twice (a prompt's last chunk rows and its first
decode row) is restored from a copy taken before the call, so a retry
gives the fault-free run's tokens, pools and scales bit for bit.
Prefix-store registration and page-table changes stay after the device
call succeeds.

Not ported yet, and refused at construction: multi-LoRA
(``adapter_pool``; with it tier preemption), request tracing, the
metric registry, the flight recorder and the time series (``tracer``,
``registry``, ``flight_recorder``, ``timeseries``), tensor parallelism
(tp>1 head-sharded pools) and page shipping between engines.

Sampling draws from an engine-owned `torch.Generator` seeded with
``seed``: a fixed seed replays the same stream on one device, but not
the JAX engine's stream. Greedy decoding draws nothing.
"""

import collections
import dataclasses
import json
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from rocm_apex_tpu_torch.inference.drafting import NGramDrafter
from rocm_apex_tpu_torch.inference.faults import NO_FAULTS, FaultInjected
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

#: every finish_reason a `GenerationResult` can carry
FINISH_REASONS = (
    "eos", "length", "capacity",  # normal completion paths
    "deadline", "cancelled", "error", "queue_full",  # robustness paths
)

_NOT_PORTED = (
    "{what} is not ported yet (ROADMAP Queue 1, {item}); the engine "
    "serves the contiguous or the paged cache with the chunked scheduler "
    "(speculative decoding and the fault harness included), and the "
    "contiguous one on the whole-prompt path"
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
    # absolute perf_counter bounds (None: unbounded): ``deadline`` is
    # end to end, ``queue_deadline`` the admission TTL
    deadline: Optional[float] = None
    queue_deadline: Optional[float] = None


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
    optionally caps one request's share of it. ``spec_k`` > 0 turns on
    speculative decoding with ``drafter`` (default an `NGramDrafter`
    over the last ``spec_window`` tokens). ``faults``, ``max_queue``,
    ``max_step_retries``, ``step_retry_backoff``, ``watchdog_timeout``
    and ``watchdog_dump_path`` are the robustness layer's knobs (see the
    module docstring).
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
        drafter=None,
        spec_window: int = 64,
        faults=None,
        max_queue: Optional[int] = None,
        max_step_retries: int = 2,
        step_retry_backoff: float = 0.0,
        watchdog_timeout: Optional[float] = None,
        watchdog_dump_path: Optional[str] = None,
        adapter_pool=None,
        tracer=None,
        registry=None,
        flight_recorder=None,
        timeseries=None,
    ):
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
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k > 0:
            if self.prefill_token_budget is None:
                raise ValueError(
                    "speculative decoding rides the chunked mixed step; "
                    "set prefill_token_budget (chunked mode) to use "
                    "spec_k"
                )
            if self.spec_k + 1 > self.prefill_token_budget:
                raise ValueError(
                    f"spec_k={self.spec_k} needs spec_k + 1 <= "
                    f"prefill_token_budget="
                    f"{self.prefill_token_budget} chunk rows (the "
                    f"verified span is the last token plus k drafts)"
                )
            if drafter is None:
                drafter = NGramDrafter(self.spec_k, window=spec_window)
        self._drafter = drafter if self.spec_k > 0 else None
        self._spec_window = int(
            getattr(self._drafter, "window", spec_window)
        )
        if adapter_pool is not None and self.spec_k > 0:
            raise ValueError(
                "adapter_pool does not compose with speculative "
                "decoding yet (the drafter is base-model-only; a "
                "per-adapter draft would be wrong for every "
                "non-base slot)"
            )
        refused = [
            (adapter_pool is not None, "multi-LoRA serving (adapter_pool)"
             ", and with it tier preemption", "item 8"),
            (any(x is not None for x in
                 (tracer, registry, flight_recorder, timeseries)),
             "the monitor layer (tracer, registry, flight_recorder, "
             "timeseries)", "item 9"),
        ]
        for asked, what, item in refused:
            if asked:
                raise NotImplementedError(
                    _NOT_PORTED.format(what=what, item=item)
                )
        self.faults = faults if faults is not None else NO_FAULTS
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        if max_step_retries < 0:
            raise ValueError(
                f"max_step_retries must be >= 0, got {max_step_retries}"
            )
        self.max_step_retries = int(max_step_retries)
        self.step_retry_backoff = float(step_retry_backoff)
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError(
                f"watchdog_timeout must be > 0 seconds, got "
                f"{watchdog_timeout}"
            )
        self.watchdog_timeout = watchdog_timeout
        self.watchdog_dump_path = watchdog_dump_path
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
        # set by the first request with a deadline or a TTL: until then
        # the tick-boundary sweep has nothing to look for
        self._any_deadline = False
        self._slots: List[Optional[_Slot]] = [None] * num_slots
        self._next_id = 0
        self._draining = False
        self._tick = 0  # step() count, the fault plans' tick domain
        # queue_full results awaiting delivery through the next step()
        self._shed_results: List[GenerationResult] = []
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
        return (bool(self._queue) or self.num_active > 0
                or bool(self._shed_results))

    @property
    def draining(self) -> bool:
        """True once `drain()` was called: admission is closed."""
        return self._draining

    @property
    def tick_count(self) -> int:
        """Engine ticks so far, the `FaultPlan` tick domain."""
        return self._tick

    @property
    def completions(self) -> List[Dict[str, float]]:
        """Per-request completion records in finish order:
        ``request_id``, ``finish_reason``, ``prompt_tokens``,
        ``new_tokens``, ``chunks``, ``queue_wait_ms``, ``ttft_ms``,
        ``tpot_ms`` (mean inter-token time after the first), ``e2e_ms``.
        Shed, expired and cancelled requests have one too."""
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
        # speculative decoding: every drafted token ends up accepted or
        # rolled back
        self._tokens_drafted = 0
        self._tokens_accepted = 0
        self._rollbacks = 0
        self._cancelled = 0
        self._deadline_exceeded = 0
        self._step_retries = 0
        self._shed = 0
        self._watchdog_fires = 0
        self._host_fetches = 0
        self._queue_waits: Deque[float] = collections.deque(
            maxlen=self._STATS_RETENTION
        )
        self._ttfts: Deque[float] = collections.deque(
            maxlen=self._STATS_RETENTION
        )
        self._completions: Deque[Dict[str, float]] = collections.deque(
            maxlen=self._STATS_RETENTION
        )
        # the watchdog's progress snapshot tracks the counters zeroed
        self._progress_mark = (0, 0, 0)
        self._last_progress = time.perf_counter()

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
        on the contiguous cache. The robustness counters ``cancelled``,
        ``deadline_exceeded``, ``step_retries``, ``shed``,
        ``watchdog_fires``: completed + shed + quarantined + cancelled +
        expired equals submitted. Speculative decoding (zeros at
        ``spec_k == 0``): ``tokens_drafted``, ``tokens_accepted``,
        ``acceptance_rate`` (their ratio), ``rollbacks`` (spans with at
        least one rejected draft). ``host_fetches``: the engine's reads
        of device values (one a device step)."""

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
            "cancelled": float(self._cancelled),
            "deadline_exceeded": float(self._deadline_exceeded),
            "quarantined": float(self._quarantined),
            "step_retries": float(self._step_retries),
            "shed": float(self._shed),
            "watchdog_fires": float(self._watchdog_fires),
            "tokens_drafted": float(self._tokens_drafted),
            "tokens_accepted": float(self._tokens_accepted),
            "acceptance_rate": (
                self._tokens_accepted / self._tokens_drafted
                if self._tokens_drafted else 0.0
            ),
            "rollbacks": float(self._rollbacks),
            "host_fetches": float(self._host_fetches),
            "queue_depth": float(self.num_queued),
            "slots_active": float(self.num_active),
            "slot_occupancy": self.num_active / self.num_slots,
            "admitted": float(self._admitted),
            "evicted": float(self._evicted),
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
        *,
        timeout: Optional[float] = None,
        queue_ttl: Optional[float] = None,
    ) -> int:
        """Queue a prompt; returns the request id. A later `step`
        leases it a free slot and streams its prompt through the
        prefill budget. A prompt must fit in ``capacity`` cache rows.

        ``timeout`` (seconds) is the request's end-to-end deadline, queue
        wait included; ``queue_ttl`` bounds the queue wait alone. Both
        are checked at tick boundaries and finish the request with
        ``deadline``. With ``max_queue`` set, an arrival at a full queue
        is shed, never dropped silently: it gets its id and the next
        `step` delivers its ``queue_full`` result. After `drain`
        admission is closed and this raises."""
        if self._draining:
            raise RuntimeError(
                "engine is draining: admission is closed "
                "(drain() was called)"
            )
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
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be > 0 s, got {timeout}")
        if queue_ttl is not None and queue_ttl <= 0:
            raise ValueError(f"queue_ttl must be > 0 s, got {queue_ttl}")
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        now = time.perf_counter()
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            # shed the newest: the queued requests keep their places
            self._shed += 1
            self._completions.append({
                "request_id": request_id,
                "finish_reason": "queue_full",
                "prompt_tokens": len(prompt),
                "new_tokens": 0,
                "chunks": 0,
                "queue_wait_ms": 0.0,
                "ttft_ms": 0.0,
                "tpot_ms": 0.0,
                "e2e_ms": 0.0,
            })
            self._shed_results.append(GenerationResult(
                request_id=request_id, prompt=prompt, tokens=[],
                finish_reason="queue_full",
            ))
            return request_id
        if timeout is not None or queue_ttl is not None:
            self._any_deadline = True
        self._queue.append(Request(
            request_id, prompt, int(max_new_tokens), enqueued_at=now,
            deadline=(now + timeout) if timeout is not None else None,
            queue_deadline=(now + queue_ttl) if queue_ttl is not None
            else None,
        ))
        return request_id

    def step(self) -> List[GenerationResult]:
        """One engine tick. Chunked: admit queued requests into free
        slots, pack up to the token budget of pending prompt tokens (and,
        with ``spec_k``, the speculative spans), run the mixed
        chunk+decode step (or the decode-only step when nothing is
        prefilling). Whole-prompt: one padded prefill per admit, then
        the decode step. Returns the requests that finished this tick,
        the shed and expired ones included, so every submitted request
        yields exactly one result; their slots are already free."""
        now = time.perf_counter()
        self._check_watchdog(now)
        out: List[GenerationResult] = []
        if self._shed_results:
            out.extend(self._shed_results)
            self._shed_results = []
        out.extend(self._expire_deadlines(now))
        if self.chunked:
            out.extend(self._step_chunked())
        else:
            out.extend(self._step_whole())
        self._tick += 1
        self._note_progress()
        return out

    def cancel(self, request_id: int) -> Optional[GenerationResult]:
        """Cancel one request wherever it is (queued, prefilling,
        decoding) and return its partial result (``cancelled``, the
        tokens generated so far), or None for an unknown or finished id.
        In-flight work tears down through the ordinary eviction, so the
        slot frees and its pages release."""
        now = time.perf_counter()
        for req in self._queue:
            if req.request_id == request_id:
                self._queue.remove(req)
                self._cancelled += 1
                return self._finalize_queued(req, "cancelled", now)
        for slot, st in enumerate(self._slots):
            if st is not None and st.req.request_id == request_id:
                self._cancelled += 1
                return self._evict(slot, st, "cancelled")
        return None

    def drain(self, shed_queue: bool = False) -> List[GenerationResult]:
        """Close admission (`add_request` raises from here on), run the
        engine until all accepted work finishes, and return those
        results. ``shed_queue=True`` cancels the still-queued requests
        up front, so only the in-flight slots run to completion.
        Idempotent; `reopen` is the way back."""
        self._draining = True
        now = time.perf_counter()
        out: List[GenerationResult] = []
        if shed_queue:
            while self._queue:
                req = self._queue.popleft()
                self._cancelled += 1
                out.append(self._finalize_queued(req, "cancelled", now))
        while self.has_work():
            out.extend(self.step())
        return out

    def reopen(self) -> None:
        """Reopen admission after `drain`: the drain flag, the watchdog
        count and the progress anchors reset on the same engine (cache
        and prefix store survive). Raises unless the engine is clean: no
        leased slot, empty queue, no preempted carryover, no undelivered
        shed result, and (paged) an all-sentinel table with the
        allocator's invariants intact."""
        dirty = []
        if any(st is not None for st in self._slots):
            dirty.append(f"{self.num_active} leased slot(s)")
        if self._queue:
            dirty.append(f"{len(self._queue)} queued request(s)")
        if self._preempted:
            dirty.append(f"{len(self._preempted)} preempted carryover(s)")
        if self._shed_results:
            dirty.append(
                f"{len(self._shed_results)} undelivered shed result(s)"
            )
        if self.paged:
            mapped = int((self._table != self.cache.num_pages).sum())
            if mapped:
                dirty.append(f"{mapped} mapped page-table entries")
        if dirty:
            raise RuntimeError(
                "reopen() on a dirty engine: " + ", ".join(dirty)
                + " — drain() first"
            )
        if self.paged:
            self._allocator.assert_consistent()
        self._draining = False
        self._watchdog_fires = 0
        self._progress_mark = (
            self._prompt_tokens, self._generated_tokens, self._evicted,
        )
        self._last_progress = time.perf_counter()

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int
    ) -> List[GenerationResult]:
        """Queue every prompt, run the loop dry, and return the results
        in prompt order. Raises after ``_GENERATE_STALL_TICKS`` ticks in
        a row without token progress, naming the stuck slots."""
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
                    f"without token progress; {self._stall_diagnosis()}"
                    f" (set watchdog_timeout for a wall-clock bound)"
                )
        return [done[i] for i in ids]

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _upload(self, *arrays) -> List[torch.Tensor]:
        """Host int arrays to the device in ONE copy (a blocking copy
        syncs the stream, so a tick makes it before its first launch);
        returns contiguous int32 device views, one per array, each
        starting 256 bytes into the buffer past the previous one, as a
        fresh allocation would (the kernels take int32 ids and lengths)."""
        sizes = [np.size(a) for a in arrays]
        starts, end = [], 0
        for n in sizes:
            starts.append(end)
            end += -(-n // 64) * 64
        host = np.zeros((end,), np.int32)
        for a, at, n in zip(arrays, starts, sizes):
            host[at:at + n] = np.ravel(a)  # the cast to int32 on assignment
        buf = torch.from_numpy(host).to(self.device)
        return [buf[at:at + n] for at, n in zip(starts, sizes)]

    def _fetch(self, *tensors) -> np.ndarray:
        """THE host fetch of a device step (its one device sync): the
        stacked int32 values (tokens, nonfinite flags) in one copy."""
        self._host_fetches += 1
        return torch.stack([t.to(torch.int32) for t in tensors]
                           ).cpu().numpy()

    def _sample(self, logits: torch.Tensor, poison=None):
        """Tokens and per-row nonfinite flags for ``(rows, vocab)``.
        ``poison``: the ``logits`` fault's per-row addend (NaN/Inf on the
        faulted slot's rows, +0.0 elsewhere), None when nothing fires."""
        if poison is not None:
            logits = logits.float() + poison[:, None]
        sp = self.sampling
        bad = ~torch.isfinite(logits).all(dim=-1)
        tok = sample(logits, sp.temperature, sp.top_k, sp.top_p,
                     generator=self._gen)
        return tok, bad

    def _grid_rows(self, active: np.ndarray, lengths: np.ndarray):
        """A paged decode grid's write destinations, resolved on the
        host: each live slot's row at its length; a dead row at the
        device capacity, which drops. None on the contiguous cache."""
        if not self.paged:
            return None
        S = self.num_slots
        pos = np.where(active, lengths, self.cache.capacity)
        return (np.arange(S), pos,
                *self.cache.host_rows(np.arange(S), pos, self._table))

    def _decode_body(self, tokens, active, lengths, rows=None,
                     poison=None):
        """The decode grid from the host ``lengths``: every slot writes
        its token at its length and reads its prefix; inactive slots'
        lengths are pinned. On a paged cache a dead row runs at the
        device capacity, so its write drops (``rows``: the grid's
        resolved destinations): at its own length it could land in a
        live page, maybe a shared one, and raise an int8 page's scale.
        ``lengths`` is int32, as `_upload` gives it (the kernels' type)."""
        if self.paged:
            self.cache.lengths = torch.where(
                active, lengths, self.cache.capacity
            )
        else:
            self.cache.lengths = lengths
        logits, _ = self.model(tokens[:, None], cache=self.cache, rows=rows)
        self.cache.lengths = torch.where(active, self.cache.lengths, lengths)
        tok, bad = self._sample(logits[:, -1, :], poison)
        return torch.where(active, tok, 0), bad

    @torch.no_grad()
    def _mixed(self, chunk_tokens, chunk_slots, chunk_pos, commit_slots,
               lengths_before, lengths_after, completion_idx, dec_tokens,
               dec_active, chunk_poison=None, dec_poison=None):
        """The packed prompt chunk, then the whole decode grid, with the
        first token of every prompt that completed fed straight in.
        ``commit_slots`` (speculative engines): who writes K/V in the
        forward; a speculative row carries the pad id, and the forward
        returns the chunk's per-layer K/V for the later commit. Returns
        the chunk's and the grid's tokens and nonfinite flags (host
        numpy, one fetch) and the chunk K/V (None without
        speculation)."""
        B, S = chunk_tokens.shape[0], self.num_slots
        spec = commit_slots is not None
        write = commit_slots if spec else chunk_slots
        if self.paged:
            chunk_dst = self.cache.host_rows(write, chunk_pos, self._table)
        else:
            chunk_dst = self.cache.host_rows(write, chunk_pos)
        grid_active = dec_active | (completion_idx >= 0)
        grid = self._grid_rows(grid_active, lengths_after)
        dev = self._upload(
            chunk_tokens, chunk_slots, chunk_pos, write, lengths_before,
            lengths_after, completion_idx, dec_tokens, dec_active,
            *chunk_dst, *(grid or ()),
        )
        (tok_c, slots_c, pos_c, write_c, len_b, len_a, comp, dec_tok_in,
         dec_act) = dev[:9]
        rows = self.cache.rows_from(slots_c, pos_c, *dev[9:12])
        grid_rows = self.cache.rows_from(*dev[12:17]) if grid else None
        poisons = self._poisons(chunk_poison, dec_poison)
        self.cache.lengths = len_b
        chunk = (slots_c, pos_c, write_c) if spec else (slots_c, pos_c)
        out = self.model(tok_c[None, :], cache=self.cache, chunk=chunk,
                         rows=rows)
        chunk_kv = out[2] if spec else None
        chunk_tok, chunk_bad = self._sample(out[0][0], poisons[0])
        has_comp = comp >= 0
        first_tok = chunk_tok[comp.clamp(0, B - 1)]
        dec = torch.where(has_comp, first_tok, dec_tok_in)
        # the chunk's cursors: every slot's length after its rows
        dec_tok, dec_bad = self._decode_body(
            dec, dec_act.bool() | has_comp, len_a, grid_rows, poisons[1],
        )
        self._maybe_fail_fetch()
        out = self._fetch(torch.cat([chunk_tok, dec_tok]),
                          torch.cat([chunk_bad, dec_bad]))
        return (out[0, :B].astype(np.int64), out[0, B:].astype(np.int64),
                out[1, :B] != 0, out[1, B:] != 0, chunk_kv)

    @torch.no_grad()
    def _decode(self, dec_tokens, dec_active, lengths, dec_poison=None,
                fetch_site=True):
        grid = self._grid_rows(dec_active, lengths)
        dev = self._upload(dec_tokens, dec_active, lengths, *(grid or ()))
        grid_rows = self.cache.rows_from(*dev[3:8]) if grid else None
        poison = self._poisons(None, dec_poison)[1]
        tok, bad = self._decode_body(
            dev[0], dev[1].bool(), dev[2], grid_rows, poison,
        )
        # the chunked scheduler's site; the whole-prompt path has none
        if fetch_site:
            self._maybe_fail_fetch()
        out = self._fetch(tok, bad)
        return out[0].astype(np.int64), out[1] != 0

    def _poisons(self, chunk_poison, dec_poison):
        """The ``logits`` fault's addends on the device, None when it
        does not fire this tick (the fault-free path adds nothing)."""
        if chunk_poison is None and dec_poison is None:
            return None, None
        t = [None if p is None else torch.from_numpy(p).to(self.device)
             for p in (chunk_poison, dec_poison)]
        return t[0], t[1]

    @torch.no_grad()
    def _commit(self, chunk_kv, slots: np.ndarray, positions: np.ndarray):
        """The post-verification commit: the accepted rows' packed chunk
        K/V into the cache at ``(slot, position)``, every layer, through
        `write_at` (int8 pages through `quantized_paged_scatter`); pad
        rows drop. One call a tick, destinations resolved on the host."""
        if self.paged:
            dst = self.cache.host_rows(slots, positions, self._table)
        else:
            dst = self.cache.host_rows(slots, positions)
        dev = self._upload(slots, positions, *dst)
        rows = self.cache.rows_from(*dev)
        ks, vs = chunk_kv
        for layer in range(len(ks)):
            self.cache.write_at(layer, None, None, ks[layer], vs[layer],
                                rows=rows)

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
        logits, sub = self.model(
            torch.from_numpy(tokens).to(self.device), cache=sub
        )
        sub.lengths = torch.full_like(sub.lengths, length)
        self.cache.write_back(slot, sub)
        tok, _ = self._sample(logits[0, length - 1][None, :])
        return tok

    # ------------------------------------------------------------------
    # the robustness layer
    # ------------------------------------------------------------------

    def _maybe_fail_fetch(self) -> None:
        """The ``host_fetch`` site: after the device work, before the
        value fetch. The forward has already written its K/V in place."""
        if self.faults.enabled and self.faults.fire(
            "host_fetch", tick=self._tick,
        ) is not None:
            raise FaultInjected(
                f"injected host_fetch fault (tick {self._tick})"
            )

    def _int8_restore_point(self, wrote_chunk: np.ndarray,
                            grid_writes: np.ndarray,
                            lengths_after: np.ndarray):
        """A retry rewrites the rows the failed attempt wrote, at the
        same values. On an int8 page that is bitwise only if the page was
        written once: a rewrite under the grown scale keeps it (ratio
        exactly 1) and requantizes nothing. The page a tick writes twice
        — a slot's last chunk rows, then its decode-grid row on the same
        page — would requantize the chunk rows a second time, so it is
        copied (pools and scales, every layer) before the call and put
        back before a retry. Returns the restore function, or None."""
        if not (self.paged and self.cache.quantized
                and self.max_step_retries > 0):
            return None
        ps = self.cache.page_size
        pages = sorted({
            int(self._table[s, lengths_after[s] // ps])
            for s in range(self.num_slots)
            if wrote_chunk[s] and grid_writes[s] and lengths_after[s] % ps
        })
        if not pages:
            return None
        idx = self._upload(np.array(pages))[0].long()
        c = self.cache
        saved = [(buf, buf[idx])
                 for buf in (*c.k, *c.v, *c.k_scale, *c.v_scale)]

        def restore():
            for buf, old in saved:
                buf[idx] = old

        return restore

    def _call_device(self, thunk, restore=None):
        """Run one device step (and its fetch) with the ``device_step``
        site and a capped exponential-backoff retry. The cache is written
        in place, so a retry re-runs the tick from where it started: the
        sampling generator's state and the cache's lengths as they were
        before the first attempt, ``restore`` (an int8 page written twice
        in the tick) put back. On exhaustion every in-flight request is
        requeued, then the failure propagates."""
        # only a drawing sampler advances the generator: a greedy tick
        # (or one that cannot retry) saves nothing
        gen_state = (self._gen.get_state()
                     if self.sampling.temperature > 0
                     and self.max_step_retries > 0 else None)
        lengths = self.cache.lengths
        attempt = 0
        while True:
            try:
                if self.faults.enabled and self.faults.fire(
                    "device_step", tick=self._tick,
                ) is not None:
                    raise FaultInjected(
                        f"injected device_step fault (tick {self._tick})"
                    )
                return thunk()
            except Exception:
                if attempt >= self.max_step_retries:
                    self._requeue_in_flight()
                    raise
                attempt += 1
                self._step_retries += 1
                if self.step_retry_backoff > 0:
                    time.sleep(min(
                        self.step_retry_backoff * (2 ** (attempt - 1)), 1.0,
                    ))
                if gen_state is not None:
                    self._gen.set_state(gen_state)
                self.cache.lengths = lengths
                if restore is not None:
                    restore()

    def _requeue_in_flight(self) -> None:
        """Retries exhausted: hand every in-flight request back to the
        queue head (slot order kept), pages released, tokens carried, so
        a caller that catches the failure finds a consistent engine and
        the next successful tick recomputes. The failed tick's pages
        never registered in the prefix store (registration waits for the
        device call)."""
        for slot in range(self.num_slots - 1, -1, -1):
            st = self._slots[slot]
            if st is None:
                continue
            if self.paged:
                self._release_slot_pages(st, slot)
            self._slots[slot] = None
            if st.generated:
                self._preempted[st.req.request_id] = (
                    list(st.generated), st.first_token_at, st.chunks,
                )
            self._queue.appendleft(st.req)
            self._preemptions += 1
        if self.paged:
            self._push_table()

    def _expire_deadlines(self, now: float) -> List[GenerationResult]:
        """Tick-boundary sweep: queued requests past their TTL or
        deadline expire without a slot; in-flight ones past their
        deadline tear down through the ordinary eviction."""
        out: List[GenerationResult] = []
        if not self._any_deadline:
            return out
        if self._queue:
            keep: Deque[Request] = collections.deque()
            for req in self._queue:
                if ((req.queue_deadline is not None
                     and now > req.queue_deadline)
                        or (req.deadline is not None and now > req.deadline)):
                    self._deadline_exceeded += 1
                    out.append(self._finalize_queued(req, "deadline", now))
                else:
                    keep.append(req)
            self._queue = keep
        for slot, st in enumerate(self._slots):
            if (st is not None and st.req.deadline is not None
                    and now > st.req.deadline):
                self._deadline_exceeded += 1
                out.append(self._evict(slot, st, "deadline"))
        return out

    def _finalize_queued(self, req: Request, reason: str, now: float
                         ) -> GenerationResult:
        """Finish a request that holds no slot (expired or cancelled in
        the queue, shed by drain). A preempted one returns the tokens it
        had generated."""
        carried = self._preempted.pop(req.request_id, None)
        tokens = list(carried[0]) if carried is not None else []
        self._completions.append({
            "request_id": req.request_id,
            "finish_reason": reason,
            "prompt_tokens": len(req.prompt),
            "new_tokens": len(tokens),
            "chunks": carried[2] if carried is not None else 0,
            "queue_wait_ms": 1e3 * (now - req.enqueued_at),
            "ttft_ms": 0.0,
            "tpot_ms": 0.0,
            "e2e_ms": 1e3 * (now - req.enqueued_at),
        })
        return GenerationResult(
            request_id=req.request_id, prompt=list(req.prompt),
            tokens=tokens, finish_reason=reason,
        )

    def _note_progress(self) -> None:
        """Token progress: prompt tokens absorbed, tokens generated, or
        slots evicted, the signals the stall watchdog watches."""
        work = (self._prompt_tokens, self._generated_tokens, self._evicted)
        if work != self._progress_mark:
            self._progress_mark = work
            self._last_progress = time.perf_counter()

    def _check_watchdog(self, now: float) -> None:
        if self.watchdog_timeout is None or not self.has_work():
            return
        stalled = now - self._last_progress
        if stalled <= self.watchdog_timeout:
            return
        self._watchdog_fires += 1
        diag = self._stall_diagnosis()
        if self.watchdog_dump_path is not None:
            with open(self.watchdog_dump_path, "w") as f:
                json.dump({
                    "event": "watchdog",
                    "stalled_seconds": stalled,
                    "tick": self._tick,
                    "diagnosis": diag,
                    "stats": self.stats(),
                }, f, indent=2)
        raise RuntimeError(
            f"serving watchdog: no token progress for {stalled:.2f}s "
            f"(watchdog_timeout={self.watchdog_timeout}s); {diag}"
        )

    def _stall_diagnosis(self) -> str:
        """The stuck slots, named: the watchdog's and generate()'s
        diagnostic."""
        parts = []
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            phase = "prefilling" if st.prefilling else "decoding"
            parts.append(
                f"slot {slot}: request {st.req.request_id} {phase} "
                f"pos={st.pos} cursor={st.cursor}/{len(st.prefix)} "
                f"generated={len(st.generated)}"
            )
        if not parts:
            parts.append("no slots leased")
        return (f"queue_depth={self.num_queued}, "
                f"draining={self._draining}; " + "; ".join(parts))

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
        (the caller backpressures; nothing clamps). The ``page_alloc``
        fault site fails it as an exhausted pool would."""
        if self.faults.enabled and self.faults.fire(
            "page_alloc", tick=self._tick, slot=slot, page_idx=idx,
        ) is not None:
            return False
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

    def _draft(self):
        """One drafter call a tick over every decoding slot's history
        (the last ``spec_window`` tokens of prompt + generated, left-
        padded with -1): host numpy in and out. None when no slot
        decodes."""
        S, W = self.num_slots, self._spec_window
        hist = np.full((S, W), -1, np.int32)
        hist_len = np.zeros((S,), np.int32)
        any_decoding = False
        for slot, st in enumerate(self._slots):
            if st is None or not st.generated or st.prefilling:
                continue
            any_decoding = True
            h = (st.req.prompt + st.generated)[-W:]
            hist[slot, W - len(h):] = h
            hist_len[slot] = len(h)
        if not any_decoding:
            return None, None
        return self._drafter(hist, hist_len)

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
        # speculative engines only: who writes K/V in the forward.
        # Prompt rows do; a speculative row keeps the pad id (the host
        # commits its accepted prefix after verification)
        commit_slots = np.full((budget,), S, np.int32)
        lengths_before = np.zeros((S,), np.int32)
        lengths_after = np.zeros((S,), np.int32)
        # the ``logits`` fault poisons ONE slot's rows for the tick
        poison_slot, poison_val = -1, 0.0
        if self.faults.enabled:
            flt = self.faults.fire("logits", tick=self._tick)
            if flt is not None:
                pay = (flt.payload if isinstance(flt.payload, dict)
                       else {"slot": flt.payload})
                s = pay.get("slot")
                poison_slot = int(s) if s is not None else 0
                poison_val = float(pay.get("value", float("nan")))
        completions = []  # (slot, chunk index of its last prompt token, fed)
        reg_pending = []  # paged slots whose full prompt pages register
        # (slot, first chunk row, drafted count, drafts, pre-span position)
        spec_entries = []
        used = 0
        prefill_used = 0
        drafts_np = counts_np = None
        if self.spec_k > 0:
            drafts_np, counts_np = self._draft()
        # slot order keeps the packed segment ids non-decreasing; a slot
        # contributes prompt rows or a speculative span, never both
        for slot in range(S):
            st = self._slots[slot]
            if st is not None:
                lengths_before[slot] = st.pos
                lengths_after[slot] = st.pos
            if st is None or used >= budget:
                continue
            if st.prefilling:
                n = min(budget - used, len(st.prefix) - st.cursor)
                if self.prefill_chunk is not None:
                    n = min(n, self.prefill_chunk)
                if self.paged:
                    # pool backpressure: only tokens whose pages exist (or
                    # could be allocated or forked) are scheduled
                    n = self._secure_prefill_pages(st, slot, n)
                    if n <= 0:
                        continue
                chunk_tokens[used:used + n] = st.prefix[
                    st.cursor:st.cursor + n]
                chunk_slots[used:used + n] = slot
                commit_slots[used:used + n] = slot
                chunk_pos[used:used + n] = np.arange(st.cursor, st.cursor + n)
                st.cursor += n
                st.pos = st.cursor
                st.chunks += 1
                lengths_after[slot] = st.cursor
                self._prompt_tokens += n
                if self._store is not None:
                    reg_pending.append((st, slot))
                if not st.prefilling and not st.resumed:
                    # the first sampled token feeds the same tick's
                    # decode, unless that decode write has nowhere to
                    # land: a prompt that exactly fills capacity (evicted
                    # after its first token instead) or a paged slot
                    # whose next page the pool cannot supply yet (it
                    # decodes on a later tick). A resumed request's
                    # tokens exist already: it rejoins the decode grid
                    # below.
                    fed = st.cursor < self.capacity
                    if fed and self.paged:
                        fed = self._ensure_writable(
                            st, slot, st.cursor // self.cache.page_size
                        )
                        if not fed:
                            self._page_stalls += 1
                    completions.append((slot, used + n - 1, fed))
                used += n
                prefill_used += n
                continue
            # the speculative span: [last generated token, n drafts],
            # clamped by the drafter's count, k, the budget left (one
            # row is the last token), capacity (each accepted token and
            # the bonus need a row) and the request's remaining tokens
            if drafts_np is None or not st.generated:
                continue
            n = min(int(counts_np[slot]), self.spec_k, budget - used - 1,
                    self.capacity - st.pos - 1,
                    st.req.max_new_tokens - len(st.generated) - 1)
            if n < 1:
                continue
            if self.paged and not self._ensure_writable(
                st, slot, st.pos // self.cache.page_size
            ):
                # no page even for the last token's row: the decode grid
                # hits the same wall and stalls the slot for the tick
                continue
            drafts = [int(t) for t in drafts_np[slot, :n]]
            chunk_tokens[used] = st.generated[-1]
            chunk_tokens[used + 1:used + 1 + n] = drafts
            chunk_slots[used:used + n + 1] = slot
            chunk_pos[used:used + n + 1] = np.arange(st.pos, st.pos + n + 1)
            spec_entries.append((slot, used, n, drafts, st.pos))
            self._tokens_drafted += n
            used += n + 1

        active = np.array(
            [s is not None and bool(s.generated) and not s.prefilling
             for s in self._slots],
            dtype=bool,
        )
        # a slot with a span advances through the accept walk, not the
        # grid: it rides the grid as a dead row
        for slot, _, _, _, _ in spec_entries:
            active[slot] = False
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
        chunk_poison = dec_poison = None
        if poison_slot >= 0:
            # the faulted slot's chunk rows too: a prompt completion or a
            # speculative span quarantines as a decode row does
            chunk_poison = np.zeros((budget,), np.float32)
            dec_poison = np.zeros((S,), np.float32)
            chunk_poison[chunk_slots == poison_slot] = poison_val
            if poison_slot < S:
                dec_poison[poison_slot] = poison_val
        if self.paged:
            if used == 0 and not active.any() and not completions \
                    and self.has_work():
                # every in-flight request waits for pages and no decode
                # can run to free any: preempt and requeue
                self._preempt_for_pages()
            self._push_table()

        chunk_out = chunk_bad = dec_out = dec_bad = chunk_kv = None
        spec = self.spec_k > 0
        if used > 0 or (spec and active.any()):
            # speculative engines run the mixed step every tick: the
            # host cursors ride in as lengths, which the accept walk
            # moves past the device's
            wrote_chunk = np.zeros((S,), bool)
            wrote_chunk[commit_slots[commit_slots < S]] = True
            restore = self._int8_restore_point(
                wrote_chunk, active | (completion_idx >= 0), lengths_after,
            )
            t0 = time.perf_counter()
            chunk_out, dec_out, chunk_bad, dec_bad, chunk_kv = (
                self._call_device(lambda: self._mixed(
                    chunk_tokens, chunk_slots, chunk_pos,
                    commit_slots if spec else None, lengths_before,
                    lengths_after, completion_idx, dec_tokens, active,
                    chunk_poison, dec_poison,
                ), restore)
            )
            dt = time.perf_counter() - t0
            if prefill_used > 0:
                self._prefill_seconds += dt
                self._mixed_steps += 1
            else:
                self._decode_seconds += dt
                self._decode_only_steps += 1
            if active.any() or completions or spec_entries:
                self._decode_steps += 1
        elif active.any():
            lengths = np.array([s.pos if s is not None else 0
                                for s in self._slots], np.int32)
            t0 = time.perf_counter()
            dec_out, dec_bad = self._call_device(lambda: self._decode(
                dec_tokens, active, lengths, dec_poison,
            ))
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
        if spec_entries:
            finished.extend(self._accept(spec_entries, chunk_out,
                                         chunk_bad, chunk_kv))
        return finished

    def _accept(self, spec_entries, chunk_out, chunk_bad, chunk_kv
                ) -> List[GenerationResult]:
        """The accept walk. Row j of a span was sampled under the model
        conditioned on the drafts before it, so (for a point-mass
        drafter) draft j is accepted iff the model's own sample at row j
        equals it; the first disagreeing row's sample is the bonus
        token: m accepted drafts emit m + 1 tokens. A span with
        nonfinite logits quarantines its slot, its rows never written.
        Then ONE commit call writes every kept span's last-token row and
        its m accepted rows (the bonus token stays the slot's unwritten
        next input), after the decode grid, whose dead-row write on a
        contiguous cache lands at the span's first position."""
        finished: List[GenerationResult] = []
        budget, S = self.prefill_token_budget, self.num_slots
        commit_np = np.full((budget,), S, np.int32)
        commit_pos_np = np.zeros((budget,), np.int32)
        any_commit = False
        for slot, r0, n, drafts, pos0 in spec_entries:
            st = self._slots[slot]
            if chunk_bad[r0:r0 + n + 1].any():
                finished.append(self._quarantine(slot, st))
                continue
            out = chunk_out[r0:r0 + n + 1]
            m = 0
            while m < n and int(out[m]) == drafts[m]:
                m += 1
            if self.paged and m > 0:
                # accepted tokens become cache writes: clamp the accept
                # length to pages the pool can supply (forking shared
                # ones as usual)
                ps = self.cache.page_size
                for j in range(1, m + 1):
                    if not self._ensure_writable(st, slot, (pos0 + j) // ps):
                        self._page_stalls += 1
                        m = j - 1
                        break
            emit = drafts[:m] + [int(out[m])]
            accepted = 0
            done = None
            for i, tok in enumerate(emit):
                st.pos += 1
                st.generated.append(int(tok))
                self._generated_tokens += 1
                if i < m:
                    accepted += 1
                    self._tokens_accepted += 1
                done = self._finish_reason(st)
                if done is not None:
                    break
            if n - accepted > 0:
                self._rollbacks += 1
            if done is not None:
                # its unwritten rows die with the lease
                finished.append(self._evict(slot, st, done))
                continue
            commit_np[r0:r0 + m + 1] = slot
            commit_pos_np[r0:r0 + m + 1] = np.arange(pos0, pos0 + m + 1)
            any_commit = True
        if any_commit:
            if self.paged:
                self._push_table()  # forks from the clamp above
            self._commit(chunk_kv, commit_np, commit_pos_np)
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
            first = self._fetch(torch.cat([t for _, t in pending]))[0]
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
            lengths = np.array([s.pos if s is not None else 0
                                for s in self._slots], np.int32)
            t0 = time.perf_counter()
            dec_out, dec_bad = self._decode(tokens, active, lengths,
                                            fetch_site=False)
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
        """Nonfinite logits on ONE slot evict that slot only (``error``);
        the tick's other slots took their tokens from the same fetch."""
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
        # a request torn down before its first token (cancel, deadline,
        # quarantine mid-prefill) has no TTFT anchor: the teardown time
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
