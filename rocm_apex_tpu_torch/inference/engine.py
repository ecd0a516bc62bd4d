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
discarded, their cache writes land in rows no live request reads, and
their lengths are pinned. The host's cursors are the truth for the
lengths a mixed step starts from.

Not ported yet, and refused at construction: the paged cache
(``paged``, ``kv_dtype``, ``prefix_sharing``), speculative decoding
(``spec_k``), the fault harness (``faults``), multi-LoRA
(``adapter_pool``), tracing and the metric registry (``tracer``,
``registry``), tensor parallelism, and the legacy whole-prompt path
(``prefill_token_budget=None``). A row whose logits are not finite is
quarantined (finish reason ``error``), as the JAX engine does.

Sampling draws from an engine-owned `torch.Generator` seeded with
``seed``: a fixed seed replays the same stream on one device, but not
the JAX engine's stream. Greedy decoding draws nothing.
"""

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from rocm_apex_tpu_torch.inference.kv_cache import KVCache
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
    "serves the contiguous cache with the chunked scheduler"
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
    cursor: int = 0  # prompt tokens committed to the cache so far
    leased_at: float = 0.0
    first_token_at: float = 0.0
    chunks: int = 0  # mixed ticks that carried this prompt

    @property
    def prefilling(self) -> bool:
        return self.cursor < len(self.req.prompt)


class InferenceEngine:
    """Continuous-batching serving loop for a `GPTModel`.

    ``model`` is the port's `GPTModel` with its weights loaded (see
    `rocm_apex_tpu_torch.convert`); the engine runs on the model's
    device; the cache is in the model's compute dtype.
    ``prefill_token_budget`` is the prompt tokens absorbed per tick
    across requests; ``prefill_chunk`` optionally caps one request's
    share of it.
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
        capacity: Optional[int] = None,
        eos_id: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        prefill_token_budget: Optional[int] = 64,
        prefill_chunk: Optional[int] = None,
        paged: bool = False,
        kv_dtype: Any = None,
        prefix_sharing: bool = False,
        spec_k: int = 0,
        faults=None,
        adapter_pool=None,
        tracer=None,
        registry=None,
    ):
        refused = [
            (paged or kv_dtype is not None or prefix_sharing,
             "the paged KV cache (paged/kv_dtype/prefix_sharing)",
             "item 2, paged serving"),
            (spec_k, "speculative decoding (spec_k)", "item 6"),
            (faults is not None, "the fault harness (faults)", "item 6"),
            (adapter_pool is not None, "multi-LoRA serving (adapter_pool)",
             "item 6"),
            (tracer is not None or registry is not None,
             "request tracing and the metric registry", "item 7"),
            (prefill_token_budget is None,
             "the whole-prompt path (prefill_token_budget=None)",
             "item 1"),
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
        if prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget must be >= 1, got "
                f"{prefill_token_budget}"
            )
        self.prefill_token_budget = int(prefill_token_budget)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.eos_id = eos_id
        self.sampling = sampling or SamplingParams()
        self.cache = KVCache.for_model(
            cfg, num_slots, self.capacity, device=self.device
        )
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
        decode grid, mixed ones included), ``decode_only_steps``; the mean host time of a mixed tick
        (``prefill_ms_avg``) and of a decode-only tick
        (``decode_ms_avg``), tokens/s over each phase's time; and the
        exact percentiles ``queue_wait_ms_p50/95`` (enqueue -> slot
        lease) and ``ttft_ms_p50/95`` (enqueue -> first token) over the
        newest ``_STATS_RETENTION`` requests."""

        def pct_ms(samples, q):
            if not samples:
                return 0.0
            return 1e3 * float(np.percentile(np.asarray(samples), q))

        decode_generated = self._generated_tokens - self._admitted
        return {
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
                1e3 * self._prefill_seconds / self._mixed_steps
                if self._mixed_steps else 0.0
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
        """One engine tick: admit queued requests into free slots, pack
        up to the token budget of pending prompt tokens, run the mixed
        chunk+decode step (or the decode-only step when nothing is
        prefilling). Returns the requests that finished this tick; their
        slots are already free for the next."""
        return self._step_chunked()

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
        and reads its prefix; inactive slots' lengths are pinned."""
        lengths0 = self.cache.lengths
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
        for slot in range(self.num_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            self._admitted += 1
            self._queue_waits.append(now - req.enqueued_at)
            self._slots[slot] = _Slot(req=req, generated=[], leased_at=now)

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
        used = 0
        for slot in range(S):
            st = self._slots[slot]
            if st is not None:
                lengths_before[slot] = st.pos
                lengths_after[slot] = st.pos
            if st is None or used >= budget or not st.prefilling:
                continue
            n = min(budget - used, len(st.req.prompt) - st.cursor)
            if self.prefill_chunk is not None:
                n = min(n, self.prefill_chunk)
            chunk_tokens[used:used + n] = st.req.prompt[
                st.cursor:st.cursor + n
            ]
            chunk_slots[used:used + n] = slot
            chunk_pos[used:used + n] = np.arange(st.cursor, st.cursor + n)
            st.cursor += n
            st.pos = st.cursor
            st.chunks += 1
            lengths_after[slot] = st.cursor
            self._prompt_tokens += n
            if not st.prefilling:
                # the first sampled token feeds the same tick's decode,
                # unless that decode write has nowhere to land (a prompt
                # that exactly fills capacity is evicted after its first
                # token instead)
                completions.append(
                    (slot, used + n - 1, st.cursor < self.capacity)
                )
            used += n

        active = np.array(
            [s is not None and bool(s.generated) and not s.prefilling
             for s in self._slots],
            dtype=bool,
        )
        self._guard_capacity(active)
        dec_tokens = np.array(
            [s.generated[-1] if s is not None and s.generated else 0
             for s in self._slots],
            np.int32,
        )
        completion_idx = np.full((S,), -1, np.int32)
        for slot, idx, fed in completions:
            completion_idx[slot] = idx if fed else -1

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
