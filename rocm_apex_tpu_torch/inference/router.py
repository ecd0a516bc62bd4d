"""Multi-replica serving fabric: the host-level `ReplicaRouter`.

Port of ``rocm_apex_tpu/inference/router.py``: host bookkeeping over the
port's `InferenceEngine` replicas, which on one card share the model's
one set of weights. The JAX router's adoption of replica 0's compiled
step programs has no counterpart (the port compiles nothing). The
monitor layer's host side is wired as in JAX: ``tracer`` records the
router's instants under each request's ``trace_id``, ``timeseries``
ticks once a fleet step, `merged_registry` folds every replica's
registry into the router's and `merged_trace` every tracer into one
body; ``retrace_policy`` and `arm_retrace_sentinel` (the retrace
sentinel) are refused by name, ROADMAP Queue 1 item 9b. Page shipping
between replicas on one card keeps the payload on the device.

One stalled engine must never be a total outage. The router owns N
independent `InferenceEngine` replicas behind the engine's own surface
(`add_request` / `step` / `generate` / `stats` / `drain`) and adds the
fleet behaviours the single engine cannot express:

**Routing & admission.** A bounded global queue feeds per-replica
admission: each router tick dispatches pending requests to in-rotation
replicas, prefix-affinity first — the `PrefixStore` chain hash routes
a prompt to the replica already holding its prefix pages via the
fleet-wide `SharedPrefixRegistry` (each store's register/unregister
hooks publish its chains, so placement is one chain walk instead of N
engine consults), so CoW sharing keeps working across the fleet —
then least-loaded by the replica's live signals (queue depth, slot
occupancy, ``pages_used``). Per-replica backlogs stay shallow
(``replica_queue_depth``) so work left in the GLOBAL queue can still
be placed anywhere when a replica dies.

**Disaggregated prefill/decode (replica classes).** Pass
``replica_classes=["prefill", "decode", ...]`` and placement
specializes: fresh prompts land on prefill-class replicas (chunk-heavy
ticks), and the moment a request's first token is out the prefill
replica evacuates it WITH its KV pages
(`InferenceEngine.evacuate_request(ship_pages=True)`) for a
decode-class replica, which imports the pages directly into its own
pool — no re-prefill — and runs near-pure decode grids at full
occupancy. Per-class TTFT/TPOT land in the labeled
``router_ttft_ms``/``router_tpot_ms`` histogram families. Class
preference never costs availability: with no decode capacity the
request keeps decoding where it is, and a failed page import falls
back to token replay — token-identical either way.

**Failure detection & recovery.** Three detectors run every tick:
consecutive `step()` failures (device faults, watchdog raises),
`engine_health`-style probes (watchdog-fire count), and a
zero-progress probe over `progress_marker` for replicas that have work
but move no tokens. A replica crossing its threshold is QUARANTINED
and every request it held is resubmitted to the rest of the fleet as
prompt + tokens emitted so far — the vLLM recompute transition (arXiv
2309.06180) generalized to replica death. On a paged cache the
quarantine/drain paths additionally SHIP each slot's KV page blocks
with the record (``evacuate(ship_pages=True)``): the destination
imports them straight into its `PageAllocator` and skips the
recompute. Either way continuation is greedy decode through the
destination's chunked prefill (arXiv 2403.02310), so recovered
outputs are token-identical to an undisturbed run and no token is
ever emitted twice: the router delivers each request's result
exactly once (`_deliver` enforces it). For `replica_kill` the engine's
state is presumed LOST — recovery reads the router's own per-request
token mirror (refreshed from `outstanding()` after every successful
replica tick), never the dead engine; the carcass is then evacuated so
its pages and slots provably free. A quarantined replica is re-probed
after ``rejoin_after`` ticks: `InferenceEngine.reopen()` verifies the
clean state and the replica rejoins rotation.

**Rolling drain.** `drain_replica(i)` migrates the replica's queue and
in-flight work to the fleet and takes it out of rotation —
restart-without-downtime; `rejoin_replica(i)` is the return path.
`drain()` drains the whole fleet.

**Fleet chaos & telemetry.** The same seeded `FaultPlan` that drives
engine-level chaos gains replica-scoped sites (``replica_kill`` /
``replica_stall`` / ``replica_slow``, consulted once per router tick;
``fault_log`` records the (site, tick, replica) sequence so `reset()`
replays bit-identically). Router events land in a router-local
`MetricRegistry` (`monitor.telemetry`).

**Tensor-parallel replicas (tp > 1).** Each rank of a tp>1 engine is a
process of its own, so a fleet of tp>1 engines runs SPMD: every rank of
the tensor group builds the same fleet, each replica an engine over the
one group, and makes the same `add_request` / `step` / `cancel` /
`drain_replica` / `rejoin_replica` calls in the same order. Every
placement, kill, quarantine, migration, shed and expiry decision is then
the same on every rank, since each reads only host state the calls
make alike: the replicas' counters, the seeded `FaultPlan` (consulted at
the same site and tick on every rank), and a clock that is tensor rank
0's: on calls and ticks where a time-bounded request is live the router
(and each engine, on its own ticks) takes rank 0's ``perf_counter``
through one exchange, and otherwise exchanges nothing. A migrated
request's payload carries every head, gathered over the group, and each
rank imports its own heads. Trace ids are minted from rank 0's pid and
the router's own sequence, so a request has one id on every rank. A
failure that only one rank sees (a real device fault on one process)
leaves the other rank blocked in its next exchange until the group's
timeout: that is outside what the router recovers from.

Everything here is host bookkeeping: the device steps never see the
router.
"""

import collections
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from rocm_apex_tpu_torch.inference.engine import (
    GenerationResult,
    InferenceEngine,
    group_clock,
)
from rocm_apex_tpu_torch.inference.faults import NO_FAULTS, FaultPlan
from rocm_apex_tpu_torch.monitor.telemetry import MetricRegistry
from rocm_apex_tpu_torch.monitor.trace import (
    NULL_TRACER,
    merge_traces,
    mint_trace_id,
)
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "ReplicaRouter", "SharedPrefixRegistry", "REPLICA_STATES",
    "REPLICA_CLASSES",
]

#: Replica rotation states: ``up`` serves traffic; ``quarantined`` was
#: failed out and awaits a rejoin probe; ``drained`` was rolled out on
#: purpose (`drain_replica`) and waits for `rejoin_replica`.
REPLICA_STATES = ("up", "quarantined", "drained")

#: Replica placement classes: ``mixed`` takes anything (the default —
#: a classic homogeneous fleet); ``prefill`` prefers fresh prompts and
#: hands each request off (with its KV pages) once its first token is
#: out; ``decode`` prefers carried requests — pure decode grids at
#: full occupancy.
REPLICA_CLASSES = ("mixed", "prefill", "decode")

_NOT_PORTED = (
    "ReplicaRouter's {what} is not ported yet (ROADMAP Queue 1, item 9b: "
    "the retrace sentinel of the monitor layer); the router serves, "
    "routes, migrates, recovers and traces without it"
)


class SharedPrefixRegistry:
    """Cross-replica index of materialized prefix chains.

    Each replica's `PrefixStore` keys pages by the pure chain hash
    ``(parent_key, page tokens)`` — a value any party can recompute
    from the tokens alone, no store needed. This registry subscribes to
    every store's register/unregister hooks and maintains
    ``chain key -> {replica indices holding that chain}``, so placement
    answers "who already holds this prompt's prefix pages?" with one
    O(prompt pages) walk instead of consulting N engines per request.
    Host bookkeeping only; the stores remain the page owners — the
    registry never pins a page."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._holders: Dict[Any, set] = {}

    def __len__(self) -> int:
        return len(self._holders)

    def publish(self, replica: int, key) -> None:
        self._holders.setdefault(key, set()).add(replica)

    def unpublish(self, replica: int, key) -> None:
        holders = self._holders.get(key)
        if holders is None:
            return
        holders.discard(replica)
        if not holders:
            del self._holders[key]

    def holders(self, key) -> frozenset:
        return frozenset(self._holders.get(key, ()))

    def best(self, prompt: Sequence[int]) -> Dict[int, int]:
        """``replica index -> matched prefix tokens`` over the full
        pages of ``prompt`` (leaving >= 1 token unmatched, the store's
        own contract). Chain containment makes per-replica matches
        contiguous, so each replica's entry is simply the deepest
        chain it still holds."""
        ps = self.page_size
        limit = len(prompt) - 1
        key = None
        m = 0
        matched: Dict[int, int] = {}
        while m + ps <= limit:
            key = (key, tuple(int(t) for t in prompt[m:m + ps]))
            holders = self._holders.get(key)
            if not holders:
                break
            m += ps
            for idx in holders:
                matched[idx] = m
        return matched


class _Replica:
    """Router-side bookkeeping for one engine."""

    def __init__(
        self, index: int, engine: InferenceEngine,
        replica_class: str = "mixed",
    ):
        self.index = index
        self.engine = engine
        self.replica_class = replica_class
        self.completions_seen = 0
        self.state = "up"
        self.consecutive_failures = 0
        self.no_progress_ticks = 0
        self.progress_mark = engine.progress_marker
        self.quarantined_at = -1
        self.last_error = ""
        # injected-fault latches (replica_stall / replica_slow)
        self.stall_ticks = 0
        self.slow_ticks = 0
        self.slow_seconds = 0.0

    @property
    def in_rotation(self) -> bool:
        return self.state == "up"


class ReplicaRouter:
    """N `InferenceEngine` replicas behind one serving surface.

    Build replicas from a model (the shared fault plan and identical
    ``engine_kwargs``; identical configs keep greedy outputs
    replica-independent, and the replicas share the model's weights)::

        router = ReplicaRouter(model, replicas=2,
                               engine_kwargs=dict(num_slots=2, ...))

    or wrap engines you built yourself (``engines=[...]``; they must
    be chunked — migration recomputes through the prefill budget).

    ``max_queue`` bounds the GLOBAL queue (shed-newest, ``queue_full``
    results delivered through `step()`, exactly like the engine's
    bounded admission). ``failure_threshold`` consecutive step
    failures, any watchdog fire, or ``stall_grace`` zero-progress
    ticks quarantine a replica; after ``rejoin_after`` router ticks a
    quarantine is probed for rejoin (`reopen()` + health). Pass
    ``faults`` to drive fleet chaos (see module docstring).
    ``registry``: the router's `MetricRegistry` (a fresh one by
    default). ``tracer``: a `monitor.Tracer` for the router's instants
    (default the disabled ``NULL_TRACER``); ``timeseries``: a
    `TimeSeriesStore` ticked once a fleet step (over the router's
    registry, or ``router.merged_registry`` for fleet-wide series).
    ``retrace_policy`` is refused (ROADMAP Queue 1 item 9b).
    """

    def __init__(
        self,
        model=None,
        *,
        replicas: int = 2,
        engines: Optional[Sequence[InferenceEngine]] = None,
        engine_kwargs: Optional[Dict[str, Any]] = None,
        replica_classes: Optional[Sequence[str]] = None,
        max_queue: Optional[int] = None,
        replica_queue_depth: int = 2,
        faults: Optional[FaultPlan] = None,
        failure_threshold: int = 2,
        stall_grace: int = 3,
        rejoin_after: int = 8,
        registry=None,
        tracer=None,
        retrace_policy: Optional[str] = None,
        timeseries=None,
    ):
        if retrace_policy is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                what="retrace_policy"))
        self.faults = faults if faults is not None else NO_FAULTS
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if engines is not None:
            engines = list(engines)
        else:
            if model is None:
                raise ValueError(
                    "pass model (the router builds the replicas) or "
                    "engines=[...]"
                )
            kw = dict(engine_kwargs or {})
            if "prefill_token_budget" not in kw:
                raise ValueError(
                    "engine_kwargs must set prefill_token_budget: "
                    "migration recomputes prompt + emitted tokens "
                    "through the chunked prefill"
                )
            kw.pop("registry", None)  # each replica scrapes privately
            kw.setdefault("faults", self.faults)
            # every replica serves the model's one set of weights
            engines = [InferenceEngine(model, **kw)
                       for _ in range(int(replicas))]
        if not engines:
            raise ValueError("need at least one replica")
        self.tp = engines[0].tp
        self._axis = engines[0].model.cfg.tensor_axis
        for i, eng in enumerate(engines):
            if (eng.tp, eng.model.cfg.tensor_axis) != (self.tp, self._axis):
                raise ValueError(
                    f"replica {i} is a tp={eng.tp} engine over axis "
                    f"{eng.model.cfg.tensor_axis!r}, replica 0 a tp="
                    f"{self.tp} engine over {self._axis!r}: a fleet's "
                    f"replicas share one tensor group")
            if not eng.chunked:
                raise ValueError(
                    f"replica {i} is a whole-prompt engine; the "
                    f"router needs chunked engines "
                    f"(prefill_token_budget) so migrated requests can "
                    f"recompute their carried tokens"
                )
        if replica_classes is None:
            replica_classes = ["mixed"] * len(engines)
        replica_classes = [str(c) for c in replica_classes]
        if len(replica_classes) != len(engines):
            raise ValueError(
                f"replica_classes has {len(replica_classes)} entries "
                f"for {len(engines)} replicas"
            )
        for c in replica_classes:
            if c not in REPLICA_CLASSES:
                raise ValueError(
                    f"unknown replica class {c!r}; classes are "
                    f"{REPLICA_CLASSES}"
                )
        if "prefill" in replica_classes and (
            "decode" not in replica_classes
        ):
            raise ValueError(
                "a prefill-class replica needs at least one "
                "decode-class replica to hand finished prompts to"
            )
        self._has_classes = any(
            c != "mixed" for c in replica_classes
        )
        if self._has_classes:
            for i, eng in enumerate(engines):
                if not eng.paged:
                    raise ValueError(
                        f"replica {i}: prefill/decode classes need "
                        f"paged engines — the handoff ships KV pages"
                    )
        self._replicas = [
            _Replica(i, eng, replica_classes[i])
            for i, eng in enumerate(engines)
        ]
        # cross-replica shared prefix registry: subscribe to every
        # compatible PrefixStore's register/unregister hooks so
        # placement sees the whole fleet's materialized chains
        self._prefix_registry: Optional[SharedPrefixRegistry] = None
        stores = [
            (rep.index, rep.engine._store) for rep in self._replicas
            if getattr(rep.engine, "_store", None) is not None
        ]
        if stores:
            page_size = stores[0][1].page_size
            registry_ = SharedPrefixRegistry(page_size)
            for idx, store in stores:
                if store.page_size != page_size:
                    continue  # incompatible chain geometry: skip
                store.on_register = (
                    lambda key, page, i=idx: registry_.publish(i, key)
                )
                store.on_unregister = (
                    lambda key, page, i=idx: registry_.unpublish(i, key)
                )
            self._prefix_registry = registry_
        self.capacity = min(eng.capacity for eng in engines)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        if replica_queue_depth < 0:
            raise ValueError(
                f"replica_queue_depth must be >= 0, got "
                f"{replica_queue_depth}"
            )
        self.replica_queue_depth = int(replica_queue_depth)
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got "
                f"{failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        if stall_grace < 1:
            raise ValueError(
                f"stall_grace must be >= 1, got {stall_grace}"
            )
        self.stall_grace = int(stall_grace)
        if rejoin_after < 1:
            raise ValueError(
                f"rejoin_after must be >= 1, got {rejoin_after}"
            )
        self.rejoin_after = int(rejoin_after)
        # the global queue: migration records (prompt + carried
        # tokens), dispatched to replicas via resume_request — one
        # admission path for fresh AND recovered requests
        self._pending: collections.deque = collections.deque()
        self._assigned: Dict[int, int] = {}  # rid -> replica index
        # the router's OWN copy of every live request's emitted
        # tokens, refreshed after each successful replica tick — the
        # recovery source when an engine dies without warning
        self._mirror: Dict[int, Dict[str, Any]] = {}
        self._shed_results: List[GenerationResult] = []
        self._done: set = set()
        self._next_id = 0
        self._tick = 0
        self._draining = False
        self._submitted = 0
        self._shed = 0
        self._migrations = 0
        self._quarantines = 0
        self._rejoins = 0
        self._affinity_hits = 0
        self._adapter_affinity_hits = 0
        self._kills = 0
        self._handoffs = 0
        self._page_migrations = 0
        self._finished: Dict[str, int] = {}
        #: every replica-scoped fault that fired, as (site, tick,
        #: replica) — the `FaultPlan.reset()` replay witness
        self.fault_log: List[tuple] = []
        if registry is None:
            registry = MetricRegistry()
        self.registry = registry
        self._c_events = registry.counter(
            "router_events_total",
            "Fleet lifecycle events (migration, page_migration, "
            "handoff, quarantine, rejoin, affinity_hit, "
            "adapter_affinity_hit, kill, shed, "
            "drain_replica).",
            labelnames=("event",),
        )
        self._g_healthy = registry.gauge(
            "router_healthy_replicas", "Replicas in rotation."
        )
        self._g_pending = registry.gauge(
            "router_queue_depth", "Requests in the global queue."
        )
        # per-class latency attribution (PR-14 labeled families): a
        # request observes under the class of the replica it FINISHED
        # on — in a disaggregated fleet that is the decode class for
        # every handed-off request, which is exactly the class whose
        # TTFT/TPOT SLO the disaggregation is supposed to protect
        self._h_class_ttft = registry.histogram(
            "router_ttft_ms",
            "Time to first token (enqueue -> first token), ms, by the "
            "finishing replica's class.",
            labelnames=("replica_class",),
        )
        self._h_class_tpot = registry.histogram(
            "router_tpot_ms",
            "Mean inter-token time after the first token, ms, by the "
            "finishing replica's class.",
            labelnames=("replica_class",),
        )
        self._g_healthy.set(len(self._replicas))
        # sensor plane: the ring samples the registry it was built over
        # (the router's own families for TimeSeriesStore(router.registry))
        self.timeseries = timeseries
        # tp > 1: trace ids from rank 0's pid and the router's sequence,
        # the same on every rank (one exchange, here)
        self._trace_base = None
        if self.tp > 1:
            pid = parallel_state.broadcast(
                torch.tensor([os.getpid()], dtype=torch.int64),
                parallel_state.resolve_group(self._axis), 0)
            self._trace_base = f"t{int(pid[0]):x}-r"
            self._trace_seq = itertools.count()

    # ------------------------------------------------------------------
    # public surface (mirrors InferenceEngine)
    # ------------------------------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def tick_count(self) -> int:
        return self._tick

    @property
    def draining(self) -> bool:
        return self._draining

    def replica(self, i: int) -> InferenceEngine:
        return self._replicas[i].engine

    def replica_state(self, i: int) -> str:
        return self._replicas[i].state

    @property
    def healthy_replicas(self) -> int:
        return sum(1 for rep in self._replicas if rep.in_rotation)

    def has_work(self) -> bool:
        return bool(
            self._pending or self._shed_results or self._assigned
            or any(
                rep.engine.has_work() for rep in self._replicas
            )
        )

    def add_request(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        request_id: Optional[int] = None,
        *,
        timeout: Optional[float] = None,
        queue_ttl: Optional[float] = None,
        adapter_id: int = 0,
        tenant: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> int:
        """Queue a prompt with the fleet; same contract as
        `InferenceEngine.add_request` (ids, deadlines, bounded
        admission with shed-newest ``queue_full`` results delivered by
        the next `step()`, raises once draining). Placement happens at
        the next tick's dispatch; non-base ``adapter_id`` requests
        prefer replicas where the adapter is already resident.

        Admission mints the request's fleet-causal ``trace_id`` (one
        per admitted request, NOT per attempt): it rides every
        dispatch, migration, failover, and handoff hop so
        `merged_trace` renders the whole lifeline under one id."""
        if self._draining:
            raise RuntimeError(
                "router is draining: admission is closed "
                "(drain() was called)"
            )
        adapter_id = int(adapter_id)
        if adapter_id != 0:
            pools = [
                rep.engine.adapter_pool for rep in self._replicas
                if rep.engine.adapter_pool is not None
            ]
            if not pools:
                raise ValueError(
                    "adapter_id requires replicas built with an "
                    "AdapterPool"
                )
            if not any(p.known(adapter_id) for p in pools):
                raise KeyError(
                    f"adapter {adapter_id} is not registered with any "
                    f"replica's pool"
                )
            if tenant is None:
                for p in pools:
                    if p.known(adapter_id):
                        tenant = p.tenant_of(adapter_id)
                        break
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) > self.capacity:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the fleet cache "
                f"capacity {self.capacity} (rows per slot)"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be > 0 s, got {timeout}")
        if queue_ttl is not None and queue_ttl <= 0:
            raise ValueError(
                f"queue_ttl must be > 0 s, got {queue_ttl}"
            )
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        if trace_id is None:
            trace_id = (mint_trace_id() if self._trace_base is None else
                        f"{self._trace_base}{next(self._trace_seq):x}")
        # a time-bounded request's deadlines read tensor rank 0's clock
        # at tp > 1, as the fleet's ticks do
        now = (group_clock(self.tp, self._axis)
               if timeout is not None or queue_ttl is not None
               else time.perf_counter())
        self._submitted += 1
        if (
            self.max_queue is not None
            and len(self._pending) >= self.max_queue
        ):
            self._shed += 1
            self._count_event("shed")
            self._shed_results.append(GenerationResult(
                request_id=request_id, prompt=prompt, tokens=[],
                finish_reason="queue_full",
            ))
            if self.tracer.enabled:
                self.tracer.instant(
                    "shed", ts=now, track=f"req{request_id}",
                    queue_depth=len(self._pending),
                    request_id=request_id, trace_id=trace_id,
                )
            return request_id
        self._pending.append({
            "request_id": request_id,
            "prompt": prompt,
            "max_new_tokens": int(max_new_tokens),
            "generated": [],
            "enqueued_at": now,
            "deadline": (now + timeout) if timeout is not None else None,
            "queue_deadline": (
                (now + queue_ttl) if queue_ttl is not None else None
            ),
            "first_token_at": 0.0,
            "chunks": 0,
            "adapter_id": adapter_id,
            "tenant": tenant,
            "trace_id": trace_id,
        })
        if self.tracer.enabled:
            self.tracer.instant(
                "admit", ts=now, track=f"req{request_id}",
                prompt_tokens=len(prompt),
                request_id=request_id, trace_id=trace_id,
            )
        return request_id

    def step(self) -> List[GenerationResult]:
        """One fleet tick: consult the replica fault sites, expire
        global-queue deadlines, dispatch pending work, step every
        in-rotation replica (collecting finishes and refreshing the
        token mirror), then run the failure detectors and rejoin
        probes. Returns every request that finished this tick —
        exactly once each, whichever replica(s) it lived on."""
        now = self._group_now()
        out: List[GenerationResult] = []
        if self._shed_results:
            out.extend(self._shed_results)
            for r in self._shed_results:
                self._mark_done(r)
            self._shed_results = []
        self._consult_faults()
        self._expire_pending(now, out)
        self._dispatch(now)
        for rep in self._replicas:
            if not rep.in_rotation:
                continue
            if rep.stall_ticks > 0:
                # injected stall: the replica is not stepped — its
                # requests sit, and the zero-progress probe below is
                # what must notice
                rep.stall_ticks -= 1
                continue
            if rep.slow_ticks > 0 and rep.engine.has_work():
                rep.slow_ticks -= 1
                time.sleep(rep.slow_seconds)
            if not rep.engine.has_work():
                rep.consecutive_failures = 0
                rep.no_progress_ticks = 0
                rep.progress_mark = rep.engine.progress_marker
                continue
            try:
                results = rep.engine.step()
            except Exception as exc:  # noqa: BLE001 - fault isolation
                rep.consecutive_failures += 1
                rep.last_error = f"{type(exc).__name__}: {exc}"
                if (
                    rep.consecutive_failures >= self.failure_threshold
                ):
                    self._quarantine_replica(
                        rep, why=f"step failures: {rep.last_error}"
                    )
                continue
            rep.consecutive_failures = 0
            for r in results:
                self._deliver(r, out)
            self._refresh_mirror(rep)
            self._record_class_latency(rep)
        if self._has_classes:
            self._handoff_prefill()
        self._probe_health()
        self._probe_progress()
        self._probe_rejoin()
        self._tick += 1
        if self.registry.enabled:
            self._g_healthy.set(self.healthy_replicas)
            self._g_pending.set(len(self._pending))
        if self.timeseries is not None:
            self.timeseries.tick()
        return out

    def cancel(self, request_id: int) -> Optional[GenerationResult]:
        """Cancel one request wherever it lives — global queue or any
        replica — returning the partial result, or None if unknown or
        already finished."""
        for rec in self._pending:
            if rec["request_id"] == request_id:
                self._pending.remove(rec)
                r = self._pending_result(rec, "cancelled")
                self._mark_done(r)
                return r
        idx = self._assigned.get(request_id)
        if idx is None:
            return None
        r = self._replicas[idx].engine.cancel(request_id)
        if r is not None:
            self._mark_done(r)
        return r

    #: consecutive zero-finish/zero-progress fleet ticks tolerated by
    #: the bounded loops (`generate`/`drain`) before diagnosing a
    #: wedged fleet — mirrors InferenceEngine._GENERATE_STALL_TICKS
    _STALL_TICKS = 1000

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
    ) -> List[GenerationResult]:
        """Batch convenience: queue every prompt, run the fleet dry,
        return results in prompt order (same contract as the
        engine's `generate`). Bounded: a long run of ticks with no
        progress raises a diagnostic instead of spinning."""
        ids = [self.add_request(p, max_new_tokens) for p in prompts]
        done: Dict[int, GenerationResult] = {}
        self._run_dry(done)
        return [done[i] for i in ids]

    def drain(self, shed_queue: bool = False) -> List[GenerationResult]:
        """Fleet shutdown: close admission, run every replica dry
        (migrating off any that fail on the way down), close each
        engine's own admission, and return the remaining results.
        ``shed_queue=True`` cancels the still-pending global queue up
        front. Idempotent."""
        already, self._draining = self._draining, True
        out: List[GenerationResult] = []
        if shed_queue:
            while self._pending:
                rec = self._pending.popleft()
                r = self._pending_result(rec, "cancelled")
                self._mark_done(r)
                out.append(r)
        done: Dict[int, GenerationResult] = {}
        self._run_dry(done)
        out.extend(done.values())
        if not already:
            for rep in self._replicas:
                if rep.in_rotation:
                    rep.engine.drain()
        return out

    def drain_replica(self, i: int) -> None:
        """Rolling restart, step 1: migrate replica ``i``'s queue and
        in-flight work to the rest of the fleet and take it out of
        rotation (state ``drained``, engine admission closed). The
        fleet keeps serving throughout — survivors' decodes never
        stall on this. `rejoin_replica(i)` is step 2."""
        rep = self._replicas[i]
        if rep.state == "drained":
            return
        recs = rep.engine.evacuate(ship_pages=rep.engine.paged)
        self._requeue(recs)
        rep.engine.drain()  # idempotent; closes the engine's admission
        rep.state = "drained"
        self._count_event("drain_replica")
        if self.tracer.enabled:
            # every migrated request named, so the merged timeline can
            # group this replica-scoped event into each lifeline
            self.tracer.instant(
                "drain_replica", track="router", replica=i,
                migrated=len(recs),
                request_ids=[r["request_id"] for r in recs],
                trace_ids=[r.get("trace_id", "") for r in recs],
            )

    def rejoin_replica(self, i: int) -> None:
        """Rolling restart, step 2: `reopen()` the drained (or
        quarantined) replica — the clean-state proof lives there —
        and put it back in rotation."""
        rep = self._replicas[i]
        if rep.in_rotation:
            return
        rep.engine.reopen()
        rep.state = "up"
        rep.consecutive_failures = 0
        rep.no_progress_ticks = 0
        rep.progress_mark = rep.engine.progress_marker
        self._rejoins += 1
        self._count_event("rejoin")
        if self.tracer.enabled:
            self.tracer.instant(
                "rejoin", track="router", replica=i,
                replica_class=rep.replica_class,
                after_ticks=self._tick - rep.quarantined_at,
            )

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Fleet counters (one flat dict, the engine `stats()` shape):
        router-level lifecycle events plus per-reason finish counts
        (``finished_<reason>``; delivered shed requests count under
        ``finished_queue_full``). The fleet accounting identity —
        every submitted request is accounted exactly once:
        ``completed + undelivered-shed + pending + in_flight ==
        submitted`` at any tick boundary, and after `drain()` simply
        ``completed == submitted``."""
        out: Dict[str, float] = {
            "replicas": float(self.num_replicas),
            "healthy_replicas": float(self.healthy_replicas),
            "pending_depth": float(len(self._pending)),
            "in_flight": float(len(self._assigned)),
            "submitted": float(self._submitted),
            "completed": float(len(self._done)),
            "shed": float(self._shed),
            "migrations": float(self._migrations),
            "replica_quarantines": float(self._quarantines),
            "replica_rejoins": float(self._rejoins),
            "affinity_hits": float(self._affinity_hits),
            "adapter_affinity_hits": float(
                self._adapter_affinity_hits
            ),
            "replica_kills": float(self._kills),
            "handoffs": float(self._handoffs),
            "page_migrations": float(self._page_migrations),
        }
        if self._prefix_registry is not None:
            out["shared_prefix_chains"] = float(
                len(self._prefix_registry)
            )
        for reason, n in sorted(self._finished.items()):
            out[f"finished_{reason}"] = float(n)
        return out

    def merged_registry(self):
        """One fresh `MetricRegistry` holding the router's own series
        merged with every replica's enabled registry (``merge_from``:
        counter and bucket adds are exact), so fleet percentiles
        reproduce the combined per-replica streams. Pass this method,
        not its result, to the exporter as the per-scrape provider."""
        merged = MetricRegistry()
        merged.merge_from(self.registry)
        for rep in self._replicas:
            if rep.engine.registry.enabled:
                merged.merge_from(rep.engine.registry)
        return merged

    def merged_trace(self, labels: Optional[List[str]] = None
                     ) -> Dict[str, Any]:
        """One Perfetto-loadable body for the fleet: the router's tracer
        and every replica's, folded by `monitor.trace.merge_traces` (the
        router is process 1, replica ``i`` process ``i + 2``), a
        migrated request's hops one ``trace_id`` lifeline. Default
        labels: ``router``, ``replica<i>:<class>``."""
        tracers = [self.tracer] + [rep.engine.tracer
                                   for rep in self._replicas]
        if labels is None:
            labels = ["router"] + [
                f"replica{rep.index}:{rep.replica_class}"
                for rep in self._replicas
            ]
        return merge_traces(tracers, labels)

    def export_merged_trace(self, path: str) -> int:
        """`merged_trace` to disk; returns the event count."""
        body = self.merged_trace()
        with open(path, "w") as f:
            json.dump(body, f)
        return len(body["traceEvents"])

    def arm_retrace_sentinel(self) -> None:
        """Refused: the retrace sentinel waits for ROADMAP Queue 1
        item 9b."""
        raise NotImplementedError(
            _NOT_PORTED.format(what="arm_retrace_sentinel"))

    def health(self) -> Dict[str, Any]:
        """Fleet liveness for `/healthz`: healthy while ANY replica
        remains in rotation — one dead replica is the fabric working,
        zero is the outage a load balancer must see as 503.
        Per-replica detail lives in `varz()`."""
        return {
            "healthy": self.healthy_replicas > 0,
            "replicas": self.num_replicas,
            "healthy_replicas": self.healthy_replicas,
            "draining": self._draining,
            "queue_depth": len(self._pending),
            "ticks": self._tick,
        }

    def varz(self) -> Dict[str, Any]:
        """Per-replica detail for `/varz`: rotation state, failure
        latches, and each engine's own health signals."""
        out: Dict[str, Any] = {
            "router": self.stats(),
            "replica_detail": [
                {
                    "replica": rep.index,
                    "class": rep.replica_class,
                    "state": rep.state,
                    "consecutive_failures": rep.consecutive_failures,
                    "no_progress_ticks": rep.no_progress_ticks,
                    "last_error": rep.last_error,
                    "watchdog_fires": int(
                        getattr(rep.engine, "_watchdog_fires", 0)
                    ),
                    "draining": rep.engine.draining,
                    "queue_depth": rep.engine.num_queued,
                    "slots_active": rep.engine.num_active,
                    "pages_used": rep.engine.pages_used,
                }
                for rep in self._replicas
            ],
        }
        return out

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _count_event(self, event: str) -> None:
        if self.registry.enabled:
            self._c_events.inc(event=event)

    def _run_dry(self, done: Dict[int, GenerationResult]) -> None:
        stale = 0
        mark = (len(self._done), self._progress_signature())
        while self.has_work():
            results = self.step()
            for r in results:
                done[r.request_id] = r
            work = (len(self._done), self._progress_signature())
            if results or work != mark:
                stale, mark = 0, work
                continue
            stale += 1
            if stale >= self._STALL_TICKS:
                states = {
                    rep.index: rep.state for rep in self._replicas
                }
                raise RuntimeError(
                    f"fleet stalled: {stale} consecutive ticks with "
                    f"no progress; pending={len(self._pending)} "
                    f"in_flight={len(self._assigned)} "
                    f"replicas={states}"
                )

    def _progress_signature(self):
        return tuple(
            rep.engine.progress_marker for rep in self._replicas
        )

    def _group_now(self) -> float:
        """The tick's clock: at tp > 1, tensor rank 0's (one exchange)
        while a request in the global queue has a deadline or a TTL,
        so that every rank expires the same records; else this
        process's."""
        if self.tp > 1 and any(
                rec["deadline"] is not None
                or rec["queue_deadline"] is not None
                for rec in self._pending):
            return group_clock(self.tp, self._axis)
        return time.perf_counter()

    def _expire_pending(
        self, now: float, out: List[GenerationResult]
    ) -> None:
        """Deadline sweep over the GLOBAL queue (requests a dead fleet
        could not place still expire on time)."""
        if not self._pending:
            return
        keep: collections.deque = collections.deque()
        for rec in self._pending:
            expired = (
                (rec["queue_deadline"] is not None
                 and now > rec["queue_deadline"])
                or (rec["deadline"] is not None
                    and now > rec["deadline"])
            )
            if expired:
                r = self._pending_result(rec, "deadline")
                self._mark_done(r)
                out.append(r)
            else:
                keep.append(rec)
        self._pending = keep

    def _pending_result(
        self, rec: Dict[str, Any], reason: str
    ) -> GenerationResult:
        # a recovered request waiting in the global queue keeps the
        # tokens it already emitted — they were delivered work
        return GenerationResult(
            request_id=rec["request_id"], prompt=list(rec["prompt"]),
            tokens=list(rec["generated"]), finish_reason=reason,
        )

    def _dispatch(self, now: float) -> None:
        """Drain the global queue into the fleet: prefix-affinity
        first, least-loaded otherwise, bounded per-replica backlog."""
        while self._pending:
            candidates = [
                rep for rep in self._replicas
                if rep.in_rotation and rep.stall_ticks == 0
                and (
                    rep.engine.num_active < rep.engine.num_slots
                    or rep.engine.num_queued < self.replica_queue_depth
                )
            ]
            if not candidates:
                return
            rec = self._pending.popleft()
            rep = self._place(rec, candidates)
            rid = rec["request_id"]
            rep.engine.resume_request(
                rec["prompt"], rec["max_new_tokens"], rid,
                generated=rec["generated"],
                enqueued_at=rec["enqueued_at"],
                deadline=rec["deadline"],
                queue_deadline=rec["queue_deadline"],
                first_token_at=rec["first_token_at"],
                chunks=rec["chunks"],
                pages=rec.pop("pages", None),
                adapter_id=rec.get("adapter_id", 0),
                tenant=rec.get("tenant"),
                trace_id=rec.get("trace_id"),
            )
            self._assigned[rid] = rep.index
            self._mirror[rid] = rec
            if self.tracer.enabled:
                self.tracer.instant(
                    "dispatch", ts=now, track=f"req{rid}",
                    replica=rep.index, carried=len(rec["generated"]),
                    request_id=rid, trace_id=rec.get("trace_id"),
                )

    def _place(
        self, rec: Dict[str, Any], candidates: List[_Replica]
    ) -> _Replica:
        # replica classes: fresh prompts prefer the prefill class,
        # carried requests (recoveries, handoffs) the decode class;
        # the mixed class backstops either, and when no preferred
        # replica has room ANY candidate beats queueing — class purity
        # never costs availability
        if self._has_classes:
            preferred = "decode" if rec["generated"] else "prefill"
            classed = [
                rep for rep in candidates
                if rep.replica_class == preferred
            ] or [
                rep for rep in candidates
                if rep.replica_class == "mixed"
            ]
            if classed:
                candidates = classed
        # adapter affinity: a replica where the request's adapter is
        # already resident skips the host->device upload (and spares
        # some other tenant an eviction); narrow to those replicas
        # when any exist, then let prefix affinity / least-loaded pick
        # within them
        aid = rec.get("adapter_id", 0)
        if aid:
            resident = [
                rep for rep in candidates
                if rep.engine.adapter_pool is not None
                and rep.engine.adapter_pool.resident(aid)
            ]
            if resident:
                candidates = resident
                self._adapter_affinity_hits += 1
                self._count_event("adapter_affinity_hit")
                if self.tracer.enabled:
                    self.tracer.instant(
                        "adapter_affinity_hit",
                        track=f"req{rec['request_id']}", adapter=aid,
                        request_id=rec["request_id"],
                        trace_id=rec.get("trace_id"),
                    )
        # prefix affinity: the replica already holding the longest
        # materialized prefix of this prompt skips that much prefill
        # (recovered requests carry tokens and re-prefill anyway, so
        # affinity only scores fresh prompts)
        if not rec["generated"]:
            best, best_tokens = None, 0
            if self._prefix_registry is not None:
                # one chain walk against the fleet-wide registry
                # instead of N per-engine store consults
                matched = self._prefix_registry.best(rec["prompt"])
                for rep in candidates:
                    n = matched.get(rep.index, 0)
                    if n > best_tokens:
                        best, best_tokens = rep, n
            else:
                for rep in candidates:
                    n = rep.engine.prefix_match_tokens(rec["prompt"])
                    if n > best_tokens:
                        best, best_tokens = rep, n
            if best is not None:
                self._affinity_hits += 1
                self._count_event("affinity_hit")
                if self.tracer.enabled:
                    self.tracer.instant(
                        "affinity_hit", track=f"req{rec['request_id']}",
                        replica=best.index, tokens=best_tokens,
                        request_id=rec["request_id"],
                        trace_id=rec.get("trace_id"),
                    )
                return best
        # least-loaded: fewest owned requests, then fewest live pages,
        # then lowest index (deterministic tie-break)
        return min(
            candidates,
            key=lambda rep: (
                rep.engine.num_active + rep.engine.num_queued,
                rep.engine.pages_used,
                rep.index,
            ),
        )

    def _deliver(
        self, r: GenerationResult, out: List[GenerationResult]
    ) -> None:
        self._mark_done(r)
        out.append(r)

    def _mark_done(self, r: GenerationResult) -> None:
        rid = r.request_id
        if rid in self._done:
            # the no-duplicate guarantee is the recovery contract;
            # a second result for one id means migration double-owned
            # a request — refuse to deliver it silently
            raise RuntimeError(
                f"request {rid} finished twice "
                f"(second finish_reason={r.finish_reason!r})"
            )
        self._done.add(rid)
        self._finished[r.finish_reason] = (
            self._finished.get(r.finish_reason, 0) + 1
        )
        self._assigned.pop(rid, None)
        self._mirror.pop(rid, None)

    def _refresh_mirror(self, rep: _Replica) -> None:
        for rec in rep.engine.outstanding():
            mine = self._mirror.get(rec["request_id"])
            if mine is not None:
                mine["generated"] = rec["generated"]
                mine["first_token_at"] = rec["first_token_at"]
                mine["chunks"] = rec["chunks"]

    def _record_class_latency(self, rep: _Replica) -> None:
        """Fold the replica's NEW completion records into the
        class-labeled TTFT/TPOT families — the per-class attribution
        the disaggregated fleet is judged by."""
        if not self.registry.enabled:
            return
        records = rep.engine.completions
        if len(records) < rep.completions_seen:
            rep.completions_seen = 0  # engine reset_stats
        fresh = records[rep.completions_seen:]
        rep.completions_seen = len(records)
        for c in fresh:
            if c.get("new_tokens", 0) <= 0:
                continue  # shed/cancelled before any token: no latency
            self._h_class_ttft.observe(
                c["ttft_ms"], replica_class=rep.replica_class
            )
            self._h_class_tpot.observe(
                c["tpot_ms"], replica_class=rep.replica_class
            )

    def _handoff_prefill(self) -> None:
        """The disaggregation transfer: a prefill-class replica keeps
        a request only until its prompt is materialized (>= 1 token
        emitted); it is then evacuated WITH its KV pages and requeued
        — `_place` lands carried requests on the decode class, where
        the payload imports and decode continues without re-prefill.
        Skipped entirely while no decode-class replica has room: the
        request keeps decoding where it is (availability over class
        purity), and a dropped/failed page import degrades to token
        replay — token-identical either way."""
        decode_ready = any(
            rep.in_rotation and rep.replica_class == "decode"
            and rep.stall_ticks == 0
            and (
                rep.engine.num_active < rep.engine.num_slots
                or rep.engine.num_queued < self.replica_queue_depth
            )
            for rep in self._replicas
        )
        if not decode_ready:
            return
        for rep in self._replicas:
            if not rep.in_rotation or rep.replica_class != "prefill":
                continue
            for rec0 in rep.engine.outstanding():
                if not rec0["generated"]:
                    continue
                rec = rep.engine.evacuate_request(
                    rec0["request_id"], ship_pages=True
                )
                if rec is None:
                    continue
                self._handoffs += 1
                self._count_event("handoff")
                if self.tracer.enabled:
                    self.tracer.instant(
                        "handoff", track=f"req{rec['request_id']}",
                        replica=rep.index, shipped="pages" in rec,
                        request_id=rec["request_id"],
                        trace_id=rec.get("trace_id"),
                    )
                self._requeue([rec])

    def _requeue(self, recs: List[Dict[str, Any]]) -> None:
        """Resubmit migration records at the HEAD of the global queue
        (preserving their order ahead of fresh arrivals)."""
        for rec in reversed(recs):
            rid = rec["request_id"]
            self._assigned.pop(rid, None)
            self._mirror.pop(rid, None)
            self._pending.appendleft(rec)
            self._migrations += 1
            self._count_event("migration")
            if "pages" in rec:
                self._page_migrations += 1
                self._count_event("page_migration")
            if self.tracer.enabled:
                self.tracer.instant(
                    "migrate", track=f"req{rid}",
                    carried=len(rec["generated"]), shipped="pages" in rec,
                    request_id=rid, trace_id=rec.get("trace_id"),
                )

    def _quarantine_replica(self, rep: _Replica, why: str) -> None:
        """Failure path for a replica whose ENGINE is still intact
        (step failures, watchdog, zero progress): evacuate its exact
        request inventory — WITH its KV pages on a paged cache, so the
        destination can resume by page import instead of re-prefill —
        and put it back on the global queue."""
        recs = rep.engine.evacuate(ship_pages=rep.engine.paged)
        self._requeue(recs)
        rep.state = "quarantined"
        rep.quarantined_at = self._tick
        rep.last_error = why
        self._quarantines += 1
        self._count_event("quarantine")
        if self.tracer.enabled:
            self.tracer.instant(
                "quarantine_replica", track="router",
                replica=rep.index, why=why, migrated=len(recs),
                request_ids=[r["request_id"] for r in recs],
                trace_ids=[r.get("trace_id", "") for r in recs],
            )

    def _kill_replica(self, rep: _Replica) -> None:
        """`replica_kill`: the engine is presumed crashed — recover
        every request it held from the ROUTER's token mirror (the
        engine's own state is not trusted), then evacuate the carcass
        so its pages and slots provably free before any rejoin."""
        recs = [
            dict(self._mirror[rid], generated=list(
                self._mirror[rid]["generated"]
            ))
            for rid, idx in sorted(self._assigned.items())
            if idx == rep.index and rid in self._mirror
        ]
        rep.engine.evacuate()  # discard — recovery used the mirror
        self._requeue(recs)
        rep.state = "quarantined"
        rep.quarantined_at = self._tick
        rep.last_error = "replica_kill (chaos)"
        self._kills += 1
        self._quarantines += 1
        self._count_event("kill")
        self._count_event("quarantine")
        if self.tracer.enabled:
            self.tracer.instant(
                "kill_replica", track="router", replica=rep.index,
                recovered=len(recs),
                request_ids=[r["request_id"] for r in recs],
                trace_ids=[r.get("trace_id", "") for r in recs],
            )

    def _consult_faults(self) -> None:
        if not self.faults.enabled:
            return
        for site in ("replica_kill", "replica_stall", "replica_slow"):
            f = self.faults.fire(site, tick=self._tick)
            if f is None:
                continue
            payload = dict(f.payload or {})
            idx = int(payload.get("replica", 0)) % self.num_replicas
            self.fault_log.append((site, self._tick, idx))
            rep = self._replicas[idx]
            if site == "replica_kill":
                if rep.in_rotation:
                    self._kill_replica(rep)
            elif site == "replica_stall":
                rep.stall_ticks += int(payload.get("ticks", 3))
                self._count_event("stall")
            else:  # replica_slow
                rep.slow_ticks += int(payload.get("ticks", 1))
                rep.slow_seconds = float(
                    payload.get("seconds", 0.01)
                )
                self._count_event("slow")

    def _probe_health(self) -> None:
        """The `engine_health` probe, inlined: any watchdog fire on an
        in-rotation replica quarantines it this tick."""
        for rep in self._replicas:
            if not rep.in_rotation:
                continue
            if int(getattr(rep.engine, "_watchdog_fires", 0)) > 0:
                self._quarantine_replica(rep, why="watchdog fired")

    def _probe_progress(self) -> None:
        """Zero-progress detector: a replica that OWNS work but moved
        no tokens for `stall_grace` consecutive ticks is wedged
        (injected stall, deadlocked pool, hung host thread) —
        quarantine and migrate."""
        for rep in self._replicas:
            if not rep.in_rotation:
                continue
            if not rep.engine.has_work():
                rep.no_progress_ticks = 0
                rep.progress_mark = rep.engine.progress_marker
                continue
            mark = rep.engine.progress_marker
            if mark != rep.progress_mark:
                rep.no_progress_ticks = 0
                rep.progress_mark = mark
                continue
            rep.no_progress_ticks += 1
            if rep.no_progress_ticks >= self.stall_grace:
                self._quarantine_replica(rep, why="zero progress")

    def _probe_rejoin(self) -> None:
        """Quarantined replicas are probed back: after `rejoin_after`
        ticks (and any injected stall has lapsed), `reopen()` proves
        the clean state and the replica rejoins rotation; a failed
        probe leaves it quarantined for the next round."""
        for rep in self._replicas:
            if rep.state != "quarantined":
                continue
            if rep.stall_ticks > 0:
                rep.stall_ticks -= 1
                continue
            if self._tick - rep.quarantined_at < self.rejoin_after:
                continue
            try:
                self.rejoin_replica(rep.index)
            except RuntimeError as exc:
                rep.last_error = f"rejoin probe failed: {exc}"
