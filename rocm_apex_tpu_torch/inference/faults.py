"""Deterministic fault injection for the serving engine.

Port of ``rocm_apex_tpu/inference/faults.py``, host-only numpy, kept as
the port's own copy: the same plan fires at the same calls in both
engines. The robustness layer's chaos harness: a `FaultPlan` names the engine's
failure sites and schedules WHEN each one misbehaves — by engine tick,
by nth call to the site, by period, or with a seeded coin flip — so a
test (or ``bench.py serve --chaos=SEED``) can replay the exact same
failure sequence on every run and assert that the non-faulted requests
come out bitwise identical to a fault-free run.

Sites the engine threads through (see `InferenceEngine`):

``page_alloc``
    The host page allocator "fails" to supply a page: the call site
    takes its ordinary backpressure path (the token is not scheduled
    this tick) — exactly what a genuinely exhausted pool does.
``device_step``
    Raises `FaultInjected` in place of the mixed/decode device call
    — exercises the retry/backoff and preempt-and-requeue paths.
``logits``
    Poisons ONE slot's logits with NaN/Inf for the tick (payload picks
    the slot and value): the in-graph nonfinite flags fire and the
    engine quarantines that slot only.
``host_fetch``
    Raises `FaultInjected` between the device call and the value
    fetch — same retry path, different failure point.
``page_ship``
    Drops a page-shipping migration payload at import time (as if the
    KV transfer was lost mid-flight): the destination engine falls back
    to token-replay recovery — token-identical, just slower — and the
    already-released source pages simply stay freed, so neither
    allocator can leak.

Replica-scoped sites the `ReplicaRouter` consults (the ``payload``
names the target: ``{"replica": i}``; the router consults each site
once per ROUTER tick, so ``tick`` schedules are in the router's tick
domain, not any engine's):

``replica_kill``
    The replica is treated as crashed: the router quarantines it and
    resubmits every request it held — from the router's own token
    mirror, never the dead engine's state — to the healthy fleet.
``replica_stall``
    The replica stops being stepped for ``payload["ticks"]`` router
    ticks (default 3): its requests make no progress, so the router's
    zero-progress detector must notice and migrate them.
``replica_slow``
    Injected latency: ``payload["seconds"]`` of host sleep before
    each of the replica's next ``payload["ticks"]`` steps (defaults
    0.01 s × 1 tick) — skews that replica's TTFT/TPOT streams so the
    merged-registry percentiles have something to reproduce.

Hot-path contract: ``NO_FAULTS`` is the shared disabled plan (the
`NULL_TRACER` idiom) — every call site gates on ``faults.enabled``
first, so a fault-free engine pays one attribute check per site and
nothing else. Scheduling is pure host bookkeeping; the device steps never change
shape under any plan.

Determinism: ``tick``/``nth``/``every`` schedules are exact;
probabilistic faults (``p``) draw from a `numpy` generator seeded in
the plan, so the same seed replays the same failures. Call counters
live in the plan — build a fresh plan (or `reset()`) per run.
"""

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Fault", "FaultPlan", "FaultInjected", "NO_FAULTS", "SITES"]

#: The injection sites a plan may name — a typoed site must not
#: silently never fire. The first four are consulted by the engine
#: (per engine tick); the ``replica_*`` sites by the `ReplicaRouter`
#: (per router tick, payload ``{"replica": i}``).
SITES = (
    "page_alloc", "device_step", "logits", "host_fetch", "page_ship",
    "replica_kill", "replica_stall", "replica_slow",
)


class FaultInjected(RuntimeError):
    """Raised by an injected ``device_step``/``host_fetch`` fault.

    A `RuntimeError` subclass so handlers written for real device
    failures treat it identically; `isinstance` checks let tests tell
    injected failures from genuine ones.
    """


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled misbehaviour at one site.

    Exactly when it fires is the OR of the schedules given:

    ``tick``   fire on this engine tick (0-based `step()` count)
    ``nth``    fire on the nth call to the site (1-based)
    ``every``  fire on every ``every``-th call to the site
    ``p``      fire with probability p per call (plan-seeded RNG)

    ``times`` caps the total fires of THIS fault (default 1; ``None``
    = unlimited). ``payload`` carries site-specific detail — for
    ``logits`` a dict like ``{"slot": 1, "value": float("nan")}``.
    """

    site: str
    tick: Optional[int] = None
    nth: Optional[int] = None
    every: Optional[int] = None
    p: float = 0.0
    times: Optional[int] = 1
    payload: Any = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; engine sites are "
                f"{SITES}"
            )
        if (
            self.tick is None and self.nth is None
            and self.every is None and self.p <= 0.0
        ):
            raise ValueError(
                f"fault at {self.site!r} has no schedule: set tick, "
                f"nth, every, or p"
            )
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.nth is not None and self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")


class FaultPlan:
    """A seeded schedule of `Fault`s plus per-site call counters.

    ``fire(site, tick=...)`` advances the site's call counter and
    returns the first scheduled fault that matches (at most ONE fault
    per site per call — the engine consults each site once per place
    it can fail), or None. ``fires`` tallies what actually fired, for
    completion-accounting asserts.
    """

    enabled: bool = True

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)
        self.enabled = bool(self.faults)
        self.reset()

    def reset(self) -> None:
        """Rewind every counter and the RNG — replay from scratch."""
        self._rng = np.random.RandomState(self.seed)
        self._calls: Dict[str, int] = {s: 0 for s in SITES}
        self._fired: Dict[int, int] = {
            i: 0 for i in range(len(self.faults))
        }
        self.fires: Dict[str, int] = {s: 0 for s in SITES}

    def calls(self, site: str) -> int:
        return self._calls[site]

    def fire(
        self, site: str, tick: Optional[int] = None, **ctx
    ) -> Optional[Fault]:
        """One consultation of ``site``; returns the fault that fires
        now (and books it), else None. ``ctx`` is accepted so call
        sites can pass slot/request detail without the plan caring."""
        self._calls[site] += 1
        n = self._calls[site]
        for i, f in enumerate(self.faults):
            if f.site != site:
                continue
            if f.times is not None and self._fired[i] >= f.times:
                continue
            hit = (
                (f.tick is not None and tick == f.tick)
                or (f.nth is not None and n == f.nth)
                or (f.every is not None and n % f.every == 0)
                or (f.p > 0.0 and self._rng.random_sample() < f.p)
            )
            if hit:
                self._fired[i] += 1
                self.fires[site] += 1
                return f
        return None


#: Shared null plan (the `NULL_TRACER` idiom): call sites check
#: ``faults.enabled`` and skip the schedule walk entirely.
NO_FAULTS = FaultPlan(())
