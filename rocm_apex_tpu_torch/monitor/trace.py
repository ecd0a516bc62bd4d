"""Host-side span tracer: wall-clock timelines as Chrome trace events.

Port of ``rocm_apex_tpu/monitor/trace.py`` (host-only Python, the port's
own copy):

* ``tracer.span("prefill", tokens=n)``: a context manager recording a
  wall-clock span into a thread-safe ring buffer (bounded memory: a
  long serving run keeps the last ``capacity`` events, oldest dropped
  and counted in `dropped` and, with a registry, in
  ``tracer_dropped_events_total``);
* a live span also enters a `torch.profiler.record_function` scope (and
  `step_span` one named ``<name>#<step>``) when ``annotate_device`` is
  on, so a concurrent `torch.profiler` capture shows the host spans
  against the card's kernels;
* retrospective ``add_span(name, begin, end)`` and ``instant`` record
  from timestamps the caller already holds and annotate nothing: the
  serving engine builds its per-request timelines this way from the same
  ``perf_counter`` readings that feed ``stats()``, so span boundaries
  reproduce the reported TTFT and queue wait;
* ``export_chrome_trace(path)`` writes the Chrome trace-event JSON
  (``ph: "X"`` complete events over named tracks) Perfetto loads.

The disabled path is the default and costs an attribute check:
``NULL_TRACER`` is a shared singleton whose ``span()`` returns one
preallocated no-op context manager.

Fleet-causal tracing: `mint_trace_id` stamps one process-unique id on
every admitted request, which rides every hop as an ``args`` field;
`merge_traces` folds N tracers into one body (one ``pid`` per tracer,
timestamps renormalized onto one ``perf_counter`` zero, so tracers of
one process line up); `trace_lifelines` groups a body by trace id (one
``finish`` per lifeline is the exactly-once check).

The JAX module's `RetraceSentinel` subscribes to jax's compilation
events; its counterpart waits for ROADMAP Queue 1 item 9b.
"""

import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = [
    "Tracer",
    "NULL_TRACER",
    "mint_trace_id",
    "merge_traces",
    "export_merged_trace",
    "trace_lifelines",
]


class _NullSpan:
    """Shared no-op context manager for the disabled path (one
    module-level instance; entering it allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle: records on exit, annotates the device
    timeline while open."""

    __slots__ = ("_tracer", "name", "track", "args", "_t0", "_ann")

    def __init__(self, tracer, name, track, args, annotation):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._ann = annotation
        self._t0 = 0.0

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc):
        end = self._tracer.clock()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer.add_span(
            self.name, self._t0, end, track=self.track, **self.args
        )
        return False


class Tracer:
    """Thread-safe wall-clock span recorder with Chrome-JSON export.

    ``capacity`` bounds the ring buffer (oldest events drop — a
    serving run can trace forever in constant memory);
    ``annotate_device=True`` (default) additionally wraps every live
    `span` in a `torch.profiler.record_function` scope so a concurrent
    `torch.profiler` capture shows the host spans against the card's
    kernels (`add_span` and `instant` annotate nothing). All timestamps are ``time.perf_counter`` seconds relative to
    the tracer's creation (one clock — the engine's ``stats()``
    latencies and the exported spans can be compared directly).

    Construct with ``enabled=False`` (or use the shared
    ``NULL_TRACER``) for the free disabled path: ``span`` returns a
    shared no-op context manager and every ``add_*`` returns
    immediately.
    """

    def __init__(
        self,
        enabled: bool = True,
        capacity: int = 65536,
        annotate_device: bool = True,
        registry=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.annotate_device = annotate_device
        self.clock = time.perf_counter
        self._t0 = self.clock()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        # ring-wrap visibility: a full ring drops the OLDEST event per
        # append — count the drops (they used to be silent) and, when
        # a telemetry registry is attached, export them as a counter
        # alongside the serving metrics
        self._dropped = 0
        self._drop_counter = (
            registry.counter(
                "tracer_dropped_events_total",
                "Trace events evicted by ring-buffer wrap "
                "(raise Tracer(capacity=...) if nonzero).",
            )
            if registry is not None else None
        )
        # track name -> tid, in registration order (Perfetto sorts by
        # the sort_index metadata we export, so registration order IS
        # display order: engine track first, then requests as admitted)
        self._tracks: Dict[str, int] = {}

    # -- recording ------------------------------------------------------

    def span(self, name: str, track: Optional[str] = None, **args):
        """Context manager timing a live region (one ring-buffer event
        on exit; a `TraceAnnotation` scope while open)."""
        if not self.enabled:
            return _NULL_SPAN
        ann = None
        if self.annotate_device:
            label = name
            if args:
                label = f"{name}|{json.dumps(args, default=str, sort_keys=True)}"
            ann = torch.profiler.record_function(label)
        return _Span(self, name, track, args, ann)

    def step_span(self, step: int, name: str = "train_step"):
        """`StepTraceAnnotation`-aligned span for one train step: the
        profiler groups the device ops under the step number, and the
        host-side span records wall time for the same tick."""
        if not self.enabled:
            return _NULL_SPAN
        ann = None
        if self.annotate_device:
            ann = torch.profiler.record_function(f"{name}#{int(step)}")
        return _Span(self, name, None, {"step": int(step)}, ann)

    def add_span(
        self,
        name: str,
        begin: float,
        end: float,
        track: Optional[str] = None,
        **args,
    ) -> None:
        """Record a completed span from caller-held ``perf_counter``
        timestamps (the engine's retrospective per-request spans)."""
        if not self.enabled:
            return
        with self._lock:
            self._note_wrap_locked()
            self._events.append(
                ("X", name, self._tid_locked(track), begin, end - begin, args)
            )

    def instant(
        self, name: str, ts: Optional[float] = None,
        track: Optional[str] = None, **args,
    ) -> None:
        """Record a zero-duration marker (request enqueue/finish)."""
        if not self.enabled:
            return
        if ts is None:
            ts = self.clock()
        with self._lock:
            self._note_wrap_locked()
            self._events.append(
                ("i", name, self._tid_locked(track), ts, 0.0, args)
            )

    def _note_wrap_locked(self) -> None:
        """Called before an append: a full ring is about to evict its
        oldest event — account the drop instead of losing it silently."""
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
            if self._drop_counter is not None:
                self._drop_counter.inc()

    @property
    def dropped(self) -> int:
        """Events evicted by ring wrap since creation (`clear` does
        not reset it — the count is about the tracer's lifetime)."""
        return self._dropped

    def _tid_locked(self, track: Optional[str]) -> int:
        if track is None:
            track = "main"
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks)
            self._tracks[track] = tid
        return tid

    # -- access / export ------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event dicts (host pid 1, ts/dur in µs since
        tracer creation) — the body `export_chrome_trace` writes."""
        with self._lock:
            snap = list(self._events)
            tracks = dict(self._tracks)
        out: List[Dict[str, Any]] = []
        for track, tid in tracks.items():
            out.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": track},
            })
            out.append({
                "ph": "M", "name": "thread_sort_index", "pid": 1,
                "tid": tid, "args": {"sort_index": tid},
            })
        for ph, name, tid, ts, dur, args in snap:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "pid": 1, "tid": tid,
                "ts": round((ts - self._t0) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def export_chrome_trace(self, path: str) -> int:
        """Write the Perfetto-loadable JSON; returns the event count
        (metadata included)."""
        events = self.events()
        other: Dict[str, Any] = {
            "producer": "rocm_apex_tpu_torch.monitor.trace",
            "process_name": "host",
            "dropped_events": self._dropped,
        }
        if self._dropped:
            other["warning"] = (
                f"{self._dropped} events dropped by ring-buffer wrap "
                f"(capacity {self._events.maxlen}); the timeline is "
                f"incomplete — raise Tracer(capacity=...)"
            )
        with open(path, "w") as f:
            json.dump(
                {
                    "traceEvents": events,
                    "displayTimeUnit": "ms",
                    "otherData": other,
                },
                f,
            )
        return len(events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tracks.clear()


# The free default: share one disabled tracer so every call site can
# hold a tracer unconditionally and pay only `tracer.enabled` checks.
NULL_TRACER = Tracer(enabled=False, capacity=1)


# ---------------------------------------------------------------------
# fleet-causal trace context
# ---------------------------------------------------------------------

_TRACE_SEQ = itertools.count()


def mint_trace_id(prefix: str = "t") -> str:
    """One process-unique trace id: ``<prefix><pid hex>-<seq hex>``.
    The router mints one per ADMITTED request (not per attempt), so a
    request that migrates, fails over, or hands off keeps the same id
    across every replica that touches it — the join key
    `merge_traces` timelines group on. Monotonic within a process;
    the pid component keeps multi-process fleets collision-free."""
    return f"{prefix}{os.getpid():x}-{next(_TRACE_SEQ):x}"


def merge_traces(
    tracers: Sequence[Tracer],
    labels: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Fold N tracers into ONE Chrome trace-event body: tracer ``i``
    becomes process ``pid=i+1`` (named ``labels[i]``, default
    ``tracer<i>``), its tracks keep their per-process thread ids
    (namespaced by the pid — Perfetto scopes tids per process), and
    every timestamp is renormalized onto a single clock zero (the
    earliest tracer's creation time; all tracers read the same
    ``time.perf_counter``, so absolute event times are directly
    comparable). A request that hopped replicas renders as one
    left-to-right causal lifeline: ``dispatch`` on the router process,
    ``resume``/spans on each replica process it visited, exactly one
    ``finish`` — grouped by the ``trace_id`` event arg.

    Returns the loadable JSON body (``traceEvents`` +
    ``displayTimeUnit`` + ``otherData``); `export_merged_trace`
    writes it to disk."""
    tracers = list(tracers)
    if not tracers:
        raise ValueError("merge_traces needs at least one tracer")
    if labels is None:
        labels = [f"tracer{i}" for i in range(len(tracers))]
    labels = [str(x) for x in labels]
    if len(labels) != len(tracers):
        raise ValueError(
            f"{len(labels)} labels for {len(tracers)} tracers"
        )
    t0 = min(tr._t0 for tr in tracers)
    events: List[Dict[str, Any]] = []
    dropped = 0
    for i, (tr, label) in enumerate(zip(tracers, labels)):
        pid = i + 1
        with tr._lock:
            snap = list(tr._events)
            tracks = dict(tr._tracks)
        dropped += tr._dropped
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": pid,
            "tid": 0, "args": {"sort_index": i},
        })
        for track, tid in tracks.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid, "args": {"name": track},
            })
            events.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid,
                "tid": tid, "args": {"sort_index": tid},
            })
        for ph, name, tid, ts, dur, args in snap:
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "pid": pid, "tid": tid,
                "ts": round((ts - t0) * 1e6, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
    other: Dict[str, Any] = {
        "producer": "rocm_apex_tpu_torch.monitor.trace.merge_traces",
        "processes": {
            str(i + 1): label for i, label in enumerate(labels)
        },
        "dropped_events": dropped,
    }
    if dropped:
        other["warning"] = (
            f"{dropped} events dropped by ring-buffer wrap across the "
            f"merged tracers; some lifelines are incomplete"
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def export_merged_trace(
    path: str,
    tracers: Sequence[Tracer],
    labels: Optional[Sequence[str]] = None,
) -> int:
    """`merge_traces` to disk (Perfetto-loadable); returns the event
    count, metadata included."""
    body = merge_traces(tracers, labels)
    with open(path, "w") as f:
        json.dump(body, f)
    return len(body["traceEvents"])


def trace_lifelines(
    body: Dict[str, Any],
) -> Dict[str, Dict[str, Any]]:
    """Group a merged (or single-tracer) trace body by ``trace_id``:
    ``{trace_id: {"pids": sorted pids touched, "events": count,
    "finishes": count of finish events, "names": sorted event
    names}}``. The exactly-once acceptance reads directly off it —
    every lifeline must show ``finishes == 1``, and a migrated
    request's ``pids`` spans more than one process."""
    lifelines: Dict[str, Dict[str, Any]] = {}
    for ev in body.get("traceEvents", ()):
        tid_ = (ev.get("args") or {}).get("trace_id")
        if not tid_:
            continue
        line = lifelines.setdefault(
            tid_, {"pids": set(), "events": 0, "finishes": 0,
                   "names": set()},
        )
        line["pids"].add(ev.get("pid", 1))
        line["events"] += 1
        line["names"].add(ev["name"])
        if ev["name"] == "finish":
            line["finishes"] += 1
    for line in lifelines.values():
        line["pids"] = sorted(line["pids"])
        line["names"] = sorted(line["names"])
    return lifelines
