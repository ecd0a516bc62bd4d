"""Mergeable constant-memory metric registry: Counter/Gauge/Histogram.

Port of ``rocm_apex_tpu/monitor/telemetry.py``, host-only Python kept as
the port's own copy (the JAX module imports nothing of JAX either, and
this one is the same code): the registry the serving engine keeps its
``serve_*`` series in and the `ReplicaRouter` its fleet counters, gauges
and labeled histograms, which the exporter, the SLOs and the time series
read.

* **Constant memory**: a `Histogram` is one integer per bucket plus a
  running sum/count, its bounds fixed at construction (log-spaced by
  default, `log_buckets`).
* **Exact merge**: two snapshots of the same histogram merge by
  bucket-wise ADD (`merge_from`); the merged histogram is the histogram
  of the concatenated stream.
* **Bounded-error quantiles**: `Histogram.quantile(q)` interpolates
  inside the bucket holding rank ``q*count``; the relative error is at
  most ``g**2 - 1`` for adjacent-bound ratio ``g`` (`error_bound`).
* **Labels**: families fan out into series keyed by label values; a
  cardinality guard (`MetricRegistry(max_label_sets=...)`) raises
  `CardinalityError` before an unbounded label can leak memory.
* **Zero overhead when disabled**: `MetricRegistry(enabled=False)`
  (`NULL_REGISTRY`) hands out shared no-op metrics.

`exposition()` renders the Prometheus text format (version 0.0.4);
`snapshot()` is a JSON-ready dump.
"""


import bisect
import math
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "CardinalityError",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_REGISTRY",
    "NULL_REGISTRY",
    "log_buckets",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# 20 buckets per decade -> adjacent-bound ratio g = 10**(1/20) ~ 1.122
DEFAULT_PER_DECADE = 20


class CardinalityError(ValueError):
    """A metric family tried to grow past ``max_label_sets`` distinct
    label combinations — the guard against unbounded labels (request
    ids, raw user strings) silently re-creating the per-request-list
    memory leak this module exists to remove."""


def log_buckets(
    lo: float = 1e-3, hi: float = 1e7,
    per_decade: int = DEFAULT_PER_DECADE,
) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering ``[lo, hi]`` with
    ``per_decade`` buckets per factor of 10 (adjacent-bound ratio
    ``g = 10**(1/per_decade)``). The default spans ten decades in 200
    buckets — microseconds to hours when the unit is milliseconds —
    so one layout serves queue waits, TTFTs, and end-to-end times and
    they all merge."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    g = 10.0 ** (1.0 / per_decade)
    return tuple(lo * g ** i for i in range(n + 1))


def _fmt(v: float) -> str:
    """Prometheus float rendering: integers without a trailing .0 is
    fine either way; use repr-quality shortest form."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: str = "") -> str:
    parts = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# ---------------------------------------------------------------------
# disabled path: shared no-op singletons (the NULL_TRACER idiom)
# ---------------------------------------------------------------------


class _NullMetric:
    """Shared no-op metric for disabled registries: every mutator
    returns immediately, ``labels()`` returns the same instance, and
    readers report empty/zero state."""

    __slots__ = ()
    enabled = False

    def labels(self, **kw):
        return self

    def clear(self) -> None:
        return None

    def inc(self, amount: float = 1.0, **labels) -> None:
        return None

    def dec(self, amount: float = 1.0, **labels) -> None:
        return None

    def set(self, value: float, **labels) -> None:
        return None

    def observe(self, value: float, **labels) -> None:
        return None

    def value(self, **labels) -> float:
        return 0.0

    def count(self, **labels) -> float:
        return 0.0

    def total(self) -> float:
        return 0.0

    def quantile(self, q: float, **labels) -> float:
        return 0.0

    def good_below(self, bound: float, **labels) -> float:
        return 0.0


_NULL_METRIC = _NullMetric()


# ---------------------------------------------------------------------
# live metric families
# ---------------------------------------------------------------------


class _Family:
    """Base: a named metric family fanning out into label series.

    Series are keyed by the tuple of label VALUES in ``labelnames``
    order. An unlabelled family has exactly one series under the empty
    tuple. All mutation happens under the owning registry's lock (the
    exporter scrapes from its own thread)."""

    kind = "untyped"
    enabled = True

    def __init__(self, registry: "MetricRegistry", name: str,
                 help: str, labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = registry._lock
        self._series: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            self._series[()] = self._new_series()

    # -- series resolution ---------------------------------------------

    def _new_series(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _series_locked(self, key: Tuple[str, ...]):
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self._registry.max_label_sets:
                raise CardinalityError(
                    f"{self.name}: more than "
                    f"{self._registry.max_label_sets} label sets "
                    f"(labelnames={self.labelnames}; is a label "
                    f"unbounded?)"
                )
            s = self._new_series()
            self._series[key] = s
        return s

    def labels(self, **labels) -> "_Bound":
        """Resolve one label combination to a bound handle (cached by
        the caller for hot paths — one dict lookup saved per call)."""
        key = self._key(labels)
        with self._lock:
            self._series_locked(key)
        return _Bound(self, key)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            if not self.labelnames:
                self._series[()] = self._new_series()

    # -- iteration (for exposition / snapshot / merge) ------------------

    def _items_locked(self) -> List[Tuple[Tuple[str, ...], Any]]:
        return sorted(self._series.items())


class _Bound:
    """A family pinned to one resolved label-value tuple; forwards the
    mutators without re-resolving labels."""

    __slots__ = ("_family", "_key")
    enabled = True

    def __init__(self, family: _Family, key: Tuple[str, ...]):
        self._family = family
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._family._inc_key(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._family._inc_key(self._key, -amount)

    def set(self, value: float) -> None:
        self._family._set_key(self._key, value)

    def observe(self, value: float) -> None:
        self._family._observe_key(self._key, value)


class Counter(_Family):
    """Monotonically increasing float (resets only via
    `MetricRegistry.reset`). Merging adds values series-wise."""

    kind = "counter"

    def _new_series(self) -> List[float]:
        return [0.0]

    def _inc_key(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(
                f"{self.name}: counters only go up (inc {amount})"
            )
        with self._lock:
            self._series_locked(key)[0] += amount

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._inc_key(self._key(labels), amount)

    def value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s[0] if s else 0.0

    def total(self) -> float:
        """Sum across all label series."""
        with self._lock:
            return sum(s[0] for s in self._series.values())


class Gauge(_Family):
    """Last-written float; can go up and down. Merging takes the
    incoming value (last-writer-wins across replicas — use counters or
    histograms for anything that must aggregate)."""

    kind = "gauge"

    def _new_series(self) -> List[float]:
        return [0.0]

    def _set_key(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._series_locked(key)[0] = float(value)

    def _inc_key(self, key: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._series_locked(key)[0] += amount

    def set(self, value: float, **labels) -> None:
        self._set_key(self._key(labels), value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._inc_key(self._key(labels), amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self._inc_key(self._key(labels), -amount)

    def value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s[0] if s else 0.0


class _HistSeries:
    """One histogram series: per-bucket counts + running sum/count.
    ``counts[i]`` holds observations in ``(bounds[i-1], bounds[i]]``
    (``(0, bounds[0]]`` for i=0); ``counts[-1]`` is the +Inf overflow
    bucket."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bucket histogram: constant memory, exact bucket-wise
    merge, quantile estimates with a documented error bound (module
    docstring; `error_bound`). Default buckets are `log_buckets()` —
    pass ``buckets=`` to override (must match to merge)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Optional[Sequence[float]] = None):
        b = tuple(float(x) for x in (
            buckets if buckets is not None else log_buckets()
        ))
        if len(b) < 1 or any(
            b[i] >= b[i + 1] for i in range(len(b) - 1)
        ) or b[0] <= 0:
            raise ValueError(
                f"{name}: buckets must be positive and strictly "
                f"increasing, got {b[:4]}..."
            )
        self.bounds = b
        super().__init__(registry, name, help, labelnames)

    def _new_series(self) -> _HistSeries:
        return _HistSeries(len(self.bounds) + 1)

    @property
    def error_bound(self) -> float:
        """Worst-case RELATIVE quantile error for in-range values:
        ``g**2 - 1`` where ``g`` is the largest adjacent-bound ratio
        (estimate and true order statistic land in the same or an
        adjacent bucket)."""
        g = max(
            self.bounds[i + 1] / self.bounds[i]
            for i in range(len(self.bounds) - 1)
        ) if len(self.bounds) > 1 else 2.0
        return g * g - 1.0

    def _bucket_index(self, value: float) -> int:
        # first bound >= value (len(bounds) = the +Inf overflow slot)
        return bisect.bisect_left(self.bounds, value)

    def _observe_key(self, key: Tuple[str, ...], value: float) -> None:
        v = float(value)
        i = self._bucket_index(v)
        with self._lock:
            s = self._series_locked(key)
            s.counts[i] += 1
            s.sum += v
            s.count += 1

    def observe(self, value: float, **labels) -> None:
        self._observe_key(self._key(labels), value)

    # -- reads ----------------------------------------------------------

    def _agg_locked(self, labels: Optional[Dict[str, Any]]):
        """Aggregate counts across series (or one series if labels
        given) — merging label series is the same bucket-wise add as
        merging replicas."""
        if labels:
            s = self._series.get(self._key(labels))
            if s is None:
                return [0] * (len(self.bounds) + 1), 0.0, 0
            return list(s.counts), s.sum, s.count
        counts = [0] * (len(self.bounds) + 1)
        total_sum, total_n = 0.0, 0
        for s in self._series.values():
            for i, c in enumerate(s.counts):
                counts[i] += c
            total_sum += s.sum
            total_n += s.count
        return counts, total_sum, total_n

    def count(self, **labels) -> float:
        with self._lock:
            return float(self._agg_locked(labels or None)[2])

    def total(self) -> float:
        return self.count()

    def sum(self, **labels) -> float:
        with self._lock:
            return float(self._agg_locked(labels or None)[1])

    def good_below(self, bound: float, **labels) -> float:
        """Observations ``<= bound`` (rounded UP to the nearest bucket
        bound — the latency-SLO 'good event' count; document the
        effective threshold as ``bounds[bisect(bound)]``)."""
        i = self._bucket_index(bound)
        with self._lock:
            counts, _, _ = self._agg_locked(labels or None)
        return float(sum(counts[: i + 1]))

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile (``0 <= q <= 1``) by linear
        interpolation inside the bucket holding rank ``q*count``.
        Relative error is bounded by `error_bound` for in-range
        values; 0.0 on an empty series; values past the last bound
        clamp to it."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            counts, _, n = self._agg_locked(labels or None)
        if n == 0:
            return 0.0
        target = q * n
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(self.bounds):
                    return self.bounds[-1]  # overflow: clamp
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - cum) / c if c else 0.0
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def percentile(self, p: float, **labels) -> float:
        """`quantile` with ``p`` in [0, 100] (np.percentile calling
        convention)."""
        return self.quantile(p / 100.0, **labels)


# ---------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------


class MetricRegistry:
    """Process- or component-scoped collection of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create by name
    (re-requesting an existing family returns it; a kind or labelname
    mismatch raises). A DISABLED registry (``enabled=False``, shared
    singleton `NULL_REGISTRY`) hands out one shared no-op metric —
    call sites hold metrics unconditionally and the disabled path
    allocates nothing.

    ``max_label_sets`` caps distinct label combinations per family
    (`CardinalityError` past it) so labels stay bounded and the whole
    registry stays O(metrics), not O(traffic).
    """

    def __init__(self, enabled: bool = True, max_label_sets: int = 64):
        if max_label_sets < 1:
            raise ValueError(
                f"max_label_sets must be >= 1, got {max_label_sets}"
            )
        self.enabled = bool(enabled)
        self.max_label_sets = int(max_label_sets)
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # -- factories ------------------------------------------------------

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        if not self.enabled:
            return _NULL_METRIC
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"{name} already registered as {fam.kind}"
                    )
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"{name}: labelnames {tuple(labelnames)} != "
                        f"registered {fam.labelnames}"
                    )
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self) -> None:
        """Zero every series in place (families and label sets
        survive — the engine's `reset_stats` contract: benchmarks
        warm up, reset, then measure a clean window)."""
        with self._lock:
            for fam in self._families.values():
                fam.clear()

    # -- merge ----------------------------------------------------------

    def merge_from(self, other: "MetricRegistry") -> None:
        """Fold ``other``'s series into this registry: counters and
        histograms ADD (bucket-wise — the merged histogram IS the
        histogram of the combined stream), gauges take the incoming
        value. Families missing here are created with ``other``'s
        layout. Histogram bucket layouts must match exactly."""
        if not (self.enabled and other.enabled):
            return
        with other._lock:
            fams = list(other._families.values())
        for of in fams:
            if isinstance(of, Histogram):
                mine = self.histogram(
                    of.name, of.help, of.labelnames, buckets=of.bounds
                )
                if mine.bounds != of.bounds:
                    raise ValueError(
                        f"{of.name}: bucket layouts differ; merge "
                        f"requires identical bounds"
                    )
            elif isinstance(of, Counter):
                mine = self.counter(of.name, of.help, of.labelnames)
            elif isinstance(of, Gauge):
                mine = self.gauge(of.name, of.help, of.labelnames)
            else:  # pragma: no cover - no other kinds exist
                continue
            with other._lock:
                items = of._items_locked()
            with self._lock:
                for key, series in items:
                    dst = mine._series_locked(key)
                    if isinstance(of, Histogram):
                        for i, c in enumerate(series.counts):
                            dst.counts[i] += c
                        dst.sum += series.sum
                        dst.count += series.count
                    elif isinstance(of, Counter):
                        dst[0] += series[0]
                    else:
                        dst[0] = series[0]

    # -- export ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump (the ``/varz`` body): one entry per family
        with kind, help, and every label series' state."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            with self._lock:
                items = fam._items_locked()
            series = []
            for key, s in items:
                labels = dict(zip(fam.labelnames, key))
                if isinstance(fam, Histogram):
                    series.append({
                        "labels": labels,
                        "buckets": list(s.counts),
                        "sum": s.sum,
                        "count": s.count,
                    })
                else:
                    series.append({"labels": labels, "value": s[0]})
            entry: Dict[str, Any] = {
                "type": fam.kind, "help": fam.help, "series": series,
            }
            if isinstance(fam, Histogram):
                entry["bounds"] = list(fam.bounds)
            out[fam.name] = entry
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (format version 0.0.4): the
        ``/metrics`` body. Histograms render cumulative ``_bucket``
        series with ``le`` bounds plus ``_sum``/``_count``."""
        lines: List[str] = []
        for fam in self.families():
            with self._lock:
                items = fam._items_locked()
            if fam.help:
                help_text = fam.help.replace("\\", r"\\")
                help_text = help_text.replace("\n", r"\n")
                lines.append(f"# HELP {fam.name} {help_text}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, s in items:
                if isinstance(fam, Histogram):
                    cum = 0
                    for i, bound in enumerate(fam.bounds):
                        cum += s.counts[i]
                        lab = _render_labels(
                            fam.labelnames, key,
                            extra=f'le="{_fmt(bound)}"',
                        )
                        lines.append(
                            f"{fam.name}_bucket{lab} {cum}"
                        )
                    cum += s.counts[-1]
                    lab = _render_labels(
                        fam.labelnames, key, extra='le="+Inf"'
                    )
                    lines.append(f"{fam.name}_bucket{lab} {cum}")
                    plain = _render_labels(fam.labelnames, key)
                    lines.append(f"{fam.name}_sum{plain} {_fmt(s.sum)}")
                    lines.append(f"{fam.name}_count{plain} {cum}")
                else:
                    lab = _render_labels(fam.labelnames, key)
                    lines.append(f"{fam.name}{lab} {_fmt(s[0])}")
        return "\n".join(lines) + ("\n" if lines else "")


# The process-wide default (training examples and ad-hoc tooling log
# here when not handed a scoped registry) and the free disabled
# singleton — hold either unconditionally, pay one `enabled` check.
DEFAULT_REGISTRY = MetricRegistry()
NULL_REGISTRY = MetricRegistry(enabled=False)
