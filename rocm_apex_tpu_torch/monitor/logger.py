"""Host-side metrics pipeline: windowed aggregation and pluggable writers.

Port of ``rocm_apex_tpu/monitor/logger.py``. One `MetricsLogger` owns:

* **step timing**: ``end_step(sync_on=)`` waits for an explicit CUDA
  event or stream (``.synchronize()``; a card tensor records an event on
  the current stream and waits for it) before it reads the clock, never
  for the whole device;
* **windowed aggregation**: scalars accumulate for ``window`` steps and
  flush as means (the names in ``last_value`` flush as their last value),
  so values are read and written once per window;
* **derived throughput**: tokens/s from ``tokens_per_step`` and MFU from
  ``flops_per_step`` (`monitor.model_flops`) over ``n_chips`` cards'
  peak (`monitor.peak_flops_per_chip`);
* **device-memory stats** (`device_memory_stats`): the CUDA caching
  allocator's bytes in use and peak;
* **pluggable writers**: anything with ``write(step, scalars)``.
  `JsonlWriter` emits one JSON object per line; `TensorBoardWriter`
  adapts any ``add_scalar(tag, value, step)`` object the caller passes
  (no TensorBoard import here); `RegistryWriter` mirrors every flushed
  scalar into a `monitor.telemetry.MetricRegistry` (gauges, plus a
  step-time histogram), so a training run joins the ``/metrics`` plane.
"""

import json
import sys
import time
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

from rocm_apex_tpu_torch.monitor.flops import mfu as _mfu
from rocm_apex_tpu_torch.monitor.flops import peak_flops_per_chip

__all__ = [
    "JsonlWriter",
    "TensorBoardWriter",
    "RegistryWriter",
    "MetricsLogger",
    "device_memory_stats",
]


def device_memory_stats(device=None) -> Dict[str, float]:
    """{'platform': ..., 'mem_bytes_in_use': ...,
    'mem_peak_bytes_in_use': ...} for one device (default: the current
    CUDA device when there is one, else the CPU).

    A CUDA device reads its caching allocator (`torch.cuda.memory_stats`:
    ``allocated_bytes.all.current`` and ``.peak``; host bookkeeping, no
    sync). The CPU has no allocator stats and gets zeroed fields with
    ``platform: "cpu"``, so a jsonl stream keeps one schema everywhere."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    out: Dict[str, float] = {
        "platform": device.type,
        "mem_bytes_in_use": 0.0,
        "mem_peak_bytes_in_use": 0.0,
    }
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out["mem_bytes_in_use"] = float(
            stats.get("allocated_bytes.all.current", 0))
        out["mem_peak_bytes_in_use"] = float(
            stats.get("allocated_bytes.all.peak", 0))
    return out


def _wait(sync_on) -> None:
    """Wait for an explicit CUDA event or stream; a card tensor waits for
    the work queued so far on the current stream through an event."""
    if isinstance(sync_on, torch.Tensor):
        if not sync_on.is_cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        sync_on = ev
    sync_on.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0

    def start(self):
        assert not self.started_, f"timer {self.name} already started"
        self.started_ = True
        self.start_time = time.perf_counter()

    def stop(self, sync_on=None):
        assert self.started_, f"timer {self.name} is not started"
        if sync_on is not None:
            _wait(sync_on)
        self.elapsed_ += time.perf_counter() - self.start_time
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        out = self.elapsed_
        if reset:
            self.elapsed_ = 0.0
        return out


class _Timers:
    """Named `_Timer`s (the protocol ``MetricsLogger(timers=)`` takes:
    ``timers(name)`` returns a timer with ``start``, ``stop(sync_on=)``
    and ``elapsed(reset=)``)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]


class JsonlWriter:
    """One JSON object per line, keys in insertion order: `emit` takes a
    whole record, the logger's windowed flushes route through `write`,
    and ``add_scalar`` takes one timer-style scalar."""

    def __init__(self, stream=None, path: Optional[str] = None):
        if (stream is None) == (path is None):
            raise ValueError("pass exactly one of stream or path")
        self._own = path is not None
        self._stream = open(path, "a") if path else stream

    def emit(self, record: Dict[str, Any]) -> None:
        print(json.dumps(record), file=self._stream, flush=True)

    def write(self, step: int, scalars: Dict[str, Any]) -> None:
        self.emit({"step": int(step), **scalars})

    def add_scalar(self, tag: str, value, step: int) -> None:
        """Single-scalar entry point."""
        self.emit({"step": int(step), tag: float(value)})

    def close(self) -> None:
        if self._own:
            self._stream.close()


class TensorBoardWriter:
    """Adapter from the writer protocol to any object exposing
    ``add_scalar(tag, value, step)`` that the caller passes in
    (``torch.utils.tensorboard.SummaryWriter``, or `JsonlWriter` itself;
    nothing of TensorBoard is imported here)."""

    def __init__(self, summary_writer):
        self._w = summary_writer

    def write(self, step: int, scalars: Dict[str, Any]) -> None:
        for tag, value in scalars.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue  # non-scalar entries (e.g. 'platform') skip
            self._w.add_scalar(tag, value, int(step))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._w.add_scalar(tag, float(value), int(step))


class RegistryWriter:
    """Writer-protocol sink into a `monitor.telemetry.MetricRegistry`.

    Every flushed scalar becomes a gauge named
    ``{prefix}{sanitized_name}`` (non-numeric entries like
    ``platform`` skip), the flush step lands in ``{prefix}step``, and
    ``step_time_ms`` is ADDITIONALLY observed into a
    ``{prefix}step_ms`` histogram — the mergeable series a step-time
    latency `monitor.slo.SLO` reads. Attach next to a `JsonlWriter`
    and the same window flush feeds stdout AND the ``/metrics``
    exporter (`monitor.exporter.TelemetryServer`)."""

    _SANITIZE = None  # compiled lazily (module import stays cheap)

    def __init__(self, registry, prefix: str = "train_"):
        import re

        if RegistryWriter._SANITIZE is None:
            RegistryWriter._SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
        self._registry = registry
        self._prefix = prefix
        self._step_gauge = registry.gauge(
            prefix + "step", "Latest flushed step index."
        )
        self._step_hist = registry.histogram(
            prefix + "step_ms", "Step wall time, ms."
        )

    def _name(self, tag: str) -> str:
        return self._prefix + RegistryWriter._SANITIZE.sub("_", tag)

    def write(self, step: int, scalars: Dict[str, Any]) -> None:
        self._step_gauge.set(int(step))
        for tag, value in scalars.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue  # non-scalar entries (e.g. 'platform') skip
            self._registry.gauge(self._name(tag)).set(value)
            if tag == "step_time_ms":
                self._step_hist.observe(value)

    def add_scalar(self, tag: str, value, step: int) -> None:
        """Single-scalar entry point."""
        self.write(step, {tag: value})

    def close(self) -> None:
        pass


class MetricsLogger:
    """Windowed host-side aggregator over per-step scalar dicts.

    Typical wiring::

        logger = MetricsLogger(
            writers=[JsonlWriter(stream=sys.stdout)],
            window=args.log_interval,
            tokens_per_step=global_batch * seq,
            flops_per_step=model_flops(cfg, global_batch, seq,
                                       raw_param_count=n),
            n_chips=tp * dp,
        )
        for it in range(iters):
            logger.start_step()
            state, sstate, metrics = step_f(state, sstate, batch)
            logger.end_step(sync_on=loss)   # a card tensor or an event
            logger.log_step(it, metrics)   # flushes every `window`

    ``log_step`` accepts a `Metrics`, a name→scalar dict, or anything
    with ``as_dict()`` (each value is read with ``float`` as it is
    logged). Names listed in ``last_value`` flush as their last
    value instead of the window mean (monotonic counters: the scaler's
    ``overflows``, the engine's admit/evict totals).
    """

    def __init__(
        self,
        writers: Sequence[Any] = (),
        *,
        window: int = 1,
        tokens_per_step: Optional[float] = None,
        flops_per_step: Optional[float] = None,
        n_chips: int = 1,
        peak_flops: Optional[float] = None,
        last_value: Iterable[str] = (
            # the scaler's monotonic overflow counter, plus the
            # serving engine's monotonic counters (`InferenceEngine.
            # stats()`): all flush as last value, never a window mean
            "overflows",
            "admitted", "evicted", "prompt_tokens",
            "generated_tokens", "decode_steps", "mixed_steps",
            # the paged cache's monotonic counters (CoW forks, prefix
            # admissions/tokens, pool-backpressure stalls, deadlock
            # preemptions)
            "cow_forks", "prefix_hits", "prefix_hit_tokens",
            "page_stalls", "preemptions",
            # speculative-decoding counters: drafted/accepted totals
            # flush as last value; acceptance_rate is their running
            # ratio and follows them
            "tokens_drafted", "tokens_accepted", "acceptance_rate",
            "rollbacks",
        ),
        timers=None,
        memory_stats: bool = True,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.writers = list(writers) or [JsonlWriter(stream=sys.stdout)]
        self.window = window
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.n_chips = n_chips
        self._peak = peak_flops
        self._last_value = set(last_value)
        self.timers = timers if timers is not None else _Timers()
        self._memory_stats = memory_stats
        self._acc: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        self._count = 0
        self._step_seconds = 0.0
        self._timed_steps = 0
        self._last_step = 0

    # -- step timing ---------------------------------------------------

    def start_step(self) -> None:
        self.timers("step").start()

    def end_step(self, sync_on=None) -> None:
        """Stop the step timer; ``sync_on`` (a CUDA event or stream, or a
        card tensor) is waited for first."""
        t = self.timers("step")
        t.stop(sync_on=sync_on)
        self._step_seconds += t.elapsed(reset=True)
        self._timed_steps += 1

    # -- logging --------------------------------------------------------

    def log_step(self, step: int, scalars, **extra) -> Optional[Dict]:
        """Accumulate one step's scalars; flush when the window fills.
        Returns the flushed record (also handed to every writer) or
        None mid-window."""
        if hasattr(scalars, "as_dict"):
            scalars = scalars.as_dict()
        scalars = {**scalars, **extra}
        self._last_step = int(step)
        for name, value in scalars.items():
            value = float(value)
            self._last[name] = value
            self._acc[name] = self._acc.get(name, 0.0) + value
        self._count += 1
        if self._count < self.window:
            return None
        return self.flush(step)

    def flush(self, step: int) -> Optional[Dict]:
        """Aggregate the open window and write it out."""
        if self._count == 0:
            return None
        record: Dict[str, float] = {}
        for name in self._acc:
            record[name] = (
                self._last[name]
                if name.split("/")[-1] in self._last_value
                else self._acc[name] / self._count
            )
        if self._timed_steps:
            dt = self._step_seconds / self._timed_steps
            record["step_time_ms"] = dt * 1000.0
            if self.tokens_per_step:
                record["tokens_per_sec"] = self.tokens_per_step / dt
            if self.flops_per_step:
                if self._peak is None:
                    self._peak = peak_flops_per_chip()
                record["mfu"] = _mfu(
                    self.flops_per_step, dt,
                    n_chips=self.n_chips, peak=self._peak,
                )
        if self._memory_stats:
            record.update(device_memory_stats())
        for w in self.writers:
            w.write(step, record)
        self._acc.clear()
        self._last.clear()
        self._count = 0
        self._step_seconds = 0.0
        self._timed_steps = 0
        return record

    # -- lifecycle ------------------------------------------------------

    def close(self) -> Optional[Dict]:
        """Flush the trailing PARTIAL window (a run whose length is not
        a multiple of ``window`` would silently lose its last
        ``< window`` steps), then ``close()`` every writer that has
        one (`JsonlWriter` owning a file closes it). Returns the final
        flushed record, or None if the window was empty. Idempotent —
        and available as a context manager::

            with MetricsLogger(...) as logger:
                for it in range(iters):
                    ...
                    logger.log_step(it, metrics)
            # trailing steps flushed, writers closed
        """
        record = self.flush(self._last_step)
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()
        return record

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- raw passthrough -----------------------------------------------

    def emit(self, record: Dict[str, Any]) -> None:
        """Hand a fully-formed record to every writer that can take one
        verbatim (`JsonlWriter.emit`); writers without ``emit`` get it
        as step -1 scalars."""
        for w in self.writers:
            if hasattr(w, "emit"):
                w.emit(record)
            else:
                w.write(-1, {k: v for k, v in record.items()
                             if isinstance(v, (int, float))})
