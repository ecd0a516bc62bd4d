"""`rocm_apex_tpu_torch.monitor`: the host side of the serving and
training observability layer, ported from ``rocm_apex_tpu/monitor``.

* **telemetry** (`telemetry.py`): the mergeable constant-memory metric
  registry (`Counter`/`Gauge`/`Histogram` with log-spaced buckets),
  `NULL_REGISTRY` for the free disabled path;
* **span tracer** (`trace.py`): wall-clock spans in a thread-safe ring,
  exported as Perfetto-loadable Chrome trace JSON, live spans annotated
  for `torch.profiler`; fleet-causal trace ids (`mint_trace_id`), one
  merged body for a router and its replicas (`merge_traces`), and the
  exactly-once check (`trace_lifelines`);
* **time series** (`timeseries.py`): a fixed-memory ring of registry
  snapshots answering windowed rate/delta/quantile queries;
* **flight recorder** (`recorder.py`): last-k snapshots and a jsonl
  dump on a non-finite anomaly; `group_nonfinite` probes a tensor tree
  by group without reading it back;
* **host pipeline** (`logger.py`): `MetricsLogger` with windowed
  aggregation and writers, `device_memory_stats` over the CUDA caching
  allocator; **flops** (`flops.py`): model FLOPs and MFU;
* **SLOs** (`slo.py`) with multi-window burn-rate alerts, and the
  stdlib HTTP **exporter** (`exporter.py`): ``/metrics``, ``/healthz``,
  ``/varz``, ``/timeseries``.

The serving engine keeps a private enabled registry by default and
takes ``tracer=``, ``flight_recorder=`` and ``timeseries=``; the
`ReplicaRouter` takes ``tracer=`` and ``timeseries=`` and serves
`merged_registry`/`merged_trace`. The in-graph metrics, the program
auditor and linter, the profiler layer and the retrace sentinel wait
for ROADMAP Queue 1 item 9b.
"""

from rocm_apex_tpu_torch.monitor.exporter import (  # noqa: F401
    TelemetryServer,
    engine_health,
    fleet_health,
    start_exporter,
)
from rocm_apex_tpu_torch.monitor.flops import (  # noqa: F401
    mfu,
    model_flops,
    peak_flops_per_chip,
    resnet50_train_flops,
    transformer_train_flops,
)
from rocm_apex_tpu_torch.monitor.logger import (  # noqa: F401
    JsonlWriter,
    MetricsLogger,
    RegistryWriter,
    TensorBoardWriter,
    device_memory_stats,
)
from rocm_apex_tpu_torch.monitor.recorder import (  # noqa: F401
    FlightRecorder,
    group_nonfinite,
)
from rocm_apex_tpu_torch.monitor.slo import (  # noqa: F401
    DEFAULT_BURN_RULES,
    SLO,
    BurnRule,
    SLOMonitor,
    TenantSLOBoard,
)
from rocm_apex_tpu_torch.monitor.telemetry import (  # noqa: F401
    DEFAULT_REGISTRY,
    NULL_REGISTRY,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    log_buckets,
)
from rocm_apex_tpu_torch.monitor.timeseries import (  # noqa: F401
    TimeSeriesStore,
)
from rocm_apex_tpu_torch.monitor.trace import (  # noqa: F401
    NULL_TRACER,
    Tracer,
    export_merged_trace,
    merge_traces,
    mint_trace_id,
    trace_lifelines,
)

__all__ = [
    "MetricsLogger",
    "JsonlWriter",
    "TensorBoardWriter",
    "device_memory_stats",
    "model_flops",
    "transformer_train_flops",
    "resnet50_train_flops",
    "peak_flops_per_chip",
    "mfu",
    "Tracer",
    "NULL_TRACER",
    "mint_trace_id",
    "merge_traces",
    "export_merged_trace",
    "trace_lifelines",
    "TimeSeriesStore",
    "FlightRecorder",
    "group_nonfinite",
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "CardinalityError",
    "log_buckets",
    "DEFAULT_REGISTRY",
    "NULL_REGISTRY",
    "RegistryWriter",
    "SLO",
    "SLOMonitor",
    "TenantSLOBoard",
    "BurnRule",
    "DEFAULT_BURN_RULES",
    "TelemetryServer",
    "engine_health",
    "fleet_health",
    "start_exporter",
]
