"""The monitor layer's ported pieces: the mergeable metric registry
(`telemetry`) the `ReplicaRouter` keeps its fleet series in, and the
trace ids (`trace.mint_trace_id`) requests carry across replicas. The
rest (tracer, flight recorder, SLOs, exporter, time series) waits for
ROADMAP Queue 1 item 9."""

from rocm_apex_tpu_torch.monitor.telemetry import (  # noqa: F401
    NULL_REGISTRY,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    log_buckets,
)
from rocm_apex_tpu_torch.monitor.trace import mint_trace_id  # noqa: F401

__all__ = [
    "CardinalityError",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "NULL_REGISTRY",
    "log_buckets",
    "mint_trace_id",
]
