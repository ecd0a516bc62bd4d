"""Fleet-causal trace ids (port of ``mint_trace_id``,
``rocm_apex_tpu/monitor/trace.py:347``). The span tracer, its merge
and the retrace sentinel wait for ROADMAP Queue 1 item 9; the engine
and the router carry a request's id across every hop already."""

import itertools
import os

__all__ = ["mint_trace_id"]

_TRACE_SEQ = itertools.count()


def mint_trace_id(prefix: str = "t") -> str:
    """One process-unique trace id: ``<prefix><pid hex>-<seq hex>``.
    The router mints one per admitted request (not per attempt), so a
    request that migrates, fails over or hands off keeps the same id on
    every replica that touches it."""
    return f"{prefix}{os.getpid():x}-{next(_TRACE_SEQ):x}"
