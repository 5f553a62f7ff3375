"""Unified run telemetry (counterpart of ``mxnet_tpu/telemetry``).

Public surface:

* :func:`current` — the active :class:`RunLog` or None (``MXNET_RUNLOG``
  env arms it; the unset fast path is two dict lookups).
* :func:`reset` / :func:`close` — (re)arm at a precise program point.
* no-op-safe wire points every subsystem calls: :func:`compile_event`,
  :func:`event`, :func:`count`, :func:`checkpoint_event`,
  :func:`program_report`, :func:`flight_dump`.
* :func:`describe_program` — memory and FLOP introspection of one call
  of a step.
* :func:`fit_session` — the per-``Module.fit`` session wrapper.
* :mod:`.tracing` — W3C-style distributed trace context + span
  emission, merged across processes by ``tools/tracemerge.py``.
* :mod:`.schema` — the JSONL record contract tests and CI validate.

Env knobs (registered in :mod:`mxnet_tpu_torch.config`):
``MXNET_RUNLOG``, ``MXNET_TELEMETRY_SAMPLE``, ``MXNET_FLIGHTREC_DEPTH``,
``MXNET_METRICS_TEXTFILE``, ``MXNET_TRACE_CONTEXT``,
``MXNET_PROCESS_ROLE``, ``MXNET_PROCESS_RANK``.
"""
from . import numerics, opstats, schema, tracing  # noqa: F401
from .runlog import (  # noqa: F401
    RunLog,
    checkpoint_event,
    close,
    compile_event,
    compile_fingerprint,
    count,
    current,
    data_plane,
    describe_call,
    describe_program,
    event,
    find_flight_dumps,
    flight_dump,
    flight_path_for,
    freshness,
    gauge,
    generate,
    heal,
    program_report,
    quantize,
    reset,
)
from .session import FitSession, fit_session  # noqa: F401
from .tracing import TraceContext  # noqa: F401
from .watchdog import (  # noqa: F401
    Watchdog,
    find_stack_dumps,
    stack_path_for,
)

__all__ = [
    "RunLog", "current", "reset", "close", "compile_event",
    "compile_fingerprint", "event", "count", "gauge", "generate",
    "heal", "freshness",
    "data_plane", "quantize", "checkpoint_event", "program_report",
    "flight_dump",
    "flight_path_for", "find_flight_dumps", "describe_program",
    "describe_call",
    "FitSession",
    "fit_session", "schema", "Watchdog", "stack_path_for",
    "find_stack_dumps", "tracing", "TraceContext",
    "numerics", "opstats",
]
