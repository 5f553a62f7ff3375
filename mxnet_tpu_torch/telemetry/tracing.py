"""W3C-style distributed trace context: one causal timeline per request
(counterpart of ``mxnet_tpu/telemetry/tracing.py``; the wire format is
the same, so a ``traceparent`` one package writes parses in the other).

A served request crosses processes and threads (an HTTP front, the
batcher thread, a spawned worker); each writes its own run log.  This
module is the stitch:

* :class:`TraceContext` — ``trace_id`` (32 hex) / ``span_id`` (16 hex)
  / ``parent_span_id``, carried as a W3C ``traceparent`` header
  (``00-<trace_id>-<span_id>-01``) over HTTP and as the
  ``MXNET_TRACE_CONTEXT`` env stamp into spawned subprocesses.
* a per-thread context stack (:func:`use`, :func:`current_context`)
  seeded from the env stamp, so a child's spans parent onto the hop
  that caused them.
* span emission (:func:`emit_span`, :func:`span`) into the active
  RunLog as ``span`` records, which ``tools/tracemerge.py`` merges
  across processes into one Perfetto timeline.

Zero-cost contract: with ``MXNET_RUNLOG`` unset, :func:`enabled` is the
runlog ``current()`` fast path (two dict lookups) and nothing mints
ids, touches urandom, or builds dicts.  Trace ids are only generated
when telemetry is armed or an inbound context (header / env stamp)
already exists.
"""
from __future__ import annotations

import os
import threading
import time

from . import runlog as _runlog

__all__ = [
    "TraceContext", "TRACEPARENT_HEADER", "TRACE_ENV", "ROLE_ENV",
    "RANK_ENV", "mint", "from_header", "process_context",
    "current_context", "use", "span", "emit_span", "enabled",
    "stamp_env", "new_span_id",
]

#: HTTP header name for the cross-process hop (W3C Trace Context).
TRACEPARENT_HEADER = "traceparent"
#: env stamp set by every spawner (fleet replicas, online trainer,
#: healing relaunch) so the child's root spans parent onto the spawn.
TRACE_ENV = "MXNET_TRACE_CONTEXT"
#: process identity stamps (satellite: run_start role/rank).
ROLE_ENV = "MXNET_PROCESS_ROLE"
RANK_ENV = "MXNET_PROCESS_RANK"

_VERSION = "00"
_FLAGS = "01"


class TraceContext:
    """An immutable (trace_id, span_id, parent_span_id) triple."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id, span_id, parent_span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    # -------------------------------------------------------- wire
    def to_header(self):
        """``00-<trace_id>-<span_id>-01`` — the value a router sends
        and a frontend echoes back."""
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS}"

    def child(self):
        """A new context in the same trace, parented on this span."""
        return TraceContext(self.trace_id, _gen_span_id(), self.span_id)

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"TraceContext({self.trace_id[:8]}.., span={self.span_id},"
                f" parent={self.parent_span_id})")


def _gen_trace_id():
    return os.urandom(16).hex()


def _gen_span_id():
    return os.urandom(8).hex()


#: public alias for emitters that build span records by hand (the
#: serve dispatch loop fans one request context into several child
#: spans without allocating intermediate TraceContext objects)
new_span_id = _gen_span_id


def mint():
    """A brand-new root context (fresh trace, no parent)."""
    return TraceContext(_gen_trace_id(), _gen_span_id(), None)


def from_header(value):
    """Parse a ``traceparent`` header (or the env stamp, same format).
    Returns None on anything malformed — an unparseable header must
    degrade to "untraced", never to an exception on the serve path."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 3:
        return None
    if len(parts) == 3:          # tolerate a missing flags field
        _, trace_id, span_id = parts
    else:
        trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, None)


# ------------------------------------------------------------ process root
_PROC = {"ctx": None, "resolved": False}
_PROC_LOCK = threading.Lock()


def process_context():
    """The context stamped on this process via ``MXNET_TRACE_CONTEXT``
    (parsed once), or None.  A stamped child's spans parent onto the
    spawner's span id — the cross-process link tracemerge draws."""
    if _PROC["resolved"]:
        return _PROC["ctx"]
    with _PROC_LOCK:
        if not _PROC["resolved"]:
            _PROC["ctx"] = from_header(os.environ.get(TRACE_ENV))
            _PROC["resolved"] = True
    return _PROC["ctx"]


def _reset_process_context():
    """Test hook: re-read ``MXNET_TRACE_CONTEXT`` on next use."""
    with _PROC_LOCK:
        _PROC["ctx"] = None
        _PROC["resolved"] = False


# ------------------------------------------------------------ thread stack
_TLS = threading.local()


def current_context():
    """The innermost bound context on this thread, else the process
    stamp, else None.  Never mints."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1]
    return process_context()


class use:
    """Bind ``ctx`` as the current context on this thread::

        with tracing.use(ctx):
            ...  # spans emitted here parent onto ctx
    """

    __slots__ = ("ctx",)

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        try:
            _TLS.stack.pop()
        except (AttributeError, IndexError):  # pragma: no cover
            pass
        return False


def enabled():
    """Span emission is armed iff a RunLog is — the same two-dict-
    lookup fast path as every other telemetry wrapper."""
    return _runlog.current() is not None


# ---------------------------------------------------------------- emission
def emit_span(name, t0, t1, ctx, kind="internal", parent_span_id=None,
              flush=True, **attrs):
    """Write one completed span into the active RunLog.

    ``t0``/``t1`` are ``time.perf_counter()`` readings (the runlog's
    native clock); the record stores run-relative end time + duration
    so tracemerge can reconstruct wall time via ``run_start.time``.
    ``parent_span_id`` overrides ``ctx.parent_span_id`` (e.g. chaining
    queue -> coalesce -> compute as siblings under one request span).
    No-op when telemetry is unarmed."""
    rl = _runlog.current()
    if rl is None:
        return None
    parent = ctx.parent_span_id if parent_span_id is None else parent_span_id
    rl.span(name, t0, t1, trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_span_id=parent, kind=kind, flush=flush, **attrs)
    return ctx


class span:
    """Context manager: time a block and emit it as a child span of the
    current context.  When telemetry is unarmed this binds nothing and
    emits nothing (one ``current()`` check on enter)::

        with tracing.span("export", model_version=3) as ctx:
            ...
    """

    __slots__ = ("name", "kind", "attrs", "ctx", "_t0", "_use")

    def __init__(self, name, kind="internal", ctx=None, **attrs):
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.ctx = ctx
        self._t0 = None
        self._use = None

    def __enter__(self):
        if self.ctx is None:
            if not enabled():
                return None
            parent = current_context()
            self.ctx = parent.child() if parent is not None else mint()
        self._use = use(self.ctx)
        self._use.__enter__()
        self._t0 = time.perf_counter()
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        if self._use is None:
            return False
        t1 = time.perf_counter()
        self._use.__exit__()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        emit_span(self.name, self._t0, t1, self.ctx, kind=self.kind,
                  **self.attrs)
        return False


# ------------------------------------------------------------------ spawn
def stamp_env(env, role, rank=None, ctx=None):
    """Stamp a subprocess environment with trace + identity: sets
    ``MXNET_TRACE_CONTEXT`` to a child of ``ctx`` (default: the
    current context; minted fresh when telemetry is armed and no
    context exists — so a traced parent always links its children) and
    ``MXNET_PROCESS_ROLE`` / ``MXNET_PROCESS_RANK`` for the child's
    ``run_start`` identity.  Returns the child context (or None when
    untraced).  Mutates and returns ``env``."""
    env[ROLE_ENV] = str(role)
    if rank is not None:
        env[RANK_ENV] = str(rank)
    if ctx is None:
        parent = current_context()
        if parent is None:
            if not enabled():
                env.pop(TRACE_ENV, None)
                return None
            parent = mint()
        ctx = parent.child()
    env[TRACE_ENV] = ctx.to_header()
    return ctx


# records written by an armed RunLog pick up the thread's bound trace
# context through this slot (kept a slot, not an import, so runlog
# stays cycle-free)
_runlog._TRACE_GETTER = current_context
