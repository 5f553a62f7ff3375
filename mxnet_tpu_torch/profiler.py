"""Profiler with the reference API, emitting Chrome-trace JSON
(counterpart of ``mxnet_tpu/profiler.py``).

Reference parity: python/mxnet/profiler.py:33-151 (set_config /
set_state / dump / dumps / pause / resume) and the user-scope objects
Domain/Task/Frame/Event/Counter/Marker (:225-497).

Two complementary layers:

  * host-side events — every ``nd`` op dispatch (the analog of the
    reference's per-op ProfileOperator begin/end), user scopes
    (Task/Frame/Event), counters and instant markers — buffered
    in-process and dumped as a Chrome trace (``chrome://tracing`` /
    Perfetto) by :func:`dump`.
  * device-side tracing — with ``set_config(profile_device=True,
    tensorboard_logdir=...)`` the same set_state('run'/'stop') brackets
    a ``torch.profiler.profile`` over the CPU and (where there is a
    card) CUDA activities; on stop its Chrome trace goes to
    ``tensorboard_logdir`` (:func:`device_trace_path`).  While it runs,
    every op scope and user scope also opens a
    ``torch.profiler.record_function`` of the same name, so the device
    trace names the host work open around each kernel and each idle
    gap.  (The reference captures a ``jax.profiler`` XPlane here.)

Aggregate statistics (``dumps(format='table')``) mirror the reference's
aggregate_stats table: per-op call counts and total/min/max/mean host
dispatch time.
"""
from __future__ import annotations

import atexit
import json
import os
import tempfile
import threading
import time

from .base import MXNetError

__all__ = [
    "set_config", "profiler_set_config", "set_state", "profiler_set_state",
    "dump", "dump_profile", "dumps", "pause", "resume", "op_scope",
    "now_us", "run_generation", "record_span", "record_counter",
    "record_instant", "record_meta", "events_snapshot",
    "device_trace_path", "device_profile",
    "Domain", "Task", "Frame", "Event", "Counter", "Marker",
]

_lock = threading.Lock()
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": False,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": True,
    "aggregate_stats": False,
    "continuous_dump": False,
    "dump_period": 1.0,
    "profile_device": False,
    "tensorboard_logdir": None,
}
_state = "stop"
_paused = False
_events = []  # chrome trace event dicts
_agg = {}  # name -> [count, total_us, min_us, max_us]
#: the running ``torch.profiler.profile`` (None when no device capture
#: runs), the last capture's object and the path of its Chrome trace
_device = {"prof": None, "last": None, "path": None}
_run_gen = 0  # run-window starts; external lanes key metadata off it
_t0 = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def now_us():
    """Microseconds on the profiler's trace clock — external lanes
    (telemetry.RunLog) must timestamp on THIS clock so their spans line
    up with the op events in one Perfetto timeline."""
    return _now_us()


def run_generation():
    """Counts run-window starts.  Lane owners (telemetry) key their
    per-trace metadata ('thread_name') off this so a second run window
    after a finished dump gets its lane named again, not skipped."""
    return _run_gen


def is_running():
    return _state == "run" and not _paused


def set_config(**kwargs):
    """Reference: profiler.py:33 — configure before set_state('run').

    Accepted kwargs mirror the reference (filename, profile_all,
    profile_symbolic, profile_imperative, profile_memory, profile_api,
    aggregate_stats, continuous_dump, dump_period) plus the extensions
    profile_device / tensorboard_logdir (the device capture).
    """
    if _state == "run":
        # reference parity (profiler.py:33 backed by the C++ check):
        # reconfiguring mid-collection (e.g. switching `filename`)
        # would silently split/lose events — refuse, like the C side
        raise MXNetError(
            "profiler.set_config cannot be called while the profiler "
            "is running; set_state('stop') first")
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError(f"unknown profiler config keys: {sorted(unknown)}")
    if kwargs.get("profile_all"):
        _config.update(profile_symbolic=True, profile_imperative=True,
                       profile_memory=True, profile_api=True)
    _config.update(kwargs)


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Deprecated reference alias (profiler.py:70)."""
    set_config(profile_symbolic=(mode in ("symbolic", "all")),
               profile_imperative=(mode in ("imperative", "all")),
               filename=filename)


def set_state(state="stop", profile_process="worker"):
    """Reference: profiler.py:89 — 'run' starts collection, 'stop' ends.

    Stopping with continuous_dump set dumps automatically (the reference
    dumps from the C++ side on WorkerProfile teardown).
    """
    global _state, _paused, _run_gen
    if state not in ("run", "stop"):
        raise MXNetError(f"invalid profiler state {state!r}")
    prev = _state
    _state = state
    _paused = False
    if state == "run" and prev != "run":
        _run_gen += 1
        _record_instant("profiler_start", "profiler")
        if _config["profile_device"] and _device["prof"] is None:
            _start_device()
    elif state == "stop" and prev == "run":
        _stop_device()
        if _config["continuous_dump"]:
            dump()


def _start_device():
    """Open the ``torch.profiler`` capture (CPU, and CUDA where there
    is a card)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _device["prof"] = prof


def _stop_device():
    """Close the device capture and write its Chrome trace into
    ``tensorboard_logdir``; returns the path (None when none ran)."""
    prof = _device["prof"]
    if prof is None:
        return None
    _device["prof"] = None
    prof.stop()
    logdir = _config["tensorboard_logdir"] or os.path.join(
        tempfile.gettempdir(), "mxnet_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"device_trace.{os.getpid()}.{_run_gen}.json")
    prof.export_chrome_trace(path)
    _device["last"] = prof
    _device["path"] = path
    return path


def device_trace_path():
    """Path of the last device capture's Chrome trace, or None."""
    return _device["path"]


def device_profile():
    """The last finished ``torch.profiler.profile`` (its
    ``key_averages()`` / ``events()``), or None."""
    return _device["last"]


def _device_scope(name):
    """A ``record_function`` of ``name``, entered, while the device
    capture runs; None otherwise."""
    if _device["prof"] is None:
        return None
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def profiler_set_state(state="stop"):
    """Deprecated reference alias (profiler.py:109)."""
    set_state(state)


def pause(profile_process="worker"):
    """Reference: profiler.py:193."""
    global _paused
    _paused = True


def resume(profile_process="worker"):
    """Reference: profiler.py:209."""
    global _paused
    _paused = False


def _record(name, cat, ph, ts_us, dur_us=None, args=None, tid=None):
    ev = {
        "name": name, "cat": cat, "ph": ph, "ts": ts_us,
        "pid": os.getpid(),
        "tid": tid if tid is not None else threading.get_ident() % 100000,
    }
    if dur_us is not None:
        ev["dur"] = dur_us
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def _record_instant(name, cat, args=None):
    _record(name, cat, "i", _now_us(), args=args)


def record_op(name, dur_us, cat="operator", args=None):
    """Record one complete op-dispatch event (internal hook; the analog
    of the reference's ProfileOperator, src/profiler/profiler.h:77)."""
    _record(name, cat, "X", _now_us() - dur_us, dur_us, args=args)
    if _config["aggregate_stats"]:
        with _lock:
            ent = _agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
            ent[0] += 1
            ent[1] += dur_us
            ent[2] = min(ent[2], dur_us)
            ent[3] = max(ent[3], dur_us)


def events_snapshot():
    """A copy of the buffered Chrome-trace events collected so far.

    The public hook the aggregate-opstats layer
    (:mod:`mxnet_tpu.telemetry.opstats`) folds per-op tables from:
    unlike :func:`dump`, it neither drains the buffer nor stops
    collection, so a mid-run aggregate costs one list copy."""
    with _lock:
        return list(_events)


def record_span(name, cat, start_us, dur_us, args=None, tid=None):
    """Public lane hook: one complete 'X' span on the trace clock
    (``now_us``).  Used by telemetry.RunLog to put step/feed-wait/
    checkpoint spans on the same Perfetto timeline as the op events.
    Respects the run/pause window like every other event."""
    if is_running():
        _record(name, cat, "X", start_us, dur_us, args=args, tid=tid)


def record_counter(name, value, cat="counter", tid=None):
    """Public lane hook: one 'C' counter sample (throughput, loss)."""
    if is_running():
        _record(name, cat, "C", _now_us(), args={name: value}, tid=tid)


def record_instant(name, cat, args=None, tid=None):
    """Public lane hook: one instant event."""
    if is_running():
        _record(name, cat, "i", _now_us(), args=args, tid=tid)


def record_meta(name, args, tid=None):
    """Metadata event ('M') — names a tid lane in Perfetto.  Not gated
    on is_running: lane names must land even when emitted just before
    the run window opens."""
    _record(name, "__metadata", "M", 0, args=args, tid=tid)


def op_scope(name):
    """Public dispatcher hook: a context manager timing one op dispatch,
    or None when op profiling is off (the hot-path fast exit)."""
    if is_running() and _config["profile_imperative"]:
        return _OpScope(name)
    return None


class _OpScope:
    """Context manager used by the nd dispatcher to time op dispatch."""

    __slots__ = ("name", "_start", "_bytes", "_rf")

    def __init__(self, name):
        self.name = name
        self._bytes = None
        self._rf = None

    def set_result(self, out):
        """Attach the output size so the aggregate opstats table can
        report bytes per op; only ever paid while profiling is on."""
        total = 0
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for o in outs:
            data = getattr(o, "_data", o)
            n = getattr(data, "nbytes", None)
            if n is not None:
                total += int(n)
        self._bytes = total or None

    def __enter__(self):
        self._rf = _device_scope(self.name)
        self._start = _now_us()
        return self

    def __exit__(self, *exc):
        args = {"bytes": self._bytes} if self._bytes is not None \
            else None
        record_op(self.name, _now_us() - self._start, args=args)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        return False


def dump(finished=True, profile_process="worker"):
    """Reference: profiler.py:122 — write the Chrome trace JSON file.

    ``finished=True`` means profiling is COMPLETE: the buffer is
    flushed and collection stops (reference semantics — the C++ side
    tears down WorkerProfile).  ``finished=False`` writes a snapshot
    of everything collected so far and KEEPS collecting — the buffer
    is retained so the next dump carries the full timeline (periodic
    mid-run dumps watch a live training job without truncating it)."""
    global _state, _paused
    path = _config["filename"]
    with _lock:
        events = list(_events)
        if finished:
            _events.clear()
    if finished and _state == "run":
        _state = "stop"
        _paused = False
        _stop_device()
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def dump_profile():
    """Deprecated reference alias (profiler.py:143)."""
    dump(True)


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Reference: profiler.py:151 — return aggregate stats as a string.

    Requires set_config(aggregate_stats=True).  sort_by in
    {'total','avg','min','max','count'}.
    """
    if format not in ("table", "json"):
        raise MXNetError(f"invalid format {format!r}")
    key_idx = {"count": 0, "total": 1, "min": 2, "max": 3, "avg": 4}
    if sort_by not in key_idx:
        raise MXNetError(f"invalid sort_by {sort_by!r}")
    with _lock:
        rows = [
            (name, c, tot, mn if c else 0.0, mx, (tot / c) if c else 0.0)
            for name, (c, tot, mn, mx) in _agg.items()
        ]
        if reset:
            _agg.clear()
    rows.sort(key=lambda r: r[1 + key_idx[sort_by]], reverse=not ascending)
    if format == "json":
        return json.dumps([
            {"name": n, "count": c, "total_us": t, "min_us": mn,
             "max_us": mx, "avg_us": av} for n, c, t, mn, mx, av in rows])
    lines = [f"{'Name':<40s}{'Calls':>8s}{'Total(us)':>14s}"
             f"{'Min(us)':>12s}{'Max(us)':>12s}{'Avg(us)':>12s}"]
    for n, c, t, mn, mx, av in rows:
        lines.append(f"{n:<40.40s}{c:>8d}{t:>14.1f}{mn:>12.1f}"
                     f"{mx:>12.1f}{av:>12.1f}")
    return "\n".join(lines)


# ------------------------------------------------------------ user scopes
class Domain:
    """Reference: profiler.py:225 — namespace for user scope objects."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    _cat = "user"

    def __init__(self, domain, name):
        self.name = name
        self.domain = domain
        self._start_ts = None
        self._rf = None

    def start(self):
        if is_running():
            self._rf = _device_scope(self.name)
        self._start_ts = _now_us()

    def stop(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self._start_ts is None:
            return
        if is_running():  # user scopes respect the run/pause window too
            dur = _now_us() - self._start_ts
            cat = f"{self._cat}:{self.domain}" if self.domain \
                else self._cat
            _record(self.name, cat, "X", self._start_ts, dur)
        self._start_ts = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass

    def __str__(self):
        return self.name


class Task(_Span):
    """Reference: profiler.py:284."""

    _cat = "task"


class Frame(_Span):
    """Reference: profiler.py:326."""

    _cat = "frame"


class Event(_Span):
    """Reference: profiler.py:368 (domain-less event)."""

    _cat = "event"

    def __init__(self, name):
        super().__init__(None, name)


class Counter:
    """Reference: profiler.py:404 — emits Chrome 'C' counter samples."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._value = value
        if is_running():
            _record(self.name, f"counter:{self.domain}", "C", _now_us(),
                    args={self.name: value})

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self

    def __str__(self):
        return str(self._value)


class Marker:
    """Reference: profiler.py:474 — instant event."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if is_running():
            _record(self.name, f"marker:{self.domain}", "i", _now_us(),
                    args={"scope": scope})


@atexit.register
def _shutdown():
    try:
        _stop_device()
    except Exception:
        pass
