"""Deterministic fault injection (counterpart of
``mxnet_tpu/resilience/faultsim.py``).

Named injection points that production traffic pays one dict lookup
for and tests arm deterministically by hit count.  Point names are
registered by the subsystem that wires them (:func:`register_point`;
the serving package registers ``serve.admit``, ``serve.prefill`` and
``serve.decode`` at import), and a spec naming an unknown point fails
loudly at arm time.

Spec grammar (env ``MXNET_FAULT_SPEC`` or ``faultsim.reset(spec)``)::

    spec   := clause (';' clause)*
    clause := point ':' action ['=' value] '@' hits
    action := crash | raise | delay | nan
    hits   := N | N-M | N+          (1-based per-point hit count)

Actions: ``crash`` is ``os._exit(87)`` after the flight dump and the
:func:`on_crash` hooks; ``raise`` raises :class:`FaultInjected`;
``delay=S`` sleeps S seconds; ``nan`` returns ``"nan"`` so the caller
poisons its own value.  Every armed hit counts ``faults`` and writes a
``fault`` event into the active run log.

Built-in point: ``step.loss_nan`` (the ``make_train_step`` host wrapper
and the ``Module.fit`` step guard).
"""
from __future__ import annotations

import os
import threading
import time

from ..base import MXNetError

__all__ = ["FaultInjected", "inject", "probe", "reset", "hits",
           "armed", "on_crash", "register_point", "points",
           "CRASH_EXIT_CODE"]

#: exit status of an armed ``crash`` action
CRASH_EXIT_CODE = 87

#: name -> one-line doc of every arm-able injection point
_POINTS = {
    "step.loss_nan": "train-step host wrapper + fit step guard",
}
_LOCK = threading.Lock()
# spec None = not yet armed (first inject() reads MXNET_FAULT_SPEC)
_STATE = {"spec": None, "rules": {}, "hits": {}}

#: callbacks run on the ``crash`` path between the flight dump and
#: ``os._exit`` (which skips atexit and every other thread's pending
#: work): state that must survive the simulated power loss registers a
#: flusher here
_CRASH_HOOKS = []


def on_crash(fn):
    """Register ``fn()`` to run right before a ``crash`` action's
    ``os._exit`` (after the flight dump).  A hook that raises is
    skipped: the crash fires all the same.  Returns ``fn`` (usable as
    a decorator)."""
    if fn not in _CRASH_HOOKS:
        _CRASH_HOOKS.append(fn)
    return fn


def register_point(name, doc=""):
    """Register an injection point name so specs may arm it (idempotent;
    returns ``name``)."""
    with _LOCK:
        _POINTS[str(name)] = str(doc)
    return name


def points():
    """Sorted names of every registered injection point."""
    with _LOCK:
        return sorted(_POINTS)


class FaultInjected(Exception):
    """Raised by an armed ``raise`` injection point."""

    def __init__(self, point, hit):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class _Rule:
    __slots__ = ("action", "value", "lo", "hi")

    def __init__(self, action, value, lo, hi):
        self.action = action
        self.value = value
        self.lo = lo
        self.hi = hi  # None = open-ended (the "N+" form)

    def matches(self, n):
        return self.lo <= n and (self.hi is None or n <= self.hi)


def _parse(spec):
    rules = {}
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        try:
            point, rest = clause.split(":", 1)
            action, hitpart = rest.split("@", 1)
        except ValueError:
            raise MXNetError(
                f"bad fault spec clause {clause!r} "
                "(want point:action[=value]@hits)") from None
        value = None
        if "=" in action:
            action, raw = action.split("=", 1)
            try:
                value = float(raw)
            except ValueError:
                raise MXNetError(
                    f"bad fault value {raw!r} in {clause!r}") from None
        action = action.strip()
        if action not in ("crash", "raise", "delay", "nan"):
            raise MXNetError(f"unknown fault action {action!r} in "
                             f"{clause!r}")
        hitpart = hitpart.strip()
        try:
            if hitpart.endswith("+"):
                lo, hi = int(hitpart[:-1]), None
            elif "-" in hitpart:
                a, b = hitpart.split("-", 1)
                lo, hi = int(a), int(b)
            else:
                lo = hi = int(hitpart)
        except ValueError:
            raise MXNetError(
                f"bad hit range {hitpart!r} in {clause!r}") from None
        point = point.strip()
        if point not in _POINTS:
            known = ", ".join(sorted(_POINTS))
            raise MXNetError(
                f"unknown fault point {point!r} in {clause!r} "
                f"(registered points: {known}; arm the spec after "
                "importing the subsystem that registers it)")
        rules.setdefault(point, []).append(
            _Rule(action, value, lo, hi))
    return rules


def reset(spec=None):
    """(Re)arm from ``spec`` and clear all hit counters; ``None``
    re-reads ``MXNET_FAULT_SPEC``."""
    if spec is None:
        spec = os.environ.get("MXNET_FAULT_SPEC", "")
    rules = _parse(spec)
    with _LOCK:
        _STATE["spec"] = spec
        _STATE["rules"] = rules
        _STATE["hits"] = {}


def _ensure_locked():
    if _STATE["spec"] is None:
        spec = os.environ.get("MXNET_FAULT_SPEC", "")
        # parse before recording: an unknown-point spec must stay loud
        # on every later call, not fail once and silently disarm
        rules = _parse(spec)
        _STATE["spec"] = spec
        _STATE["rules"] = rules
        _STATE["hits"] = {}


def hits(point):
    """How many times ``point`` has fired since the last reset()."""
    with _LOCK:
        _ensure_locked()
        return _STATE["hits"].get(point, 0)


def armed(point):
    """True when any clause names ``point`` — the cheap pre-check that
    keeps optional wrappers (the train step's NaN poisoner) off the
    fast path when the harness is disarmed."""
    with _LOCK:
        _ensure_locked()
        return point in _STATE["rules"]


def _fire(point):
    """Count a hit at ``point``, match the armed rule and emit the
    fault telemetry — the one core :func:`probe` and :func:`inject`
    share.  Returns ``(rule, hit_number)``; rule None when nothing
    armed matches."""
    with _LOCK:
        _ensure_locked()
        n = _STATE["hits"].get(point, 0) + 1
        _STATE["hits"][point] = n
        rule = next((r for r in _STATE["rules"].get(point, ())
                     if r.matches(n)), None)
    if rule is not None:
        try:
            # armed hits are rare: the telemetry cost lands only on the
            # fault path, never on the per-call fast path above
            from .. import telemetry

            telemetry.count("faults")
            telemetry.event("fault", point=point, action=rule.action,
                            hit=n)
        except Exception:
            pass  # the harness must fire even if telemetry is broken
    return rule, n


def probe(point):
    """Count a hit at ``point`` and return the armed action's name
    ('crash' / 'raise' / 'delay' / 'nan', or None) without executing
    ``crash``/``raise``/``nan`` — for points whose caller owns the
    blast radius (a worker thread that must die alone).  ``delay`` is
    slept here, as :func:`inject` sleeps it."""
    rule, _ = _fire(point)
    if rule is None:
        return None
    if rule.action == "delay":
        time.sleep(rule.value or 0.0)
    return rule.action


def inject(point):
    """Count a hit at ``point`` and fire the armed action, if any.

    Returns ``"nan"`` when the caller must poison its value, else
    ``None``.  Thread-safe: one counter per point per process."""
    rule, n = _fire(point)
    if rule is None:
        return None
    if rule.action == "crash":
        try:
            # os._exit skips atexit: the flight recorder is the only
            # record the simulated power loss leaves behind
            from .. import telemetry

            telemetry.flight_dump(f"fault_crash:{point}")
        except Exception:
            pass
        for hook in list(_CRASH_HOOKS):
            try:
                hook()
            except Exception:
                pass
        os._exit(CRASH_EXIT_CODE)
    if rule.action == "raise":
        raise FaultInjected(point, n)
    if rule.action == "delay":
        time.sleep(rule.value or 0.0)
        return None
    return "nan"
