"""Fit-loop telemetry session (counterpart of
``mxnet_tpu/telemetry/session.py``): the glue between ``Module.fit`` and
the process-wide :class:`~mxnet_tpu_torch.telemetry.RunLog`.

One ``FitSession`` wraps one ``fit`` call: it stamps per-step records
(wall time, sampled loss sync, device-feed deltas), emits fit_start/
fit_end events, and owns the crash flight dumps for the three in-fit
death paths (SIGTERM drain, NaN-abort, unhandled exception).  All
methods are cheap no-ops when constructed with ``runlog=None`` so the
fit loop can call unconditionally through :func:`fit_session`.
"""
from __future__ import annotations

import time
from contextlib import nullcontext as _nullcontext

from . import tracing as _tracing

__all__ = ["FitSession", "fit_session"]


class FitSession:
    def __init__(self, runlog, batch_size=0, feed=None, watchdog=None):
        self.rl = runlog
        self.batch_size = int(batch_size)
        self._feed = feed
        self._feed_snap = feed.stats() if feed is not None else None
        self._t_step = None
        self._step_no = 0
        self._ended = False
        # hang watchdog, armed per fit by MXNET_WATCHDOG_SEC (works
        # with or without a run log: the stack dump is the point; the
        # 'watchdog' record rides along only when telemetry is armed).
        # step_begin beats it, finish() closes it.
        self._wd = None
        if watchdog is not False:
            try:
                from .watchdog import Watchdog, default_timeout

                if watchdog is not None:
                    self._wd = watchdog.arm("fit")
                elif default_timeout() > 0:
                    self._wd = Watchdog().arm("fit")
            except Exception:
                self._wd = None  # the observer must not break fit
        # fit is a trace entry point: one root context per fit call
        # (child of the process stamp when this worker was spawned by
        # a traced supervisor).  Sampled steps emit fit_step spans;
        # unsampled steps stay on the hot-path budget.
        self._trace = None
        if runlog is not None:
            parent = _tracing.current_context()
            self._trace = parent.child() if parent is not None \
                else _tracing.mint()
            with _tracing.use(self._trace):
                runlog.event("fit_start", batch_size=self.batch_size)

    def __bool__(self):
        return self.rl is not None

    # ------------------------------------------------------------ steps
    def step_begin(self):
        if self._wd is not None:
            self._wd.beat("step")
        if self.rl is not None:
            self._t_step = time.perf_counter()

    def should_sync(self):
        """Sampled-sync decision for this step (the caller pays one
        device sync to read the loss/metric when True)."""
        return self.rl is not None and self.rl.should_sync(self._step_no)

    def step_end(self, epoch, batch, samples=None, loss=None,
                 synced=False, bad_step=False):
        if self.rl is None or self._t_step is None:
            return
        t0, t1 = self._t_step, time.perf_counter()
        wall = t1 - t0
        self._t_step = None
        feed_wait = h2d = None
        if self._feed is not None:
            snap = self._feed.stats()
            prev = self._feed_snap or {}
            feed_wait = snap.get("consumer_wait_s", 0.0) \
                - prev.get("consumer_wait_s", 0.0)
            h2d = snap.get("h2d_bytes", 0) - prev.get("h2d_bytes", 0)
            self._feed_snap = snap
        ctx = None
        if synced and self._trace is not None:
            # sampled steps only: the span rides the step record's
            # flush (flush=False) so traced fits pay zero extra
            # syscalls on the step path
            ctx = self._trace.child()
            _tracing.emit_span("fit_step", t0, t1, ctx, flush=False,
                               epoch=int(epoch), batch=int(batch))
        with (_tracing.use(ctx) if ctx is not None
              else _nullcontext()):
            self.rl.step(
                epoch, batch, wall,
                samples if samples is not None else self.batch_size,
                loss=loss, synced=synced, feed_wait_s=feed_wait,
                h2d_bytes=h2d, bad_step=bad_step)
        self._step_no += 1

    # ------------------------------------------------------ death paths
    def flight(self, reason):
        """First dump wins: the specific reason recorded at the raise
        site (nan_abort, preempt_drain) must not be overwritten by the
        generic exception handler unwinding past it."""
        if self.rl is None or getattr(self, "_flight_done", False):
            return None
        path = self.rl.flight_dump(reason)
        if path is not None:
            self._flight_done = True
        return path

    def finish(self, outcome="ok"):
        if self._wd is not None:
            self._wd.close()
            self._wd = None
        if self.rl is None or self._ended:
            return
        self._ended = True
        with (_tracing.use(self._trace) if self._trace is not None
              else _nullcontext()):
            self.rl.event("fit_end", outcome=outcome,
                          steps=self._step_no)
        if self.rl.textfile:
            self.rl.write_textfile()


def fit_session(batch_size=0, feed=None):
    """Build a FitSession against the active RunLog (a no-op shell when
    telemetry is off)."""
    from .runlog import current

    return FitSession(current(), batch_size=batch_size, feed=feed)
