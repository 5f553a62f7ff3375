"""Hang watchdog: stack dumps for stalls no cooperative check can see
(counterpart of ``mxnet_tpu/telemetry/watchdog.py``).

A step wedged inside a native call (a CUDA synchronize that never
returns, a deadlocked collective, a kernel that never ends) stops
Python control flow on the main thread, so no cooperative deadline
check runs.  :class:`Watchdog` runs a daemon thread armed per fit
(``MXNET_WATCHDOG_SEC``) or per server (``watchdog_sec``).  Every unit
of forward progress calls :meth:`~Watchdog.beat`; when the heartbeat
goes quiet for longer than the timeout — even with the main thread
blocked in native code — the watchdog thread:

* appends an all-thread stack dump (``faulthandler``, which walks
  frames without the stalled threads' cooperation) to the stack file,
  so the post-mortem says where the run wedged;
* flushes the flight-recorder ring with reason ``stall`` and emits a
  ``watchdog`` record + ``watchdog_stalls`` counter into the active
  RunLog (both best-effort: telemetry may be unarmed);
* invokes the optional ``on_stall`` callback.

The watchdog observes, it never kills — by default.  After firing it
re-arms, so a long stall produces a bounded series of dumps
(``max_dumps``) showing whether the stack moves.

``MXNET_WATCHDOG_ABORT`` (default off) is the escalation for jobs whose
orchestrator has no external executioner: once the ``max_dumps`` stall
dumps of one episode are spent and the heartbeat is still quiet for
another full timeout, the watchdog flushes the flight ring, fires the
emergency checkpoint (``resilience.healing``: the freshest async
snapshot, no collective needed) and leaves through ``os._exit`` with
:data:`WATCHDOG_ABORT_EXIT_CODE`, so a wedged job is rescheduled
instead of burning its wall budget.

Unarmed contract: ``MXNET_WATCHDOG_SEC`` unset/0 means no thread is
ever started and ``beat()`` is a single attribute check.
"""
from __future__ import annotations

import faulthandler
import io
import os
import tempfile
import threading
import time

__all__ = ["Watchdog", "stack_path_for", "find_stack_dumps",
           "default_timeout", "WATCHDOG_ABORT_EXIT_CODE"]

#: exit status of a MXNET_WATCHDOG_ABORT escalation — distinct from the
#: faultsim crash code (87), a healing peer-death exit (83) and any
#: signal status, so a supervisor can tell "wedged and self-aborted"
#: from every other death
WATCHDOG_ABORT_EXIT_CODE = 85


def stack_path_for(runlog_path, pid=None):
    """The stack-dump file that pairs with a run log (like
    ``flight_path_for``): ``<runlog>.stacks.<pid>.txt``, pid-suffixed so
    two processes armed with the same ``MXNET_RUNLOG`` path keep their
    dumps apart."""
    return f"{runlog_path}.stacks.{os.getpid() if pid is None else pid}.txt"


def find_stack_dumps(runlog_path):
    """Every stack-dump file paired with a run log, newest first —
    pid-suffixed names plus the unsuffixed ``<runlog>.stacks.txt``
    older writers left."""
    import glob as _glob

    found = _glob.glob(f"{runlog_path}.stacks.*.txt")
    legacy = f"{runlog_path}.stacks.txt"
    if os.path.exists(legacy) and legacy not in found:
        found.append(legacy)
    found.sort(key=lambda p: (os.path.getmtime(p), p), reverse=True)
    return found


def default_timeout():
    """``MXNET_WATCHDOG_SEC`` from the registry; 0 = disarmed."""
    from ..config import get_env

    try:
        return float(get_env("MXNET_WATCHDOG_SEC"))
    except Exception:
        return 0.0


class Watchdog:
    """Background hang detector (see module docstring).

    Parameters
    ----------
    timeout : float or None
        Quiet seconds before a stall fires.  None reads
        ``MXNET_WATCHDOG_SEC``; <= 0 disables (no thread started).
    stack_path : str or None
        File the all-thread stack dumps append to.  None derives it
        from the active run log (``<runlog>.stacks.txt``) or falls
        back to a pid-keyed file in the temp dir.
    on_stall : callable or None
        ``on_stall(phase, quiet_s, stack_path)`` invoked from the
        watchdog thread after each dump (exceptions swallowed — an
        observer must not kill the observed).
    max_dumps : int
        Stack dumps per process — a truly wedged run re-fires every
        ``timeout`` seconds and this bounds the evidence file.
    """

    def __init__(self, timeout=None, stack_path=None, on_stall=None,
                 max_dumps=5, poll=None, abort=None):
        self.timeout = default_timeout() if timeout is None \
            else float(timeout)
        self._explicit_stack_path = stack_path
        self.on_stall = on_stall
        self.max_dumps = int(max_dumps)
        #: consecutive quiet periods in the CURRENT stall episode, reset
        #: by every beat: the abort escalation keys off it, so a run that
        #: stalled early and recovered is not executed on its next
        #: single-timeout hiccup
        self.episode_stalls = 0
        if abort is None:
            try:
                from ..config import get_env

                abort = bool(get_env("MXNET_WATCHDOG_ABORT"))
            except Exception:
                abort = False
        self.abort = bool(abort)
        self.stalls = 0
        self._poll = poll  # test hook; default derives from timeout
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._armed = False
        self._phase = None
        self._last_beat = time.monotonic()

    # ------------------------------------------------------------ paths
    @property
    def stack_path(self):
        if self._explicit_stack_path:
            return self._explicit_stack_path
        from . import runlog as _rl

        rl = _rl.current()
        if rl is not None:
            return stack_path_for(rl.path)
        return os.path.join(
            tempfile.gettempdir(),
            f"mxnet_tpu_torch_watchdog_{os.getpid()}.stacks.txt")

    # ---------------------------------------------------------- control
    def arm(self, phase="run"):
        """Arm for a phase: starts the thread on first use.  A <= 0
        timeout keeps everything off (no thread, beat() near-free)."""
        if self.timeout <= 0:
            return self
        with self._lock:
            self._phase = str(phase)
            self._last_beat = time.monotonic()
            self._armed = True
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._watch, name="mxnet_tpu_torch-watchdog",
                    daemon=True)
                self._thread.start()
        return self

    def beat(self, phase=None):
        """Record forward progress (and optionally a phase change)."""
        if not self._armed:
            return
        with self._lock:
            self._last_beat = time.monotonic()
            self.episode_stalls = 0  # recovery ends the stall episode
            if phase is not None:
                self._phase = str(phase)

    def disarm(self):
        """Stop watching (the thread idles; re-``arm`` restarts)."""
        with self._lock:
            self._armed = False

    def close(self):
        self.disarm()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def __enter__(self):
        return self.arm()

    def __exit__(self, *exc):
        # full close, not just disarm: the context-manager form must
        # not leak one polling daemon thread per with-block (re-arm
        # after close starts a fresh thread, so reuse still works)
        self.close()
        return False

    # ------------------------------------------------------------ watch
    def _watch(self):
        poll = self._poll if self._poll is not None \
            else max(0.05, min(self.timeout / 4.0, 5.0))
        while not self._stop.wait(poll):
            with self._lock:
                armed = self._armed
                quiet = time.monotonic() - self._last_beat
                phase = self._phase
            if not armed or quiet < self.timeout:
                continue
            self.episode_stalls += 1
            if self.abort and self.episode_stalls > self.max_dumps:
                # escalation (MXNET_WATCHDOG_ABORT): max_dumps quiet
                # periods of this episode are spent and the heartbeat
                # is still dead a full timeout later — leave every
                # post-mortem artifact and die with a distinct status
                self._abort(phase, quiet)
            if self.stalls < self.max_dumps:
                self._fire(phase, quiet)
            with self._lock:
                # re-arm in all cases (fired or dump budget spent): a
                # quiet period, not a poll tick, is the unit the dump
                # series advances by, so the dumps show whether the
                # stacks move
                if time.monotonic() - self._last_beat >= self.timeout:
                    self._last_beat = time.monotonic()

    def _fire(self, phase, quiet_s):
        self.stalls += 1
        path = self.stack_path
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(f"\n==== watchdog stall #{self.stalls} "
                        f"phase={phase} quiet={quiet_s:.1f}s "
                        f"pid={os.getpid()} t={time.time():.3f} ====\n")
                f.flush()
                self._dump_stacks(f)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            path = None  # a full disk must not kill the watchdog
        # best-effort telemetry: the RunLog may be unarmed
        try:
            from . import runlog as _rl

            rl = _rl.current()
            if rl is not None:
                rl.count("watchdog_stalls")
                rl.watchdog(phase, quiet_s, path)
                rl.flight_dump("stall")
        except Exception:
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(phase, quiet_s, path)
            except Exception:
                pass

    def _abort(self, phase, quiet_s):
        """The MXNET_WATCHDOG_ABORT escalation: the emergency checkpoint
        from the freshest snapshot, a ``heal`` record, the flight ring,
        the run log closed, then ``os._exit`` — a wedged native call
        cannot be unwound, only abandoned, and the exit code says
        why."""
        try:
            from ..resilience import healing

            healing.fire_emergency("watchdog_abort")
        except Exception:
            pass
        try:
            from . import runlog as _rl

            rl = _rl.current()
            if rl is not None:
                rl.heal("watchdog_abort", phase=str(phase),
                        quiet_s=round(float(quiet_s), 3),
                        stalls=self.stalls,
                        code=WATCHDOG_ABORT_EXIT_CODE)
                rl.flight_dump("watchdog_abort")
                rl.close()
        except Exception:
            pass
        os._exit(WATCHDOG_ABORT_EXIT_CODE)

    @staticmethod
    def _dump_stacks(f):
        """All-thread stacks via faulthandler (walks C-blocked threads'
        Python frames without their cooperation).  Falls back to the
        traceback module if faulthandler refuses the file object."""
        try:
            faulthandler.dump_traceback(file=f, all_threads=True)
            return
        except Exception:
            pass
        import traceback
        import sys

        buf = io.StringIO()
        for tid, frame in sys._current_frames().items():
            buf.write(f"Thread 0x{tid:x}:\n")
            traceback.print_stack(frame, file=buf)
        f.write(buf.getvalue())
