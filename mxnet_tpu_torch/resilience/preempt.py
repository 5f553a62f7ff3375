"""Preemption drain (counterpart of ``mxnet_tpu/resilience/preempt.py``).

An orchestrator teardown delivers SIGTERM.  Inside a
:class:`PreemptionDrain` the signal only sets a flag; the loop that
polls it (``serving.ModelServer.run_until_drained``) finishes the work
in flight, and then the signal is re-raised under its original
disposition, so the process exits as the orchestrator expects
(killed by 15).
"""
from __future__ import annotations

import os
import signal
import threading

__all__ = ["PreemptionDrain"]


class PreemptionDrain:
    """Context manager that converts termination signals to a drain
    request the serving loop polls.

    Only the main thread can own signal handlers; entered from any
    other thread this is a no-op shell (``requested`` stays None).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev = {}
        self._requested = None
        self._installed = False

    # ------------------------------------------------------- installed
    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except (ValueError, OSError):  # embedded interpreters etc.
            self._restore()
        return self

    def __exit__(self, *exc):
        self._restore()
        return False

    def _on_signal(self, signum, frame):
        # drain, don't die: the loop checks `requested` after the
        # in-flight step completes
        self._requested = signum

    def _restore(self):
        # keyed off _prev, not _installed: a PARTIAL install failure
        # (second signal.signal raised) must still put back the
        # handlers that did install, or the process is left with a
        # drain handler nothing polls — unkillable by SIGTERM
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev = {}
        self._installed = False

    # -------------------------------------------------------- consumers
    @property
    def requested(self):
        """The signal number that requested the drain, or None."""
        return self._requested

    def reraise(self):
        """Re-deliver the drained signal under its ORIGINAL disposition.

        The contract is drain-then-die, not swallow: after the drain the
        process must still exit the way the orchestrator expects (default SIGTERM -> killed-by-15 status,
        default SIGINT -> KeyboardInterrupt).  No-op when nothing was
        requested.
        """
        sig = self._requested
        self._restore()
        if sig is None:
            return
        self._requested = None
        os.kill(os.getpid(), sig)
        # a default-disposition signal terminates before os.kill
        # returns control here; a handled/ignored one falls through —
        # surface SIGINT as the interrupt the caller expects
        if sig == signal.SIGINT:
            raise KeyboardInterrupt
