"""Bounded exponential-backoff-with-jitter retry (counterpart of
``mxnet_tpu/resilience/retry.py``).

One shared helper for transient-failure paths (the serving batcher
retries a transient model fault inside the batch's deadline with it):
attempts are bounded, the delay doubles up to a cap, and jitter
decorrelates the retries of several callers.
"""
from __future__ import annotations

import random
import time

__all__ = ["retry_call"]


def retry_call(fn, retry_on=(ConnectionError, EOFError, OSError),
               attempts=4, base_delay=0.05, max_delay=2.0, jitter=0.5,
               deadline=None, deadline_sec=None, on_retry=None):
    """Call ``fn()`` until it succeeds, raising the last error after
    ``attempts`` tries or once ``deadline`` (absolute ``time.monotonic``
    value) passes.

    ``deadline_sec`` is the relative form: a TOTAL time budget for the
    whole call, stamped at entry.  Attempt counts alone can overshoot
    a caller's deadline once the exponential backoff grows (4 attempts
    at max_delay=2.0 is already ~6 s of sleeping on top of the call
    costs), so callers with an SLA pass their remaining budget here —
    the serving batcher passes its batch's tightest deadline — and the
    retry loop gives up (re-raising the last error) as soon as the
    budget is spent, never sleeping past it.  When both forms are
    given the earlier one wins.

    ``on_retry(attempt_no, exc)`` runs between attempts (a client can
    drop a dead connection there so the next attempt redials).
    Backoff: ``base_delay * 2**k`` capped at ``max_delay``, then
    stretched by up to ``jitter`` (fraction) of itself at random.
    """
    if deadline_sec is not None:
        rel = time.monotonic() + float(deadline_sec)
        deadline = rel if deadline is None else min(deadline, rel)
    delay = float(base_delay)
    attempts = max(1, int(attempts))
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            timed_out = deadline is not None \
                and time.monotonic() >= deadline
            if attempt >= attempts or timed_out:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep = min(delay, float(max_delay))
            sleep *= 1.0 + jitter * random.random()
            if deadline is not None \
                    and time.monotonic() + sleep >= deadline:
                # the budget cannot cover even the backoff: give up
                # NOW — sleeping up to the deadline and then launching
                # one more attempt would overshoot the caller's SLA by
                # a full fn() duration
                raise
            time.sleep(sleep)
            delay *= 2.0
    raise AssertionError("unreachable")  # pragma: no cover
