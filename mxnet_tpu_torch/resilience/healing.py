"""Self-healing training runtime: peer failure detection, the
emergency checkpoint and the supervisor that owns the respawn policy
(counterpart of ``mxnet_tpu/resilience/healing.py``).

A process that dies abruptly (SIGKILL, OOM kill) leaves its peers
inside a collective; the reference's ps-lite tracks this liveness at its
server (dead workers detected, their keys re-pulled).  This module is
that capability for the port:

* **Peer liveness** — every process runs a :class:`Heartbeater` (a
  daemon thread renewing a per-rank heartbeat file under a shared
  directory, in the reference's JSON layout, so either package's
  detector reads the other's beats; the ``peer.heartbeat`` fault point
  fires per beat) and a :class:`FailureDetector` that declares a peer
  dead when its beat goes stale for ``MXNET_PEER_TIMEOUT_SEC`` — or at
  once when the beat's pid is gone on the same host (the SIGKILL fast
  path).
* **Collective abandonment** — :func:`guard_collective` runs a
  collective-bearing callable on a worker thread while the caller polls
  the detector: a peer death surfaces as :class:`PeerDeadError` even
  when the gloo call underneath would block, and gloo's own errors on a
  broken group (a connection reset by the kernel for a SIGKILLed peer)
  become the same :class:`PeerDeadError` once the detector confirms the
  death.
* **Emergency checkpoint** — on a declared death the survivor fires
  the freshest host-side snapshot registered through
  :func:`register_emergency` (``CheckpointManager.flush_emergency``:
  no collective and no device needed), records a ``heal`` event and
  the ``peer_deaths`` counter, and leaves with
  :data:`PEER_DEATH_EXIT_CODE` through :func:`heal_exit` —
  ``os._exit``, because tearing down a process group with a dead peer
  can wedge the interpreter.  The relaunch resumes at the surviving
  world size (``elastic.reshard_verdict`` + ``reslice_cursor``),
  counting ``auto_reshards``.
* **Supervisor** — ``python -m mxnet_tpu_torch.resilience.healing
  --relaunch -- CMD...`` spawns CMD and, when it dies with a healable
  status (peer death, a signal kill, the faultsim crash code),
  relaunches it up to ``MXNET_HEAL_MAX_RELAUNCH`` times with
  ``MXNET_HEAL_ATTEMPT`` exported, so the command can size its new
  world (``surviving_ranks`` / ``elect_coordinator`` read the heartbeat
  directory).  The ``heal.relaunch`` fault point fires before every
  respawn.

Coordinator migration: when rank 0 dies, :func:`elect_coordinator`
hands the role to the lowest surviving rank.  The port's rendezvous
store lives in rank 0 (``kvstore.init_distributed``), so a relaunched
world opens a new store at the elected coordinator.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time

from ..base import MXNetError
from . import faultsim

faultsim.register_point("peer.heartbeat", "healing Heartbeater, inside "
                        "every beat (delay = a stalled heart, raise = "
                        "one dropped beat)")
faultsim.register_point("heal.relaunch", "healing supervisor, before "
                        "every respawn of the training command")

__all__ = ["PEER_DEATH_EXIT_CODE", "PeerDeadError", "CollectiveTimeout",
           "Heartbeater", "FailureDetector", "guard_collective",
           "register_emergency", "fire_emergency", "heal_exit",
           "arm", "disarm", "session", "poll", "surviving_ranks",
           "elect_coordinator", "relaunch_attempt", "main"]

#: exit status of a survivor that detected a peer death and healed out
#: (emergency checkpoint flushed, telemetry closed) — the supervisor's
#: signal to relaunch at the surviving world size.  Distinct from the
#: faultsim crash code (87) and a watchdog abort.
PEER_DEATH_EXIT_CODE = 83

class PeerDeadError(MXNetError):
    """A peer process was declared dead by the failure detector."""

    def __init__(self, dead, detail=""):
        self.dead = sorted(int(d) for d in dead)
        msg = f"peer rank(s) {self.dead} declared dead"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class CollectiveTimeout(MXNetError):
    """A guarded collective exceeded its wait budget with every peer
    still nominally alive — the group is wedged, not dead."""


def _pid_alive(pid):
    """Whether a same-host pid is a LIVE process.  ``os.kill(pid, 0)``
    alone is not enough: a SIGKILLed child nobody has reaped yet is a
    zombie — signalable, but as dead as a peer can be (its sockets are
    closed, its collectives will never answer).  On Linux the
    ``/proc/<pid>/stat`` state field settles it; elsewhere the zombie
    ambiguity falls back to the staleness timeout."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but not ours
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            stat = f.read()
        # state is the first field after the comm's closing paren
        # (comm itself may contain spaces/parens)
        state = stat.rsplit(b")", 1)[1].split()[0]
        if state in (b"Z", b"X", b"x"):
            return False
    except (OSError, IndexError):
        pass  # no procfs: treat signalable as alive
    return True


# --------------------------------------------------------------- beats
def _hb_path(hb_dir, rank):
    return os.path.join(os.fspath(hb_dir), f"rank-{int(rank)}.hb")


def _write_beat(hb_dir, rank, step=None):
    """One atomic heartbeat: payload (pid/host/monotonic step) written
    to a temp file and renamed over ``rank-<r>.hb`` — a reader never
    sees a torn beat, and the file mtime IS the beat clock."""
    path = _hb_path(hb_dir, rank)
    os.makedirs(os.fspath(hb_dir), exist_ok=True)
    payload = {"rank": int(rank), "pid": os.getpid(),
               "host": socket.gethostname(), "time": time.time()}
    if step is not None:
        payload["step"] = int(step)
    # pid AND thread id: the daemon beater and an inline fit-poll beat
    # may race — two writers on one tmp path could promote a torn
    # beat, which a peer's detector reads as a sticky false death
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)
    return path


def _read_beat(hb_dir, rank):
    """(payload, age_seconds) of a rank's beat, or (None, None) when
    the rank has never beaten."""
    path = _hb_path(hb_dir, rank)
    try:
        age = time.time() - os.stat(path).st_mtime
        with open(path) as f:
            return json.loads(f.read()), age
    except (OSError, ValueError):
        return None, None


class Heartbeater:
    """Daemon thread renewing this process's heartbeat file every
    ``interval`` seconds.  ``beat()`` may also be called inline (step
    boundaries) to carry the current step number; the thread keeps the
    file fresh even when the main thread is wedged inside a collective
    — which is exactly when a SURVIVOR's liveness must stay provable to
    its peers."""

    def __init__(self, hb_dir, rank, interval=None):
        from ..config import get_env

        self.hb_dir = os.fspath(hb_dir)
        self.rank = int(rank)
        if interval is None:
            # beat several times per timeout window so one missed beat
            # (scheduler hiccup) is never a false death
            interval = max(0.05,
                           float(get_env("MXNET_PEER_TIMEOUT_SEC")) / 4)
        self.interval = float(interval)
        os.makedirs(self.hb_dir, exist_ok=True)
        self._stop = threading.Event()
        self._step = None
        self._last_write = 0.0
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name="mxnet_tpu_torch-heartbeat", daemon=True)
        self._thread.start()

    def beat(self, step=None):
        """Record liveness (and optionally the current step).  Inline
        callers (the per-batch fit poll) are RATE-LIMITED to half the
        beat interval: the daemon thread already keeps the file fresh,
        and a heartbeat dir on shared storage must not pay one
        rename per millisecond-scale step."""
        if step is not None:
            self._step = int(step)
        now = time.monotonic()
        if now - self._last_write < self.interval / 2:
            return
        self._last_write = now
        try:
            faultsim.inject("peer.heartbeat")
            _write_beat(self.hb_dir, self.rank, self._step)
        except faultsim.FaultInjected:
            pass  # an armed raise = one dropped beat, not a crash
        except OSError:
            pass  # a full disk must not kill the run; staleness will
            #       page through the peer's detector instead

    def _run(self):
        while not self._stop.wait(self.interval):
            self.beat()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        try:
            os.unlink(_hb_path(self.hb_dir, self.rank))
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class FailureDetector:
    """Survivor-side death verdicts over the heartbeat directory.

    A peer is DEAD when:

    * its beat file exists but has gone stale for longer than
      ``timeout`` (``MXNET_PEER_TIMEOUT_SEC``), or
    * its recorded pid no longer exists on this host (same-hostname
      beats only — the SIGKILL fast path: no waiting out the timeout
      for a local corpse), or
    * it NEVER beat within ``timeout`` of the detector starting (a
      peer that died before writing its first beat).

    ``dead_peers()`` is cheap (one stat per peer) and safe to poll
    from step loops and guard threads.  Verdicts are sticky: a rank
    once declared dead stays dead (a resurrected pid must rejoin as a
    NEW incarnation via relaunch, not un-declare its own death).
    """

    def __init__(self, hb_dir, rank, num_ranks, timeout=None,
                 telemetry=True):
        from ..config import get_env

        self.hb_dir = os.fspath(hb_dir)
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.timeout = (float(get_env("MXNET_PEER_TIMEOUT_SEC"))
                        if timeout is None else float(timeout))
        # telemetry=False for QUERY-side detectors (surviving_ranks in
        # a relaunched child): the first incarnation's survivor
        # already counted the death — a second detector re-observing
        # the same corpse must not double-count peer_deaths
        self.telemetry = bool(telemetry)
        self._t0 = time.time()
        self._host = socket.gethostname()
        self._dead = {}  # rank -> reason (sticky)
        self._first_mtime = {}  # rank -> mtime at first observation

    def _verdict(self, r):
        payload, age = _read_beat(self.hb_dir, r)
        if payload is None:
            if time.time() - self._t0 > self.timeout:
                return f"never beat within {self.timeout:.1f}s"
            return None
        try:
            mtime = os.stat(_hb_path(self.hb_dir, r)).st_mtime
        except OSError:
            mtime = None
        if mtime is not None:
            first = self._first_mtime.setdefault(r, mtime)
            if mtime == first and first < self._t0:
                # an UNCHANGED beat that predates this detector: a
                # leftover file from a previous incarnation (fit
                # never cleans the shared dir).  It earns the same
                # startup grace as a missing beat — the pid it names
                # belongs to the old world, so neither the pid fast
                # path nor plain staleness may execute a peer that is
                # merely still starting up.  Any mtime CHANGE is live
                # activity and restores the normal rules.
                if time.time() - self._t0 > self.timeout:
                    return (f"no fresh beat within "
                            f"{self.timeout:.1f}s (stale "
                            "pre-existing beat)")
                return None
        if payload.get("host") == self._host:
            pid = int(payload.get("pid", 0))
            if pid > 0 and not _pid_alive(pid):
                return f"pid {pid} gone"
        if age is not None and age > self.timeout:
            return f"beat stale {age:.1f}s > {self.timeout:.1f}s"
        return None

    def dead_peers(self):
        """Sorted ranks currently declared dead (never includes self)."""
        for r in range(self.num_ranks):
            if r == self.rank or r in self._dead:
                continue
            reason = self._verdict(r)
            if reason:
                self._dead[r] = reason
                if self.telemetry:
                    try:
                        from .. import telemetry

                        telemetry.count("peer_deaths")
                        telemetry.heal("peer_death", peer=r,
                                       rank=self.rank, detail=reason)
                    except Exception:
                        pass
        return sorted(self._dead)

    def reasons(self):
        return dict(self._dead)

    def check(self):
        """Raise :class:`PeerDeadError` if any peer is dead."""
        dead = self.dead_peers()
        if dead:
            raise PeerDeadError(dead, "; ".join(
                f"rank {r}: {why}" for r, why in self.reasons().items()))


def surviving_ranks(hb_dir, num_ranks, timeout=None, self_rank=None):
    """Ranks whose beats are live RIGHT NOW — what a relaunched
    supervisor child reads to size its new world.  A rank with a fresh
    beat and a live pid survives; everything else is counted out.
    ``self_rank`` is always a survivor: the caller IS that rank's new
    incarnation, and the beat file its dead predecessor left behind
    must not count the caller out of its own world."""
    det = FailureDetector(hb_dir,
                          rank=-1 if self_rank is None
                          else int(self_rank),
                          num_ranks=num_ranks, timeout=timeout,
                          telemetry=False)
    det._t0 = 0.0  # no startup grace: a missing beat is a dead rank
    dead = set(det.dead_peers())
    return [r for r in range(int(num_ranks)) if r not in dead]


def elect_coordinator(survivors):
    """Coordinator election after a death: the LOWEST surviving rank
    takes the role (deterministic, no communication needed — every
    survivor reaches the same verdict from the same heartbeat dir).
    Returns (coordinator_rank, my_new_process_id_map) where the map
    renumbers survivors contiguously from 0 — the shape
    ``elastic_init`` needs for the shrunken world."""
    survivors = sorted(int(s) for s in survivors)
    if not survivors:
        raise MXNetError("elect_coordinator: no survivors")
    return survivors[0], {old: new for new, old in enumerate(survivors)}


# ------------------------------------------------- guarded collectives
class _GuardWorker:
    """One reusable daemon thread executing guarded callables: fit
    wraps every step when healing is armed, and spawning two fresh
    threads per millisecond-scale batch is measurable churn.  A
    worker abandoned mid-call (wedged collective) is simply never
    returned to the pool — the next guard takes a fresh one, the
    wedged daemon thread dies with the process."""

    def __init__(self):
        import queue as _queue

        self._q = _queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="mxnet_tpu_torch-guard", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn, result, error, done = self._q.get()
            try:
                result.append(fn())
            except BaseException as exc:  # noqa: BLE001 — re-raised
                error.append(exc)
            finally:
                done.set()

    def submit(self, fn):
        result, error, done = [], [], threading.Event()
        self._q.put((fn, result, error, done))
        return result, error, done

    @property
    def alive(self):
        return self._thread.is_alive()


_GUARD_POOL = {"worker": None}


def _take_guard_worker():
    w, _GUARD_POOL["worker"] = _GUARD_POOL["worker"], None
    if w is None or not w.alive:
        w = _GuardWorker()
    return w


def _return_guard_worker(w):
    if _GUARD_POOL["worker"] is None and w.alive:
        _GUARD_POOL["worker"] = w


def guard_collective(fn, detector, poll=0.05, timeout=None,
                     label="collective"):
    """Run ``fn()`` (a collective-bearing callable) on a worker thread
    while polling ``detector`` — the survivors' escape hatch from a
    wedged collective.

    * peer declared dead while waiting → :class:`PeerDeadError` raised
      HERE, the worker thread abandoned (daemon: a native call blocked
      on a dead peer's socket cannot be cancelled, only orphaned);
    * ``fn`` raises (gloo surfaces a connection reset) → re-checked
      against the detector: a confirmed death raises
      :class:`PeerDeadError` (chained), anything else re-raises as-is;
    * ``timeout`` seconds pass with every peer nominally alive →
      :class:`CollectiveTimeout` (None = wait for the detector alone).

    Returns ``fn()``'s result on the happy path.  The fast path costs
    one Event wait per poll interval; use at step granularity, not
    per-op.
    """
    worker = _take_guard_worker()
    result, error, done = worker.submit(fn)
    t0 = time.monotonic()
    while not done.wait(poll):
        dead = detector.dead_peers() if detector is not None else []
        if dead:
            # abandon: the worker (wedged in a native call against a
            # corpse) is NOT returned to the pool
            try:
                from .. import telemetry

                telemetry.heal("collective_abandon", detail=label,
                               peers=list(dead))
            except Exception:
                pass
            raise PeerDeadError(
                dead, f"abandoned wedged {label} (worker thread "
                "orphaned)")
        if timeout is not None and time.monotonic() - t0 > timeout:
            raise CollectiveTimeout(
                f"guarded {label} exceeded {timeout:.1f}s with all "
                "peers alive")
    _return_guard_worker(worker)
    if error:
        exc = error[0]
        if detector is not None:
            # a backend error (gloo connection-reset) usually BEATS
            # the liveness verdict by milliseconds: give the detector
            # a short confirmation window before deciding this was a
            # transient failure worth re-raising as-is.  The pid/
            # zombie probe confirms a same-host death on the first
            # poll; a genuine transient is delayed by at most ~1 s.
            t_err = time.monotonic()
            grace = min(max(detector.timeout, poll), 1.0)
            while True:
                dead = detector.dead_peers()
                if dead:
                    raise PeerDeadError(
                        dead,
                        f"{label} failed under a dead peer: {exc!r}"
                    ) from exc
                if time.monotonic() - t_err > grace:
                    break
                time.sleep(poll)
        raise exc
    return result[0]


# ------------------------------------------------ emergency checkpoint
# flushers that write the freshest host-side snapshot WITHOUT any
# collective — registered by CheckpointManager async writers and by
# fit's snapshot plumbing; fired by the failure detector's death path
# and the watchdog's abort escalation
_EMERGENCY = []
_EMERGENCY_LOCK = threading.Lock()


def register_emergency(fn):
    """Register ``fn(reason) -> path_or_None`` to run when an
    emergency checkpoint is needed (peer death, watchdog abort).
    Returns ``fn``; idempotent."""
    with _EMERGENCY_LOCK:
        if fn not in _EMERGENCY:
            _EMERGENCY.append(fn)
    return fn


def unregister_emergency(fn):
    with _EMERGENCY_LOCK:
        if fn in _EMERGENCY:
            _EMERGENCY.remove(fn)


def fire_emergency(reason):
    """Run every registered emergency flusher (exceptions swallowed —
    the healing exit must proceed even with a broken flusher); returns
    the paths written."""
    with _EMERGENCY_LOCK:
        hooks = list(_EMERGENCY)
    paths = []
    for fn in hooks:
        try:
            p = fn(reason)
            if p:
                paths.append(p)
        except Exception:
            pass
    if paths:
        try:
            from .. import telemetry

            telemetry.count("emergency_ckpts")
            telemetry.heal("emergency_ckpt", detail=reason,
                           paths=paths)
        except Exception:
            pass
    return paths


def heal_exit(reason, code=PEER_DEATH_EXIT_CODE):
    """The survivor's exit: emergency checkpoint from the freshest
    snapshot, flight dump, telemetry closed (run_end + final
    counters), then ``os._exit`` — not ``sys.exit``: tearing down a
    process group (``destroy_process_group``, the store's atexit) with
    a dead peer can block the interpreter's exit."""
    fire_emergency(reason)
    try:
        from .. import telemetry

        telemetry.flight_dump(f"heal:{reason}")
        telemetry.heal("heal_exit", detail=reason, code=int(code))
        telemetry.close()
    except Exception:
        pass
    os._exit(int(code))


# ------------------------------------------------------ session arming
_STATE = {"hb": None, "detector": None}


def arm(hb_dir, rank, num_ranks, timeout=None, interval=None):
    """Arm the process-wide healing session: start this rank's
    heartbeat and a failure detector over the peer set.  Module.fit
    polls the armed detector at step boundaries; :func:`poll` is the
    ambient accessor.  Idempotent per (dir, rank)."""
    hb = _STATE["hb"]
    det = _STATE["detector"]
    if hb is not None and det is not None \
            and hb.hb_dir == os.fspath(hb_dir) \
            and hb.rank == int(rank) \
            and det.num_ranks == int(num_ranks) \
            and (timeout is None or det.timeout == float(timeout)):
        return det  # identical world: idempotent.  A CHANGED world
        #             (num_ranks/timeout) re-arms — a detector still
        #             watching the old rank set would miss new peers'
        #             deaths entirely
    disarm()
    if interval is None and timeout is not None:
        # an EXPLICIT timeout must drive the beat cadence too: beating
        # at the env default's timeout/4 while detecting at a shorter
        # explicit timeout would make every fresh rank look stale —
        # systematic false deaths and relaunch churn
        interval = max(0.05, float(timeout) / 4)
    _STATE["hb"] = Heartbeater(hb_dir, rank, interval=interval)
    _STATE["detector"] = FailureDetector(hb_dir, rank, num_ranks,
                                         timeout=timeout)
    return _STATE["detector"]


def arm_from_env():
    """Arm from the environment when configured: ``MXNET_HEARTBEAT_DIR``
    set AND a live elastic context (or MXNET_NUM_PROCESSES) with more
    than one process.  Returns the detector or None — the fit-loop
    call site stays one cheap check when healing is off."""
    from ..config import get_env

    hb_dir = get_env("MXNET_HEARTBEAT_DIR")
    if not hb_dir:
        return _STATE["detector"]
    from . import elastic

    ctx = elastic.context()
    if ctx is not None:
        rank, n = ctx.process_id, ctx.num_processes
    else:
        n = int(get_env("MXNET_NUM_PROCESSES") or 0)
        rank = int(get_env("MXNET_PROCESS_ID"))
    if n <= 1:
        return _STATE["detector"]
    if not 0 <= rank < n:
        # MXNET_PROCESS_ID's registered default is -1 (unresolved):
        # arming with a bogus rank would beat as rank -1 while
        # watching ranks that never beat — every peer (and self)
        # falsely dead within one timeout.  Unresolved identity means
        # healing stays unarmed, loudly.
        import logging

        logging.getLogger("mxnet_tpu_torch").warning(
            "MXNET_HEARTBEAT_DIR set with %d processes but "
            "MXNET_PROCESS_ID=%d is not a valid rank — peer healing "
            "NOT armed", n, rank)
        return _STATE["detector"]
    return arm(hb_dir, rank, n)


def detector():
    """The armed FailureDetector, or None."""
    return _STATE["detector"]


def heartbeater():
    return _STATE["hb"]


def poll(step=None):
    """Step-boundary healing check: renew the beat (with the step
    number) and raise :class:`PeerDeadError` on a declared death.
    No-op (one dict lookup) when healing is unarmed."""
    det = _STATE["detector"]
    if det is None:
        return
    hb = _STATE["hb"]
    if hb is not None:
        hb.beat(step)
    det.check()


def disarm():
    hb, _STATE["hb"] = _STATE["hb"], None
    _STATE["detector"] = None
    if hb is not None:
        hb.close()


def session(hb_dir, rank, num_ranks, timeout=None, interval=None):
    """Context-manager form of :func:`arm`/:func:`disarm`."""
    class _S:
        def __enter__(self_s):
            return arm(hb_dir, rank, num_ranks, timeout=timeout,
                       interval=interval)

        def __exit__(self_s, *exc):
            disarm()
            return False

    return _S()


def relaunch_attempt():
    """Which supervisor relaunch attempt this process is (0 = the
    first launch).  Workers use it to decide whether to re-resolve
    their world from the surviving peers."""
    try:
        return int(os.environ.get("MXNET_HEAL_ATTEMPT", "0"))
    except ValueError:
        return 0


# ----------------------------------------------------------- supervisor
#: child exit statuses the supervisor treats as healable: a survivor's
#: deliberate heal_exit, any signal kill (SIGKILL'd rank, OOM), and
#: the faultsim crash code (a chaos-injected power loss)
def _healable(rc):
    return rc == PEER_DEATH_EXIT_CODE or rc < 0 \
        or rc == faultsim.CRASH_EXIT_CODE


def supervise(cmd, max_relaunch=None, env=None, healable=None):
    """Run ``cmd`` (argv list) under the respawn policy: a healable
    death relaunches it (``MXNET_HEAL_ATTEMPT`` exported, bumped per
    attempt; the ``heal.relaunch`` fault point fires before every
    respawn) up to ``max_relaunch`` times; any other status — success
    included — is final.  Returns the last exit status."""
    import subprocess

    from ..config import get_env

    if max_relaunch is None:
        max_relaunch = int(get_env("MXNET_HEAL_MAX_RELAUNCH"))
    healable = healable if healable is not None else _healable
    base_env = dict(os.environ if env is None else env)
    attempt = 0
    while True:
        run_env = dict(base_env)
        run_env["MXNET_HEAL_ATTEMPT"] = str(attempt)
        # per-relaunch trace stamp: each attempt gets its own child
        # context so tracemerge shows relaunches as distinct subtrees
        from ..telemetry import tracing

        tracing.stamp_env(run_env, run_env.get(tracing.ROLE_ENV)
                          or "worker", rank=attempt)
        rc = subprocess.call(list(cmd), env=run_env)
        if rc == 0 or not healable(rc) or attempt >= int(max_relaunch):
            if rc != 0 and healable(rc):
                try:
                    from .. import telemetry

                    telemetry.heal("relaunch_exhausted", code=rc,
                                   attempt=attempt)
                except Exception:
                    pass
            return rc
        attempt += 1
        try:
            faultsim.inject("heal.relaunch")
        except MXNetError:
            # the inherited spec names a point only the CHILD's
            # subsystem registers (e.g. a serving point): it is aimed at
            # the child, which validates the full spec at its own arm
            # time — a typo still fails loudly where the point lives.
            # FaultInjected is not an MXNetError, so an armed
            # heal.relaunch:raise fault still propagates.
            pass
        try:
            from .. import telemetry

            telemetry.count("heal_relaunches")
            telemetry.heal("relaunch", code=rc, attempt=attempt,
                           detail=" ".join(map(str, cmd))[:200])
        except Exception:
            pass


def main(argv=None):
    """``python -m mxnet_tpu_torch.resilience.healing --relaunch -- CMD...``"""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="mxnet_tpu_torch.resilience.healing",
        description="self-healing supervisor: respawn a training "
        "command on healable deaths (peer death, signal kill, "
        "injected crash)")
    ap.add_argument("--relaunch", action="store_true",
                    help="enable the respawn policy (without it the "
                    "command runs exactly once)")
    ap.add_argument("--max-relaunch", type=int, default=None,
                    help="bound on respawns (default "
                    "MXNET_HEAL_MAX_RELAUNCH)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- CMD ARGS... (the training command)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (pass it after --)")
    if not args.relaunch:
        import subprocess

        return subprocess.call(cmd)
    rc = supervise(cmd, max_relaunch=args.max_relaunch)
    return rc


if __name__ == "__main__":  # pragma: no cover — CLI shell
    import sys

    sys.exit(main())
