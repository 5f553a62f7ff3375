"""Process-wide run telemetry: the ``RunLog`` every subsystem reports
into (counterpart of ``mxnet_tpu/telemetry/runlog.py``, with the same
records, counters and files).

Four outputs, on one clock:

* **JSONL run log** (``MXNET_RUNLOG=path``): one record per step plus
  compile/checkpoint/program/event records — schema in
  :mod:`.schema`.  Step records are appended buffered and flushed on
  every sampled step (and every non-step record), so the tail a hard
  kill can lose is bounded by one sample period — and the flight
  recorder re-dumps exactly those last steps on every managed death
  path anyway.  Every complete line is valid JSON.
* **Chrome-trace lane**: when the profiler is collecting, every step/
  feed-wait/checkpoint span and the throughput/loss counters land in
  ``profiler.dump()``'s timeline (tid 7) next to the op events.
* **program introspection**: :func:`describe_program` runs a step once
  and records its memory (``torch.cuda`` statistics around the call),
  its products' FLOPs (``torch.utils.flop_counter`` plus the formulas
  of the hand-written kernels, which the counter cannot see) as a
  ``program_report``.
* **crash flight recorder**: a ring of the last
  ``MXNET_FLIGHTREC_DEPTH`` step records plus config/env/compile
  fingerprints, dumped through the resilience atomic writer on
  SIGTERM drain, NaN-abort, fault-injection crash, a watchdog stall or
  an unhandled exception inside ``Module.fit``.

Hot-path contract: with ``MXNET_RUNLOG`` unset, :func:`current` is two
dict lookups returning ``None`` and every wire point no-ops — no file
IO, no device syncs.  With it set, an unsampled step costs one dict
build + one list append: serialization, the buffered writes and the
flush syscall are deferred to the next sampled step (or the next
non-step record), and device syncs (loss readback) happen only every
``MXNET_TELEMETRY_SAMPLE`` steps.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

__all__ = ["RunLog", "current", "reset", "close", "compile_event",
           "compile_fingerprint", "event", "count", "gauge", "heal",
           "quantize", "freshness", "checkpoint_event",
           "program_report", "flight_dump", "describe_program",
           "describe_call", "kernel_flops", "flight_path_for",
           "find_flight_dumps"]

_LOCK = threading.RLock()
_STATE = {"log": None, "resolved": False}

#: set by telemetry.tracing at import: a zero-arg callable returning
#: the thread's current TraceContext (or None).  Kept as a module slot
#: instead of an import so runlog stays import-cycle-free; when absent
#: records are simply unstamped.
_TRACE_GETTER = None

#: fingerprint key -> the compile cause it maps to when it changes
_CAUSE_OF = {"shape": "shape", "dtype": "dtype", "train": "train_mode",
             "autotune": "autotune_winner", "hyper": "hyper_params",
             "sharding": "sharding"}

#: fixed Chrome-trace tid for the telemetry lane (op events use the
#: real thread ids, which are large — a small constant sorts first)
_TRACE_TID = 7


def _jsonable(v):
    """Coerce numpy/torch scalars and tuples so json.dumps never throws
    on a telemetry record (a logging layer must not kill the run)."""
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            pass
    return str(v)


def flight_path_for(runlog_path, pid=None):
    """The flight-recorder dump path for a run log, pid-suffixed so two
    processes armed with the same ``MXNET_RUNLOG`` path (supervisor +
    relaunched child, router + replica) keep their own post-mortems."""
    return f"{runlog_path}.flight.{os.getpid() if pid is None else pid}.json"


def find_flight_dumps(runlog_path):
    """Every flight dump paired with a run log, newest first — the
    pid-suffixed names plus the unsuffixed ``<runlog>.flight.json``
    older writers left.  Loaders glob through here instead of deriving one
    path, because the dump they want may belong to a DEAD child pid."""
    import glob as _glob

    found = _glob.glob(f"{runlog_path}.flight.*.json")
    legacy = f"{runlog_path}.flight.json"
    if os.path.exists(legacy):
        found.append(legacy)
    found.sort(key=lambda p: (os.path.getmtime(p), p), reverse=True)
    return found


def compile_fingerprint(shape, dtype, train, winners=None, hyper=None,
                        sharding="none"):
    """The canonical compile-event fingerprint.  Every program source
    (``make_train_step``, the gluon CachedOp, the servers) builds its
    fingerprint through here, so the keys :data:`_CAUSE_OF` diffs into
    retrace causes can never drift between them."""
    fp = {"shape": str(shape), "dtype": str(dtype),
          "train": bool(train),
          "autotune": {k: v for k, v in (winners or {}).items()
                       if v is not None},
          "sharding": sharding}
    if hyper is not None:
        fp["hyper"] = hyper
    return fp


class RunLog:
    """One run's telemetry sink (see module docstring)."""

    def __init__(self, path, sample=None, flight_depth=None,
                 textfile=None):
        from ..config import get_env

        self.path = os.fspath(path)
        self.sample = max(1, int(sample if sample is not None
                                 else get_env("MXNET_TELEMETRY_SAMPLE")))
        depth = int(flight_depth if flight_depth is not None
                    else get_env("MXNET_FLIGHTREC_DEPTH"))
        self.flight_depth = depth
        self.textfile = textfile if textfile is not None \
            else (get_env("MXNET_METRICS_TEXTFILE") or None)
        self._t0 = time.perf_counter()
        self._lock = threading.RLock()
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", buffering=1 << 16)
        self._pending = []
        self._ring = collections.deque(maxlen=depth) if depth > 0 \
            else None
        self.counters = {"steps": 0, "bad_steps": 0, "ps_retries": 0,
                         "faults": 0, "compiles": 0, "checkpoints": 0,
                         "h2d_bytes": 0, "feed_wait_s": 0.0,
                         "preempt_signals": 0, "watchdog_stalls": 0,
                         "ckpt_fallbacks": 0, "reshards": 0,
                         "dist_init_retries": 0, "serve_requests": 0,
                         "serve_shed": 0, "serve_batches": 0,
                         "serve_breaker_trips": 0,
                         "serve_tokens_total": 0,
                         "kv_evictions_total": 0,
                         "fleet_requests": 0, "fleet_shed": 0,
                         "fleet_failovers": 0, "fleet_resizes": 0,
                         "fleet_swaps": 0, "fleet_swap_rollbacks": 0,
                         "peer_deaths": 0,
                         "auto_reshards": 0, "ckpt_async_writes": 0,
                         "ckpt_async_errors": 0,
                         "emergency_ckpts": 0, "heal_relaunches": 0,
                         "data_records_skipped": 0,
                         "io_worker_respawns": 0, "io_resyncs": 0,
                         "online_exports": 0, "online_swaps": 0,
                         "online_swaps_shed": 0,
                         "online_relaunches": 0,
                         "freshness_violations": 0}
        self._gauges = {}       # name -> last value (textfile rows)
        self._fps = {}          # program -> last compile fingerprint
        self._programs = {}     # program -> last program_report body
        self._last_program = None
        self._ctx = {"sharding": "none"}
        self._recent = collections.deque(maxlen=64)  # (t, samples)
        self._last = {"loss": None, "samples_per_sec": None}
        self._closed = False
        start = {"type": "run_start", "time": time.time(),
                 "pid": os.getpid(), "parent_pid": os.getppid(),
                 "env": self._env_snapshot(),
                 "config": {"sample": self.sample,
                            "flight_depth": depth,
                            "textfile": self.textfile},
                 "torch": self._torch_snapshot()}
        # process identity: a spawner stamps who this process is, so
        # tracemerge can label its track group without guessing from
        # the filename
        role = os.environ.get("MXNET_PROCESS_ROLE")
        if role:
            start["role"] = str(role)
        rank = os.environ.get("MXNET_PROCESS_RANK")
        if rank is not None:
            try:
                start["rank"] = int(rank)
            except ValueError:
                pass
        self._write(start)

    # ------------------------------------------------------- plumbing
    @staticmethod
    def _env_snapshot():
        return {k: v for k, v in os.environ.items()
                if k.startswith(("MXNET_", "DMLC_", "CUDA_", "TORCH_",
                                 "PYTORCH_"))}

    @staticmethod
    def _torch_snapshot():
        """The torch and CUDA versions and the card (the reference
        records its JAX version and devices here)."""
        try:
            import torch

            snap = {"version": torch.__version__,
                    "cuda": torch.version.cuda, "devices": 0,
                    "device": None}
            if torch.cuda.is_available():
                snap["devices"] = torch.cuda.device_count()
                snap["device"] = torch.cuda.get_device_name(0)
            return snap
        except Exception:
            return {}

    def _now(self):
        return time.perf_counter() - self._t0

    def _write(self, rec, flush=True, raw=False):
        """Emit one record.  ``flush=False`` (unsampled steps) only
        queues the dict — serialization and IO are paid in batch at the
        next flushing record, keeping the hot path syscall-free.
        ``raw=True`` skips the ``_jsonable`` recursion for records
        built from known scalars (``default=str`` catches strays)."""
        # stamp the thread's trace context (when one is
        # bound and the record isn't already stamped) so EVERY record
        # type can join the cross-process timeline.  One TLS read on
        # an armed log; unarmed runs never reach _write at all.
        g = _TRACE_GETTER
        if g is not None and "trace_id" not in rec:
            ctx = g()
            if ctx is not None:
                rec["trace_id"] = ctx.trace_id
                rec["span_id"] = ctx.span_id
                if ctx.parent_span_id is not None:
                    rec["parent_span_id"] = ctx.parent_span_id
        if not raw:
            rec = _jsonable(rec)
        with self._lock:
            if self._closed:
                return
            if not flush:
                self._pending.append(rec)
                return
            try:
                if self._pending:
                    self._f.write("".join(
                        json.dumps(p, default=str) + "\n"
                        for p in self._pending))
                self._f.write(json.dumps(rec, default=str) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                pass  # a full disk must not kill the training run
            finally:
                self._pending.clear()

    def set_context(self, **ctx):
        """Sticky fields stamped onto every later step record (e.g.
        ``sharding='ps'`` from ``Module.init_optimizer``)."""
        self._ctx.update(ctx)

    def should_sync(self, step_no):
        """Whether this step is a sampled one (the caller pays one
        device sync to read loss/metrics)."""
        return step_no % self.sample == 0

    # ----------------------------------------------------------- step
    def step(self, epoch, batch, wall_s, samples, step_no=None,
             loss=None, synced=False, feed_wait_s=None, h2d_bytes=None,
             bad_step=False, sharding=None):
        """Record one training step.  ``feed_wait_s``/``h2d_bytes`` are
        DELTAS for this step (the fit session computes them from
        ``DeviceFeedIter.stats()`` snapshots)."""
        c = self.counters
        step_no = c["steps"] if step_no is None else int(step_no)
        c["steps"] += 1
        if bad_step:
            c["bad_steps"] += 1
        if feed_wait_s:
            c["feed_wait_s"] += float(feed_wait_s)
        if h2d_bytes:
            c["h2d_bytes"] += int(h2d_bytes)
        sps = (float(samples) / wall_s) if wall_s > 0 else None
        # collective accounting comes from the program driving these
        # steps: an explicit set_context(program=...) pin wins, else
        # the most recently traced program (the one a fit loop just
        # compiled), never an arbitrary stale report
        prog = self._programs.get(
            self._ctx.get("program") or self._last_program)
        coll = prog.get("collectives") if prog else None
        t = self._now()
        rec = {
            "type": "step", "t": round(t, 6), "epoch": int(epoch),
            "step": step_no, "batch": int(batch),
            "wall_ms": round(wall_s * 1e3, 4), "samples": int(samples),
            "samples_per_sec": round(sps, 3) if sps else None,
            "loss": float(loss) if loss is not None else None,
            "synced": bool(synced),
            "feed_wait_ms": round(feed_wait_s * 1e3, 4)
            if feed_wait_s is not None else None,
            "h2d_bytes": int(h2d_bytes) if h2d_bytes is not None
            else None,
            "collective_counts": dict(coll["counts"]) if coll else None,
            "collective_bytes": int(coll["total_bytes"]) if coll
            else None,
            "sharding": sharding if sharding is not None
            else self._ctx.get("sharding", "none"),
            "bad_step": bool(bad_step),
            "ps_retries": c["ps_retries"], "faults": c["faults"],
            "checkpoints": c["checkpoints"],
        }
        # hot path: the record is built from known scalars, so skip the
        # _jsonable recursion and only pay the flush syscall on sampled
        # steps (default=str catches any stray numpy scalar)
        self._write(rec, flush=synced, raw=True)
        if self._ring is not None:
            self._ring.append(rec)
        self._recent.append((t, samples))
        if loss is not None:
            self._last["loss"] = float(loss)
        if sps:
            self._last["samples_per_sec"] = sps
        self._trace_step(t, wall_s, feed_wait_s, sps, loss)
        if synced and self.textfile:
            self.write_textfile()
        return rec

    def _trace_step(self, t_end, wall_s, feed_wait_s, sps, loss):
        """Mirror the step onto the profiler's Chrome-trace timeline
        (one telemetry lane next to the op events)."""
        from .. import profiler

        if not profiler.is_running():
            return
        self._trace_meta()
        start = profiler.now_us() - wall_s * 1e6
        if feed_wait_s:
            profiler.record_span("feed_wait", "telemetry",
                                 start, feed_wait_s * 1e6,
                                 tid=_TRACE_TID)
        profiler.record_span(f"step {self.counters['steps'] - 1}",
                             "telemetry", start, wall_s * 1e6,
                             tid=_TRACE_TID)
        if sps:
            profiler.record_counter("throughput", round(sps, 2),
                                    cat="telemetry", tid=_TRACE_TID)
        if loss is not None:
            profiler.record_counter("loss", float(loss),
                                    cat="telemetry", tid=_TRACE_TID)

    def _trace_meta(self):
        from .. import profiler

        # once per profiler run WINDOW, not once per RunLog: a dump
        # (finished=True) drains the buffer, so the next window needs
        # its lane-name metadata re-emitted
        gen = profiler.run_generation()
        if getattr(self, "_trace_named_gen", None) != gen:
            profiler.record_meta("thread_name", {"name": "telemetry"},
                                 tid=_TRACE_TID)
            self._trace_named_gen = gen

    def recent_throughput(self, since=None):
        """samples/sec over the recent step window (the authoritative
        rate ``callback.Speedometer`` reads when telemetry is live).
        ``since`` (a ``time.perf_counter()`` stamp) restricts the
        window to steps recorded after it, so a reporting interval
        that opened mid-run (Speedometer's tic) is not diluted by an
        eval pass or the previous epoch's steps."""
        recent = list(self._recent)
        if since is not None:
            cut = since - self._t0
            recent = [(t, s) for t, s in recent if t >= cut]
        if len(recent) < 2:
            return None
        (t0, _), (t1, _) = recent[0], recent[-1]
        if t1 <= t0:
            return None
        n = sum(s for _, s in recent[1:])
        return n / (t1 - t0)

    # -------------------------------------------------- compile events
    def compile_event(self, program, fingerprint, cache="miss",
                      causes=None):
        """Record a program (re)trace.  ``fingerprint`` keys are diffed
        against the program's last one to derive the retrace causes:
        shape / dtype / train_mode / autotune_winner / hyper_params /
        sharding; the first trace of a program is ``first_trace``."""
        fingerprint = _jsonable(fingerprint)
        with self._lock:
            prev = self._fps.get(program)
            if causes is None:
                if prev is None:
                    causes = ["first_trace"]
                else:
                    keys = set(prev) | set(fingerprint)
                    causes = sorted(
                        {_CAUSE_OF.get(k, "program") for k in keys
                         if prev.get(k) != fingerprint.get(k)})
                    causes = causes or ["program"]
            self._fps[program] = fingerprint
            self.counters["compiles"] += 1
        rec = {"type": "compile", "t": round(self._now(), 6),
               "program": program, "cache": cache,
               "causes": list(causes), "fingerprint": fingerprint}
        self._write(rec)
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(f"compile:{program}", "telemetry",
                                    args={"causes": list(causes)},
                                    tid=_TRACE_TID)
        return rec

    # ------------------------------------------------- program reports
    def program_report(self, program, memory=None, flops=None,
                       bytes_accessed=None, collectives=None,
                       extra=None):
        body = {"memory": memory or {}, "flops": float(flops or 0.0),
                "bytes_accessed": float(bytes_accessed or 0.0),
                "collectives": collectives}
        if extra:
            body.update(extra)
        with self._lock:
            self._programs[program] = body
            self._last_program = program
        self._write({"type": "program_report",
                     "t": round(self._now(), 6), "program": program,
                     **body})
        return body

    # ------------------------------------------------------ checkpoint
    def checkpoint_event(self, prefix, version, duration_s, nbytes,
                         **extra):
        """One checkpoint write (or recovery — ``reason='fallback'``
        with the skipped bad versions rides in ``extra``).  A fallback
        is a recovery READ: it counts only ``ckpt_fallbacks`` (bumped
        by the caller), never the ``checkpoints`` write counter the
        step records carry."""
        if extra.get("reason") != "fallback":
            self.counters["checkpoints"] += 1
        self._write({"type": "checkpoint", "t": round(self._now(), 6),
                     "prefix": str(prefix), "version": int(version),
                     "duration_s": round(float(duration_s), 6),
                     "bytes": int(nbytes), **_jsonable(extra)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_span(
                "checkpoint", "telemetry",
                profiler.now_us() - duration_s * 1e6, duration_s * 1e6,
                args={"version": int(version), "bytes": int(nbytes)},
                tid=_TRACE_TID)

    # ------------------------------------------------ watchdog / stats
    def watchdog(self, phase, quiet_s, stack_path):
        """One hang-watchdog stall: the heartbeat went quiet for
        ``quiet_s`` during ``phase`` and an all-thread stack dump
        landed at ``stack_path`` (telemetry.watchdog fires this from
        its own thread — the stalled main thread cannot)."""
        self._write({"type": "watchdog", "t": round(self._now(), 6),
                     "phase": str(phase),
                     "quiet_s": round(float(quiet_s), 3),
                     "stack_path": str(stack_path)
                     if stack_path else None})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(
                "watchdog_stall", "telemetry",
                args={"phase": str(phase),
                      "quiet_s": round(float(quiet_s), 3)},
                tid=_TRACE_TID)

    def span(self, name, t0, t1, *, trace_id, span_id,
             parent_span_id=None, kind="internal", flush=True, **attrs):
        """One completed distributed-trace span (telemetry.tracing).
        ``t0``/``t1`` are ``time.perf_counter()`` readings; the record
        stores the run-relative END time plus ``dur_ms`` so
        tools/tracemerge.py reconstructs wall time from
        ``run_start.time``.  Hot emitters (the serve dispatch loop)
        pass ``flush=False`` — the spans queue behind the flushing
        ``serve`` record of the same batch, adding zero syscalls."""
        rec = {"type": "span", "t": round(t1 - self._t0, 6),
               "name": str(name), "kind": str(kind),
               "dur_ms": round((t1 - t0) * 1e3, 4),
               "trace_id": trace_id, "span_id": span_id,
               "parent_span_id": parent_span_id}
        if attrs:
            rec["attrs"] = _jsonable(attrs)
        self._write(rec, flush=flush, raw=True)
        return rec

    def serve(self, *, model, batch, padded_to, queue_depth,
              latency_ms, deadline_margin_ms=None, shed=0,
              breaker="closed"):
        """One dispatched serving microbatch (serving.ModelServer):
        live request count vs the bucketed padded shape, dispatch
        latency, queue depth left behind, the cumulative shed count
        and the breaker state — the per-batch row an SLO dashboard
        folds into p99s."""
        dur_s = float(latency_ms) / 1e3
        self._write({"type": "serve", "t": round(self._now(), 6),
                     "model": str(model), "batch": int(batch),
                     "padded_to": int(padded_to),
                     "queue_depth": int(queue_depth),
                     "latency_ms": round(float(latency_ms), 4),
                     "deadline_margin_ms":
                     round(float(deadline_margin_ms), 4)
                     if deadline_margin_ms is not None else None,
                     "shed": int(shed), "breaker": str(breaker)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_span(
                "serve_batch", "telemetry",
                profiler.now_us() - dur_s * 1e6, dur_s * 1e6,
                args={"batch": int(batch), "padded_to": int(padded_to),
                      "queue_depth": int(queue_depth)},
                tid=_TRACE_TID)
            profiler.record_counter("serve_queue_depth",
                                    int(queue_depth),
                                    cat="telemetry", tid=_TRACE_TID)

    def generate(self, *, name, tokens, tokens_s, ttft_p50_ms,
                 ttft_p99_ms, in_flight, max_in_flight, evictions,
                 shed, pages_in_use, queue_depth, kv_dtype, compiles):
        """One generative-serving snapshot
        (serving.generate.GenerativeServer.report): decode throughput,
        time-to-first-token percentiles, continuous-batching occupancy,
        paged-KV pool pressure and the cumulative eviction/shed
        counters — plus the post-warm compile count whose expected
        value under continuous batching is exactly zero."""
        self._write({"type": "generate", "t": round(self._now(), 6),
                     "name": str(name), "tokens": int(tokens),
                     "tokens_s": round(float(tokens_s), 4),
                     "ttft_p50_ms": round(float(ttft_p50_ms), 4)
                     if ttft_p50_ms is not None else None,
                     "ttft_p99_ms": round(float(ttft_p99_ms), 4)
                     if ttft_p99_ms is not None else None,
                     "in_flight": int(in_flight),
                     "max_in_flight": int(max_in_flight),
                     "evictions": int(evictions), "shed": int(shed),
                     "pages_in_use": int(pages_in_use),
                     "queue_depth": int(queue_depth),
                     "kv_dtype": str(kv_dtype),
                     "compiles": int(compiles)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_counter("serve_tokens_total", int(tokens),
                                    cat="telemetry", tid=_TRACE_TID)
            profiler.record_counter("kv_pages_in_use",
                                    int(pages_in_use),
                                    cat="telemetry", tid=_TRACE_TID)

    def fleet(self, *, action, replicas, ready, queue_depth,
              queue_ewma, requests, failovers, shed):
        """One fleet-router observation (serving.fleet.FleetRouter):
        the replica set's live/ready counts, the summed queue depth
        and its autoscaling EWMA, and the router's cumulative
        request/failover/shed counters — stamped with the ``action``
        (probe / eject / resize / swap / close) that produced it."""
        self._write({"type": "fleet", "t": round(self._now(), 6),
                     "action": str(action), "replicas": int(replicas),
                     "ready": int(ready),
                     "queue_depth": int(queue_depth),
                     "queue_ewma": round(float(queue_ewma), 4),
                     "requests": int(requests),
                     "failovers": int(failovers), "shed": int(shed)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_counter("fleet_queue_ewma",
                                    round(float(queue_ewma), 3),
                                    cat="telemetry", tid=_TRACE_TID)

    def heal(self, action, **fields):
        """One self-healing runtime observation (resilience.healing):
        a declared peer death, an abandoned collective, an emergency
        checkpoint flush, the survivor's heal_exit, a supervisor
        relaunch or the healed resume — stamped with the process's
        cumulative healing counters so a single record tells the
        whole story so far."""
        c = self.counters
        self._write({"type": "heal", "t": round(self._now(), 6),
                     "action": str(action),
                     "peer_deaths": int(c.get("peer_deaths", 0)),
                     "emergency_ckpts": int(c.get("emergency_ckpts",
                                                  0)),
                     "heal_relaunches": int(c.get("heal_relaunches",
                                                  0)),
                     "auto_reshards": int(c.get("auto_reshards", 0)),
                     **_jsonable(fields)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(
                f"heal:{action}", "telemetry",
                args=_jsonable(fields), tid=_TRACE_TID)

    def data_plane(self, action, *, workers=0, **fields):
        """One data-plane observation (io.ImageRecordIter and friends):
        a quarantined record, a worker-pool respawn or an epoch
        summary — stamped with the process's cumulative
        records-skipped / worker-respawn counters so a single record
        tells how shrunken the fed stream is so far."""
        c = self.counters
        self._write({"type": "data", "t": round(self._now(), 6),
                     "action": str(action), "workers": int(workers),
                     "skipped": int(c.get("data_records_skipped", 0)),
                     "respawns": int(c.get("io_worker_respawns", 0)),
                     **_jsonable(fields)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(
                f"data:{action}", "telemetry",
                args=_jsonable(fields), tid=_TRACE_TID)

    def quantize(self, action, *, mode="", layers=0, excluded=0,
                 **fields):
        """One quantized-inference pipeline observation
        (the quantization package): a calibration pass, a net rewrite,
        an adoption race or an export — which mode ran and how many
        layers it touched."""
        self._write({"type": "quantize", "t": round(self._now(), 6),
                     "action": str(action), "mode": str(mode),
                     "layers": int(layers), "excluded": int(excluded),
                     **_jsonable(fields)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(
                f"quantize:{action}", "telemetry",
                args=_jsonable(fields), tid=_TRACE_TID)

    def freshness(self, action, *, version=0, freshness_ms=None,
                  **fields):
        """One online-learning loop observation (the online-learning loop): a
        trainer export published, a rolling swap committed / shed /
        rolled back, a freshness-SLO violation or a supervisor
        relaunch — stamped with the artifact's monotonic model
        version, the measured sample-to-served latency and the loop's
        cumulative counters, so the run log alone proves version
        monotonicity and names every shed swap."""
        c = self.counters
        self._write({"type": "freshness", "t": round(self._now(), 6),
                     "action": str(action), "version": int(version),
                     "freshness_ms": (round(float(freshness_ms), 3)
                                      if freshness_ms is not None
                                      else None),
                     "exports": int(c.get("online_exports", 0)),
                     "swaps": int(c.get("online_swaps", 0)),
                     "swaps_shed": int(c.get("online_swaps_shed", 0)),
                     "violations": int(c.get("freshness_violations",
                                             0)),
                     "relaunches": int(c.get("online_relaunches", 0)),
                     **_jsonable(fields)})
        from .. import profiler

        if profiler.is_running():
            self._trace_meta()
            profiler.record_instant(
                f"freshness:{action}", "telemetry",
                args=_jsonable(fields), tid=_TRACE_TID)

    def opstats(self, rows, source="profiler"):
        """The aggregate per-op table (telemetry.opstats) as one
        ``program_report``-style record."""
        self._write({"type": "opstats", "t": round(self._now(), 6),
                     "source": str(source), "ops": len(rows),
                     "rows": rows})

    def tensor_stats(self, step, tensors, where="grad",
                     nonfinite=False, epoch=None):
        """One sampled numerics-monitor snapshot: per-tensor summary
        rows (l2/min/max/nan/inf/zero_frac) for named activations or
        gradients — the record that EXPLAINS a NaN step."""
        self._write({"type": "tensor_stats",
                     "t": round(self._now(), 6),
                     "step": int(step),
                     "epoch": int(epoch) if epoch is not None else None,
                     "where": str(where),
                     "nonfinite": bool(nonfinite),
                     "tensors": tensors})

    # ---------------------------------------------------------- events
    def event(self, kind, **fields):
        self._write({"type": "event", "t": round(self._now(), 6),
                     "kind": kind, **fields})

    def count(self, counter, delta=1):
        with self._lock:
            self.counters[counter] = \
                self.counters.get(counter, 0) + delta

    def gauge(self, name, value):
        """Set a point-in-time gauge (readiness/liveness, residency
        bytes...).  Gauges land in the Prometheus textfile next to the
        counters; a CHANGED value rewrites the textfile immediately so
        probes and scrapers read the same truth as the in-process
        health() that set it (state flips are rare — steady-state
        health polling costs one dict compare)."""
        value = float(value)
        with self._lock:
            changed = self._gauges.get(name) != value
            self._gauges[name] = value
        if changed and self.textfile:
            self.write_textfile()

    # -------------------------------------------------- flight recorder
    @property
    def flight_path(self):
        return flight_path_for(self.path)

    def flight_dump(self, reason):
        """Atomically write the flight-recorder snapshot: the last
        ``flight_depth`` step records plus config/env/compile
        fingerprints and counters.  Safe to call from crash paths (the
        fault-injection point is disabled so a ``ckpt.write`` fault
        spec cannot tear the post-mortem of its own crash)."""
        if self._ring is None:
            return None
        from ..resilience.checkpoint import atomic_write_bytes

        payload = _jsonable({
            "reason": reason, "time": time.time(), "pid": os.getpid(),
            "depth": self._ring.maxlen, "counters": dict(self.counters),
            "context": dict(self._ctx), "env": self._env_snapshot(),
            "programs": dict(self._fps),
            "program_reports": dict(self._programs),
            "steps": list(self._ring),
        })
        try:
            atomic_write_bytes(
                self.flight_path,
                json.dumps(payload, indent=1).encode(),
                inject_point=None)
        except OSError:
            return None
        self.event("flight_dump", reason=reason, path=self.flight_path)
        return self.flight_path

    # ------------------------------------------------ metrics textfile
    def write_textfile(self):
        """Prometheus-textfile export (node_exporter textfile collector
        convention), atomically rewritten so a scraper never reads a
        torn file."""
        if not self.textfile:
            return None
        from ..resilience.checkpoint import atomic_write_bytes

        lines = []
        for k, v in sorted(self.counters.items()):
            kind = "counter" if isinstance(v, int) else "gauge"
            lines.append(f"# TYPE mxnet_tpu_{k} {kind}")
            lines.append(f"mxnet_tpu_{k} {v}")
        # Prometheus-convention *_total counter aliases for the rates
        # dashboards actually graph: retraces (compile events), feed
        # wait seconds, and watchdog stalls
        for name, v in (("retrace_total", self.counters["compiles"]),
                        ("feed_wait_seconds_total",
                         self.counters["feed_wait_s"]),
                        ("watchdog_stalls_total",
                         self.counters["watchdog_stalls"])):
            lines.append(f"# TYPE mxnet_tpu_{name} counter")
            lines.append(f"mxnet_tpu_{name} {v}")
        for k, v in sorted(self._last.items()):
            if v is None:
                continue
            lines.append(f"# TYPE mxnet_tpu_{k} gauge")
            lines.append(f"mxnet_tpu_{k} {v}")
        # point-in-time gauges (serve_ready/serve_live readiness and
        # liveness rows the fleet's health probes also read).  Names
        # may carry Prometheus labels ('serve_ready{model="m"}') —
        # the TYPE line names the metric FAMILY, once
        with self._lock:
            gauges = dict(self._gauges)
        typed = set()
        for k, v in sorted(gauges.items()):
            family = k.split("{", 1)[0]
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE mxnet_tpu_{family} gauge")
            lines.append(f"mxnet_tpu_{k} "
                         f"{int(v) if v == int(v) else v}")
        try:
            atomic_write_bytes(self.textfile,
                               ("\n".join(lines) + "\n").encode(),
                               inject_point=None)
        except OSError:
            return None
        return self.textfile

    # ------------------------------------------------------------ close
    def close(self):
        with self._lock:
            if self._closed:
                return
            self._write({"type": "run_end", "t": round(self._now(), 6),
                         "counters": dict(self.counters)})
            if self.textfile:
                self.write_textfile()
            self._closed = True
            try:
                self._f.close()
            except OSError:
                pass


# -------------------------------------------------- module-level state
def current():
    """The active RunLog, or None.  The no-op fast exit: two dict
    lookups when ``MXNET_RUNLOG`` is unset."""
    if not _STATE["resolved"]:
        _resolve()
    return _STATE["log"]


def _resolve():
    with _LOCK:
        if _STATE["resolved"]:
            return
        from ..config import get_env

        path = get_env("MXNET_RUNLOG")
        log = None
        if path:
            try:
                log = RunLog(path)
            except Exception as e:  # noqa: BLE001 — logging layer
                # an unwritable run-log path or a bad telemetry knob
                # (MXNET_TELEMETRY_SAMPLE=twenty) disables telemetry
                # with a warning — it must not kill every forward/
                # step/fit that touches a wire point
                import warnings

                warnings.warn(f"MXNET_RUNLOG={path!r} unusable ({e}); "
                              "telemetry disabled", stacklevel=3)
        _STATE["log"] = log
        _STATE["resolved"] = True


def reset(path=None):
    """Close any active log and re-resolve — from ``path`` when given,
    else from ``MXNET_RUNLOG`` (tests and bench arm telemetry at a
    precise point rather than at import)."""
    with _LOCK:
        if _STATE["log"] is not None:
            _STATE["log"].close()
        _STATE["log"] = None
        _STATE["resolved"] = False
        if path is not None:
            _STATE["log"] = RunLog(path)
            _STATE["resolved"] = True
    return _STATE["log"]


def close():
    with _LOCK:
        if _STATE["log"] is not None:
            _STATE["log"].close()
        _STATE["log"] = None
        _STATE["resolved"] = False


# --------------------------------------- convenience no-op-safe wrappers
def compile_event(program, fingerprint, cache="miss", causes=None):
    rl = current()
    if rl is not None:
        rl.compile_event(program, fingerprint, cache=cache,
                         causes=causes)


def event(kind, **fields):
    rl = current()
    if rl is not None:
        rl.event(kind, **fields)


def count(counter, delta=1):
    rl = current()
    if rl is not None:
        rl.count(counter, delta)


def gauge(name, value):
    rl = current()
    if rl is not None:
        rl.gauge(name, value)


def heal(action, **fields):
    rl = current()
    if rl is not None:
        rl.heal(action, **fields)


def data_plane(action, *, workers=0, **fields):
    rl = current()
    if rl is not None:
        rl.data_plane(action, workers=workers, **fields)


def quantize(action, *, mode="", layers=0, excluded=0, **fields):
    rl = current()
    if rl is not None:
        rl.quantize(action, mode=mode, layers=layers,
                    excluded=excluded, **fields)


def generate(**fields):
    rl = current()
    if rl is not None:
        rl.generate(**fields)


def freshness(action, *, version=0, freshness_ms=None, **fields):
    rl = current()
    if rl is not None:
        rl.freshness(action, version=version,
                     freshness_ms=freshness_ms, **fields)


def checkpoint_event(prefix, version, duration_s, nbytes, **extra):
    rl = current()
    if rl is not None:
        rl.checkpoint_event(prefix, version, duration_s, nbytes,
                            **extra)


def program_report(program, **kw):
    rl = current()
    if rl is not None:
        rl.program_report(program, **kw)


def flight_dump(reason):
    rl = current()
    if rl is not None:
        return rl.flight_dump(reason)
    return None


# --------------------------------------------- program introspection
#: FLOPs the hand-written kernels report while :func:`describe_call`
#: counts (None when nothing counts: one check per launch)
_KERNEL_FLOPS = {"total": None}


def kernel_flops(n):
    """Add ``n`` to the FLOP count of the program being described.
    Called by a kernel wrapper where it launches a kernel that does
    products ``FlopCounterMode`` cannot see (a ctypes launch is no aten
    op); its formula is the one of the plain version's products."""
    if _KERNEL_FLOPS["total"] is not None:
        _KERNEL_FLOPS["total"] += int(n)


def _tensors(tree, seen=None):
    """Every distinct tensor in a nested dict/list/tuple (by storage
    and offset, so views of one flat bucket count once each)."""
    import torch

    seen = {} if seen is None else seen
    if isinstance(tree, torch.Tensor):
        key = (tree.untyped_storage().data_ptr(), tree.storage_offset(),
               tuple(tree.shape), tree.dtype)
        seen.setdefault(key, tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, seen)
    return seen


def _nbytes(tree):
    return sum(t.numel() * t.element_size()
               for t in _tensors(tree).values())


def describe_call(fn, *args, program="program", record=True, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, observed: returns ``(result,
    report)``.

    The reference compiles its step and asks XLA
    (``memory_analysis``/``cost_analysis``); an eager step has no
    program to ask, so the port measures the call itself:

    * ``memory``: ``argument_bytes`` (every distinct tensor of the
      arguments: parameters, optimizer state, batch), ``output_bytes``
      (the result's tensors) and, on a card, ``temp_bytes`` (the
      ``torch.cuda`` peak during the call less what was allocated at
      its start) and ``peak_bytes`` (that peak);
    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
      the call's aten products (convolutions and matmuls, forward and
      backward) plus what the hand-written kernels report through
      :func:`kernel_flops`;
    * ``bytes_accessed`` 0.0 (no backend reports it, as the reference
      writes when XLA gives none) and ``collectives`` None (one card).

    A ``program_report`` goes to the active RunLog when ``record``.
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    dev = None
    for t in _tensors(args).values():
        if t.is_cuda:
            dev = t.device
            break
    arg_bytes = _nbytes((args, kwargs))
    base = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    _KERNEL_FLOPS["total"] = 0
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            result = fn(*args, **kwargs)
        flops = float(counter.get_total_flops() + _KERNEL_FLOPS["total"])
    finally:
        _KERNEL_FLOPS["total"] = None
    memory = {"argument_bytes": int(arg_bytes),
              "output_bytes": int(_nbytes(result))}
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        memory["temp_bytes"] = int(max(0, peak - base))
        memory["peak_bytes"] = int(peak)
    report = {"program": program, "memory": memory, "flops": flops,
              "bytes_accessed": 0.0, "collectives": None}
    if record:
        rl = current()
        if rl is not None:
            rl.program_report(program, memory=memory, flops=flops,
                              bytes_accessed=0.0, collectives=None)
    return result, report


def describe_program(fn, *args, program="program", record=True, **kwargs):
    """The reference's entry point: :func:`describe_call` of one call
    of ``fn``, returning the report (the call's result is dropped; a
    caller that needs it calls :func:`describe_call`)."""
    return describe_call(fn, *args, program=program, record=record,
                         **kwargs)[1]
