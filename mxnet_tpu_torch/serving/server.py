"""Continuous-batching model server with deadline-aware admission
control, load shedding and a warm start from deploy artifacts
(counterpart of ``mxnet_tpu/serving/server.py``).

* **Request queue + continuous batcher.**  ``submit()`` enqueues one
  sample; a batcher thread coalesces whatever is queued the moment the
  model frees up (plus a tiny ``coalesce_ms`` window while the batch is
  below the largest bucket), so batch size follows live queue depth.
  Batches are padded to a small set of **bucketed batch shapes**
  (powers of two up to ``max_batch`` by default), so the model sees at
  most ``len(buckets)`` distinct shapes: ``stats["warm_traces"]`` counts
  the first dispatch of each at warm-up, ``stats["retraces"]`` after it.

* **Deadline-aware admission control.**  Every request carries a
  deadline (``deadline_ms`` or the ``MXNET_SERVE_SLO_MS`` SLO).
  Admission estimates completion from a per-bucket latency EWMA and the
  queue depth and sheds — a fast structured :class:`ServeRejected`,
  never a silent hang — when the deadline cannot be met
  (``'deadline'``), the queue is full (``'queue_full'``) or the breaker
  is open (``'breaker_open'``).  Transient model faults are retried
  through :func:`~mxnet_tpu_torch.resilience.retry.retry_call` inside
  the batch's tightest deadline; at dispatch the deadline is checked
  again and a request that can no longer finish is shed (``'expired'``).

* **Graceful degradation + health.**  :meth:`ModelServer.health` serves
  readiness/liveness; :meth:`ModelServer.run_until_drained` rides
  :class:`~mxnet_tpu_torch.resilience.preempt.PreemptionDrain`, so
  SIGTERM finishes admitted requests, rejects new ones (``'draining'``)
  and exits clean.  A **circuit breaker** trips after
  ``MXNET_SERVE_BREAKER_LIMIT`` consecutive model failures (exceptions
  or non-finite outputs); while open, requests get fast rejections and
  the batcher re-warms on probe batches; a probe success closes it.

* **The card.**  ``model_fn`` takes and returns numpy, as in the
  reference.  :meth:`ModelServer.from_artifact` (a ``deploy``
  artifact's graph) and :meth:`ModelServer.from_predictor` (a
  functionalized forward through the tuned micro-batch predictor) run
  their model on a device through a runner that captures **one CUDA
  graph per padded batch shape** (PR 14's ``gluon/_graph.py``), so
  ``start(warm=True)`` captures every bucket before ``ready()`` turns
  true and the first request never pays a capture.  Request rows are
  stacked into a pinned host buffer per bucket, copied to the card with
  ``non_blocking=True`` on the server's own CUDA stream, and the output
  comes back with one device-to-host copy a batch.  A capture of
  another server (a swap warming its new model) waits for the running
  batch and the next batch waits for it (``_graph.device_lock``).  A
  model that fails on the card is a model failure; it never reruns on
  the host.

* **Telemetry.**  With ``MXNET_RUNLOG`` set every dispatched batch
  writes a ``serve`` record, each new padded bucket of a server that can
  retrace a ``compile`` record (a loaded artifact cannot: its run log
  keeps ``compiles == 0``), and a request submitted under a trace
  context (the frontend's ``traceparent``) gets its ``serve_queue``,
  ``serve_coalesce`` and ``serve_model`` spans; counters, events and
  the readiness gauges land in the run log and its textfile.  A hang
  watchdog (``watchdog_sec`` / ``MXNET_WATCHDOG_SEC``) is beaten by the
  batcher.

Fault points: ``serve.admit`` (inside every admission decision),
``serve.batch`` (before each dispatched microbatch), ``serve.model``
(inside every model invocation).
"""
from __future__ import annotations

import collections
import math
import os
import threading
import time

import numpy as onp

from ..base import MXNetError
from ..resilience import faultsim
from ..resilience.retry import retry_call
from ..telemetry import tracing as _tracing

__all__ = ["ModelServer", "ServeHandle", "ServeRejected",
           "default_buckets"]

faultsim.register_point(
    "serve.admit", "serving admission decision (ModelServer.submit, "
                   "GenerativeServer.submit)")
faultsim.register_point(
    "serve.batch", "serving batcher, before each dispatched microbatch")
faultsim.register_point(
    "serve.model", "inside every serving model invocation "
                   "(delay=slow model, raise=transient failure, "
                   "nan=poisoned outputs, crash=hard death)")


def default_buckets(max_batch, step=1):
    """Power-of-two batch buckets ``(step, 2*step, ..., max_batch)`` —
    the small closed set of padded shapes that bounds retraces."""
    max_batch = int(max_batch)
    step = max(1, int(step))
    if max_batch < step or max_batch % step:
        raise MXNetError(
            f"max_batch {max_batch} not a multiple of bucket step "
            f"{step}")
    out = []
    b = step
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


class ServeRejected(MXNetError):
    """Structured rejection — the load-shedding contract: a request
    the server cannot serve fails fast with a machine-readable
    ``reason``, it never hangs.

    Reasons: ``queue_full``, ``deadline`` (admission estimate misses
    the SLO), ``expired`` (dispatch-time re-check), ``breaker_open``,
    ``draining``, ``shutdown``, ``model_error``; the generative server
    adds ``token_budget``; the fleet layer (:mod:`.fleet`) adds
    ``hbm_budget`` (model residency would exceed the host's device
    memory budget)."""

    def __init__(self, reason, detail=""):
        msg = f"request rejected ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason
        self.detail = detail


class ServeHandle:
    """Future-style handle ``submit()`` returns for an ADMITTED
    request (rejections raise :class:`ServeRejected` synchronously)."""

    __slots__ = ("_ev", "_out", "_err", "t_submit", "t_done",
                 "deadline")

    def __init__(self, deadline, t_submit):
        self._ev = threading.Event()
        self._out = None
        self._err = None
        self.t_submit = t_submit
        self.t_done = None
        self.deadline = deadline

    def _finish(self, out=None, err=None):
        if self._ev.is_set():
            return  # first terminal state wins
        self.t_done = time.monotonic()
        self._out = out
        self._err = err
        self._ev.set()

    @property
    def done(self):
        return self._ev.is_set()

    @property
    def ok(self):
        return self._ev.is_set() and self._err is None

    @property
    def latency_ms(self):
        """Submit-to-completion latency, or None while in flight."""
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def result(self, timeout=None):
        """The model output row (numpy) — or the structured error the
        request finished with.  ``timeout`` bounds the caller-side
        wait only; an un-finished request past it raises (the server
        itself never leaves admitted work unfinished)."""
        if not self._ev.wait(timeout):
            raise MXNetError(
                f"serve result not ready within {timeout}s "
                "(caller-side wait bound)")
        if self._err is not None:
            raise self._err
        return self._out


class _Request:
    __slots__ = ("x", "deadline", "t_submit", "handle", "trace",
                 "t_submit_pc")

    def __init__(self, x, deadline, t_submit, handle, trace=None,
                 t_submit_pc=None):
        self.x = x
        self.deadline = deadline
        self.t_submit = t_submit
        self.handle = handle
        # the trace context captured at submit: None on an untraced
        # request, for which the dispatch loop emits no spans
        self.trace = trace
        self.t_submit_pc = t_submit_pc


def _torch_dtype(dtype):
    """The torch dtype of a numpy dtype."""
    import torch

    return torch.from_numpy(onp.empty(0, dtype)).dtype


class _DeviceRunner:
    """A ``model_fn`` over a torch forward ``fn`` (a tensor batch on
    ``device`` in, a tensor batch out): numpy in, numpy out.

    On the card each batch runs on the runner's own CUDA stream, holding
    ``_graph.device_lock`` shared: the rows are read from a pinned host
    buffer per batch shape (:meth:`host_batch` lends it to the batcher,
    which stacks the rows straight into it), copied to the card with
    ``non_blocking=True``, and the output comes back through a pinned
    buffer, one device-to-host copy a batch, waited for on that stream
    alone.  On the host the forward runs on the batch as it is."""

    def __init__(self, fn, device):
        import torch

        self._fn = fn
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self._host_in = {}   # (shape, dtype) -> pinned input tensor
        self._host_out = {}  # (shape, dtype) -> pinned output tensor

    def _pinned(self, cache, shape, dtype):
        import torch

        key = (tuple(shape), dtype)
        buf = cache.get(key)
        if buf is None:
            buf = cache[key] = torch.empty(shape, dtype=dtype,
                                           pin_memory=True)
        return buf

    def host_batch(self, shape, dtype):
        """The pinned host buffer (as a numpy array) a batch of
        ``shape`` is stacked into, or None on the host."""
        from ..gluon._graph import device_lock

        if not self._cuda:
            return None
        with device_lock.shared():
            return self._pinned(self._host_in, shape,
                                _torch_dtype(dtype)).numpy()

    def __call__(self, xb):
        import torch

        from ..gluon._graph import device_lock

        xb = onp.ascontiguousarray(xb)
        if not self._cuda:
            with torch.no_grad():
                return self._one(self._fn(torch.from_numpy(xb))).numpy()
        with device_lock.shared(), torch.cuda.device(self.device):
            src = torch.from_numpy(xb)
            buf = self._pinned(self._host_in, xb.shape, src.dtype)
            if buf.data_ptr() != xb.ctypes.data:
                buf.copy_(src)
            with torch.cuda.stream(self._stream), torch.no_grad():
                out = self._one(self._fn(buf.to(self.device,
                                                non_blocking=True)))
                host = self._pinned(self._host_out, out.shape, out.dtype)
                host.copy_(out, non_blocking=True)
            self._stream.synchronize()
            return host.numpy().copy()

    @staticmethod
    def _one(out):
        """The one output of a served forward; a bfloat16 or float8 one
        (an AMP-converted net's logits) as float32, numpy's widening."""
        import torch

        if isinstance(out, (list, tuple)):
            if len(out) != 1:
                raise MXNetError(
                    f"a served model returns one output, not {len(out)}")
            out = out[0]
        if out.is_floating_point() and out.element_size() < 4 \
                and out.dtype != torch.float16:
            out = out.float()
        return out


class ModelServer:
    """In-process continuous-batching model server (module docstring).

    Parameters
    ----------
    model_fn : callable
        ``model_fn(x_batch: np.ndarray[(b,)+item_shape]) -> array
        [(b, ...)]`` — any batch-in/batch-out callable (the
        constructors below make one that runs on the card).  Must accept
        every bucket size in ``buckets``.
    item_shape : tuple
        Per-request sample shape (no batch axis).
    dtype : str
        Sample dtype requests are coerced to.
    max_batch / buckets
        The padded batch shapes: ``buckets`` wins when given, else
        ``default_buckets(max_batch)``.
    slo_ms / queue_depth / max_inflight / breaker_limit
        Override the ``MXNET_SERVE_*`` knobs (None = registry value).
    coalesce_ms : float
        How long the batcher waits for more arrivals while the batch
        is below the largest bucket.
    watchdog_sec : float or None
        The hang watchdog (None follows ``MXNET_WATCHDOG_SEC``; 0 is
        off): the batcher beats it, a quiet heartbeat dumps every
        thread's stack.
    aot : bool
        True when ``model_fn`` runs a program loaded from an artifact
        (the ``from_artifact`` path).
    """

    def __init__(self, model_fn, item_shape, dtype="float32", *,
                 max_batch=8, buckets=None, slo_ms=None,
                 queue_depth=None, max_inflight=None,
                 breaker_limit=None, coalesce_ms=2.0,
                 watchdog_sec=None, name="model", aot=False):
        from ..config import get_env

        self._model_fn = model_fn
        self.item_shape = tuple(int(s) for s in item_shape)
        self.dtype = onp.dtype(dtype)
        self.buckets = tuple(sorted({int(b) for b in buckets})) \
            if buckets else default_buckets(max_batch)
        if self.buckets[0] < 1:
            raise MXNetError(f"bad bucket sizes {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.slo_ms = float(slo_ms if slo_ms is not None
                            else get_env("MXNET_SERVE_SLO_MS"))
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else get_env("MXNET_SERVE_QUEUE_DEPTH"))
        mi = int(max_inflight if max_inflight is not None
                 else get_env("MXNET_SERVE_MAX_INFLIGHT"))
        self.max_inflight = mi if mi > 0 \
            else self.queue_depth + self.max_batch
        self.breaker_limit = int(
            breaker_limit if breaker_limit is not None
            else get_env("MXNET_SERVE_BREAKER_LIMIT"))
        self.coalesce_s = max(0.0, float(coalesce_ms) / 1e3)
        self.name = str(name)
        self.aot = bool(aot)

        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._running = False
        self._accepting = False
        self._draining = False
        self._ready = False
        self._inflight = 0          # admitted, not yet terminal
        self._batch_running = False
        self._thread = None
        self._watchdog_sec = watchdog_sec
        self._wd = None
        self._t_take_pc = None  # coalesce-start mark for trace spans
        self._hb = time.monotonic()
        self._ewma = {}             # bucket -> seconds
        self._ewma_alpha = 0.3
        self._breaker = "closed"
        self._consecutive_failures = 0
        self._probe_s = 0.05
        self._next_probe = 0.0
        self._traced = set()        # padded shapes already dispatched
        self._warm_start_s = None
        self.stats = {
            "requests": 0, "admitted": 0, "completed": 0, "shed": 0,
            "rejected": {}, "expired": 0, "batches": 0,
            "padded_rows": 0, "model_failures": 0, "breaker_trips": 0,
            "retraces": 0, "warm_traces": 0,
        }

    # ----------------------------------------------------- constructors
    @classmethod
    def from_artifact(cls, path, exported=None, ctx=None, **kw):
        """Serve a CRC-verified ``deploy.export_model`` artifact on
        ``ctx`` (default: the current context, ``gpu(0)``).  The
        artifact fixes ONE batch shape, so the bucket set is exactly
        that shape (all batches pad to it): one captured graph, made at
        warm start.  ``exported`` reuses an already-verified
        ``deploy.load_exported`` handle (the fleet's admission sized the
        artifact moments ago — no second read)."""
        from .. import deploy

        exp = exported if exported is not None \
            else deploy.load_exported(path, ctx=ctx)
        aval = exp.in_avals[0]
        batch = int(aval.shape[0])
        item = tuple(int(s) for s in aval.shape[1:])
        kw.setdefault("name", os.path.basename(str(path)))
        kw.setdefault("buckets", (batch,))
        srv = cls(_DeviceRunner(exp.call, exp.device), item,
                  dtype=str(aval.dtype), aot=True, **kw)
        srv.exported = exp
        return srv

    @classmethod
    def from_predictor(cls, apply_fn, params, example_batch, *,
                       candidates=(1, 2, 4), tune_iters=6, **kw):
        """Serve a functionalized forward (``parallel.functionalize``'s
        ``apply_fn(params, x)``), seeded by the persisted
        ``tune_microbatch`` winners: the micro-batch race runs (or
        reloads its cached winner) for ``example_batch``'s shape on the
        params' device, and the server's batches run
        through the winning chunked predictor, one captured graph per
        bucket on the card.  Buckets are the winner-chunk multiples up
        to the example batch size, so every padded batch divides."""
        import torch

        from ..parallel.predict import (_leaves, make_predict_fn,
                                        tune_microbatch)

        device = next(leaf.device for leaf in _leaves(params)
                      if isinstance(leaf, torch.Tensor))
        ex = torch.as_tensor(onp.asarray(example_batch), device=device)
        max_batch = int(ex.shape[0])
        (k, unroll), _ = tune_microbatch(
            apply_fn, params, ex, candidates=candidates,
            iters=tune_iters)
        predict = make_predict_fn(apply_fn, microbatch=k,
                                  unroll=unroll)
        kw.setdefault("buckets", default_buckets(max_batch, step=k))
        srv = cls(_DeviceRunner(lambda xb: predict(params, xb), device),
                  tuple(ex.shape[1:]),
                  dtype=str(ex.dtype).replace("torch.", ""), **kw)
        srv.microbatch = (k, unroll)
        return srv

    # ---------------------------------------------------------- control
    def start(self, warm=True):
        """Start the batcher.  ``warm=True`` runs every bucket once on
        dummy data BEFORE the server reports ready (on the card: one
        capture per bucket): initial latency EWMAs are seeded and every
        capture is paid up front, so the first real request never
        waits for one."""
        with self._cond:
            if self._thread is not None:
                raise MXNetError(f"server {self.name!r} already "
                                 "started")
            self._running = True
        t0 = time.perf_counter()
        if warm:
            self._warmup()
        self._warm_start_s = time.perf_counter() - t0
        wd_sec = self._watchdog_sec
        if wd_sec is None:
            from ..telemetry.watchdog import default_timeout

            wd_sec = default_timeout()
        if wd_sec and wd_sec > 0:
            from ..telemetry.watchdog import Watchdog

            self._wd = Watchdog(timeout=wd_sec).arm("serve")
        self._thread = threading.Thread(
            target=self._loop, name=f"mxnet_tpu_torch-serve-{self.name}",
            daemon=True)
        self._thread.start()
        with self._cond:
            self._accepting = True
            self._ready = True
        self._telemetry_event(
            "serve_start", model=self.name, aot=self.aot,
            buckets=list(self.buckets),
            warm_start_s=round(self._warm_start_s, 4),
            slo_ms=self.slo_ms)
        return self

    def _warmup(self):
        for b in self.buckets:
            xb = onp.zeros((b,) + self.item_shape, self.dtype)
            out = onp.asarray(self._model_fn(xb))
            if out.shape[0] != b:
                raise MXNetError(
                    f"model_fn returned leading axis {out.shape[0]} "
                    f"for batch {b} — serving needs batch-in/"
                    "batch-out")
            self._note_shape(xb.shape, warm=True)
            # the first pass includes any capture; a second call measures
            # the steady-state latency the EWMA starts from, for a loaded
            # artifact too (the reference skips it there, so its EWMA
            # starts at the first call's compile of the loaded program;
            # ROADMAP "Caution")
            t0 = time.perf_counter()
            self._model_fn(xb)
            self._ewma[b] = time.perf_counter() - t0

    def drain(self, timeout=30.0):
        """Stop admitting (new submits get ``'draining'``), then wait
        until every already-admitted request reaches a terminal state.
        Returns True when fully drained inside ``timeout``."""
        with self._cond:
            self._draining = True
            self._accepting = False
            self._ready = False
            self._cond.notify_all()
        with self._cond:
            # _inflight counts every admitted-not-terminal request,
            # including a batch the batcher has popped but not yet
            # marked running; _finish notifies on every terminal request
            drained = self._cond.wait_for(
                lambda: self._inflight == 0, timeout=float(timeout))
        self._telemetry_event("serve_drain", model=self.name,
                              drained=drained,
                              completed=self.stats["completed"])
        return drained

    def close(self):
        """Stop the batcher.  Queued (undrained) requests fail with
        ``'shutdown'`` — terminal state always, silent hang never."""
        with self._cond:
            self._accepting = False
            self._running = False
            self._ready = False
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for r in pending:
            self._finish(r, err=ServeRejected(
                "shutdown", "server closed with the request queued"))
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        if self._wd is not None:
            self._wd.close()
            self._wd = None

    def run_until_drained(self, poll=0.05, on_drained=None):
        """Serve on the calling (main) thread until SIGTERM/SIGINT,
        then drain and exit clean: in-flight admitted work finishes,
        new requests are rejected, ``on_drained(server)`` runs, and the
        signal is re-raised under its original disposition."""
        from ..resilience.preempt import PreemptionDrain

        with PreemptionDrain() as pd:
            while pd.requested is None:
                with self._cond:
                    if not self._running:
                        break
                time.sleep(poll)
            if pd.requested is not None:
                self._telemetry_event("serve_preempt",
                                      model=self.name,
                                      signum=int(pd.requested))
            self.drain()
            self.close()
            if on_drained is not None:
                on_drained(self)
            pd.reraise()

    # -------------------------------------------------------- admission
    def submit(self, x, deadline_ms=None):
        """Admit one request (returns a :class:`ServeHandle`) or shed
        it (raises :class:`ServeRejected` — fast and structured).

        ``deadline_ms`` is relative to now; None uses the
        ``MXNET_SERVE_SLO_MS`` SLO.  Admission sheds when the queue
        bound, the in-flight bound, the open breaker, or the
        EWMA-estimated completion time says the deadline cannot be
        met."""
        faultsim.inject("serve.admit")
        now = time.monotonic()
        budget_ms = self.slo_ms if deadline_ms is None \
            else float(deadline_ms)
        deadline = now + budget_ms / 1e3
        x = onp.asarray(x, self.dtype)
        if x.shape == (1,) + self.item_shape:
            x = x[0]
        if x.shape != self.item_shape:
            raise MXNetError(
                f"request shape {x.shape} != item shape "
                f"{self.item_shape} (one sample per submit)")
        with self._cond:
            self.stats["requests"] += 1
            self._telemetry_count("serve_requests")
            if not self._accepting:
                reason = "draining" if self._draining else "shutdown"
                self._shed_locked(reason)
            if self._breaker == "open":
                self._shed_locked(
                    "breaker_open",
                    f"{self._consecutive_failures} consecutive model "
                    "failures; re-warming")
            if len(self._queue) >= self.queue_depth:
                self._shed_locked(
                    "queue_full", f"queue depth {len(self._queue)} >= "
                                  f"{self.queue_depth}")
            if self._inflight >= self.max_inflight:
                self._shed_locked(
                    "queue_full",
                    f"inflight {self._inflight} >= "
                    f"{self.max_inflight}")
            est = self._estimate_wait_locked()
            if est is not None and now + est > deadline:
                self._shed_locked(
                    "deadline",
                    f"estimated completion +{est * 1e3:.1f} ms "
                    f"exceeds deadline +{budget_ms:.1f} ms")
            h = ServeHandle(deadline, now)
            trace = t_pc = None
            if _tracing.enabled():
                trace = _tracing.current_context()
                if trace is not None:
                    t_pc = time.perf_counter()
            self._queue.append(_Request(x, deadline, now, h, trace,
                                        t_pc))
            self._inflight += 1
            self.stats["admitted"] += 1
            self._cond.notify_all()
        return h

    def _shed_locked(self, reason, detail=""):
        self.stats["shed"] += 1
        by = self.stats["rejected"]
        by[reason] = by.get(reason, 0) + 1
        self._telemetry_count("serve_shed")
        raise ServeRejected(reason, detail)

    def _estimate_wait_locked(self):
        """Seconds until a request admitted NOW would complete,
        estimated from the latency EWMA and live queue depth; None
        when no latency has been observed yet (cold server: admit —
        the first measurements teach the estimator)."""
        if not self._ewma:
            return None
        q = len(self._queue) + 1
        b = self._bucket_for(min(q, self.max_batch))
        ew = self._ewma_for_locked(b)
        batches = math.ceil(q / self.max_batch) + \
            (1 if self._batch_running else 0)
        return batches * ew

    def _ewma_for_locked(self, bucket):
        """Latency EWMA for a bucket the estimator may never have
        dispatched: an observed bucket answers directly; otherwise the
        nearest observed bucket's estimate is scaled by the row ratio
        (never the max over every bucket, which let one slow large
        bucket make the server over-shed single requests)."""
        ew = self._ewma.get(bucket)
        if ew is not None:
            return ew
        nearest = min(self._ewma, key=lambda b: abs(b - bucket))
        return self._ewma[nearest] * (bucket / max(nearest, 1))

    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    # ---------------------------------------------------------- batcher
    def _loop(self):
        while True:
            batch = None
            overdue = []
            detail = None
            with self._cond:
                if not self._running:
                    break
                if not self._queue:
                    if self._draining:
                        break  # drained: nothing queued, nothing new
                    self._cond.wait(0.05)
                elif self._breaker != "open":
                    batch = self._take_locked()
                elif self._draining:
                    # drain x open breaker: nothing will ever dispatch
                    # this queue (the probe re-warm can fail forever), so
                    # every queued request goes terminal now
                    overdue = list(self._queue)
                    self._queue.clear()
                    detail = ("draining with the breaker open: no "
                              "dispatch can ever take this request")
                else:
                    # queued work admitted before the trip waits for
                    # the re-warm, but never past its deadline
                    now = time.monotonic()
                    overdue = [r for r in self._queue
                               if r.deadline <= now]
                    if overdue:
                        keep = [r for r in self._queue
                                if r.deadline > now]
                        self._queue.clear()
                        self._queue.extend(keep)
                    else:
                        self._cond.wait(0.02)
            self._shed_expired(overdue, detail=detail)
            self._hb = time.monotonic()
            if self._wd is not None:
                self._wd.beat("serve")
            if self._breaker == "open":
                if not self._draining:
                    self._try_rewarm()
                continue
            if batch:
                try:
                    self._dispatch(batch)
                except BaseException as exc:  # noqa: BLE001
                    # the batcher thread must survive anything a
                    # model/fault can throw at it
                    for r in batch:
                        self._finish(r, err=ServeRejected(
                            "model_error", repr(exc)))

    def _take_locked(self):
        """Coalesce: the moment the model is free we take what is
        queued, waiting at most ``coalesce_s`` for the batch to grow
        toward the largest bucket."""
        self._t_take_pc = time.perf_counter()
        end = time.monotonic() + self.coalesce_s
        while len(self._queue) < self.max_batch and self._running:
            left = end - time.monotonic()
            if left <= 0:
                break
            self._cond.wait(left)
        k = min(len(self._queue), self.max_batch)
        return [self._queue.popleft() for _ in range(k)]

    def _batch_buffer(self, bucket, n_live):
        """The array a padded batch is stacked into: the runner's pinned
        host buffer on the card (padding rows zeroed), else zeros."""
        shape = (bucket,) + self.item_shape
        host_batch = getattr(self._model_fn, "host_batch", None)
        xb = host_batch(shape, self.dtype) if host_batch else None
        if xb is None:
            return onp.zeros(shape, self.dtype)
        xb[n_live:] = 0
        return xb

    def _dispatch(self, batch):
        now = time.monotonic()
        bucket = self._bucket_for(len(batch))
        est = self._ewma.get(bucket, 0.0)
        live, expired = [], []
        for r in batch:
            # dispatch-time re-check: the EWMA says this request can
            # no longer meet its deadline — shed it
            (expired if now + est > r.deadline else live).append(r)
        self._shed_expired(expired)
        if not live:
            return
        bucket = self._bucket_for(len(live))
        with self._cond:
            self._batch_running = True
        t0 = time.perf_counter()
        try:
            # everything that can fail a taken batch routes through
            # _model_failure, the serve.batch fault point included
            faultsim.inject("serve.batch")
            xb = self._batch_buffer(bucket, len(live))
            for i, r in enumerate(live):
                xb[i] = r.x
            self._note_shape(xb.shape)
            # the batch's retry budget is its tightest deadline
            budget = max(0.01, min(r.deadline for r in live)
                         - time.monotonic())
            out = retry_call(
                lambda: self._invoke(xb),
                retry_on=(faultsim.FaultInjected,), attempts=3,
                base_delay=0.01, max_delay=0.2, deadline_sec=budget)
            latency = time.perf_counter() - t0
            if onp.issubdtype(out.dtype, onp.floating) \
                    and not onp.isfinite(out[:len(live)]).all():
                raise MXNetError(
                    f"non-finite model output (batch {bucket}) — the "
                    "bad-step guard's serving analog")
        except Exception as exc:  # noqa: BLE001
            self._model_failure(live, exc)
            return
        finally:
            with self._cond:
                self._batch_running = False
        self._record_success(live, bucket, latency, t0)
        for i, r in enumerate(live):
            self._finish(r, out=out[i])

    def _shed_expired(self, expired, detail=None):
        """Shed requests whose deadline passed while waiting —
        dispatch-time re-check, open-breaker sweep and the
        drain-with-open-breaker sweep share this one accounting path."""
        if not expired:
            return
        with self._cond:
            self.stats["expired"] += len(expired)
            self.stats["shed"] += len(expired)
            by = self.stats["rejected"]
            by["expired"] = by.get("expired", 0) + len(expired)
        for r in expired:
            self._telemetry_count("serve_shed")
            self._finish(r, err=ServeRejected(
                "expired",
                detail or "deadline passed before the model could "
                          "take the request"))

    def _invoke(self, xb):
        poison = faultsim.inject("serve.model")
        out = onp.asarray(self._model_fn(xb))
        if poison == "nan" and onp.issubdtype(out.dtype,
                                              onp.floating):
            out = onp.full_like(out, onp.nan)
        return out

    def _note_shape(self, shape, warm=False):
        """Bounded-retrace accounting: the first dispatch of a padded
        shape is (at most) one new model program — on the card, one
        captured graph."""
        if shape in self._traced:
            return
        self._traced.add(shape)
        self.stats["warm_traces" if warm else "retraces"] += 1
        if self.aot:
            # a loaded artifact cannot retrace: its run log keeps
            # compiles == 0, the load-not-retrace proof
            return
        from .. import telemetry

        telemetry.compile_event(
            f"serve:{self.name}",
            telemetry.compile_fingerprint(shape, self.dtype,
                                          train=False))

    def _record_success(self, live, bucket, latency, t_invoke=None):
        with self._cond:
            prev = self._ewma.get(bucket)
            self._ewma[bucket] = latency if prev is None else \
                (1 - self._ewma_alpha) * prev + \
                self._ewma_alpha * latency
            self._consecutive_failures = 0
            self.stats["batches"] += 1
            self.stats["padded_rows"] += bucket - len(live)
            qd = len(self._queue)
            shed = self.stats["shed"]
        self._telemetry_count("serve_batches")
        from .. import telemetry

        rl = telemetry.current()
        if rl is not None:
            margin_ms = min(
                (r.deadline - time.monotonic()) * 1e3 for r in live)
            if t_invoke is not None:
                self._emit_request_spans(rl, live, bucket, t_invoke,
                                         t_invoke + latency)
            rl.serve(model=self.name, batch=len(live),
                     padded_to=bucket, queue_depth=qd,
                     latency_ms=latency * 1e3,
                     deadline_margin_ms=margin_ms, shed=shed,
                     breaker=self._breaker)

    def _emit_request_spans(self, rl, live, bucket, t_invoke, t_end):
        """Per-request decomposition of a traced request:
        ``serve_queue`` (submit -> batch taken), ``serve_coalesce``
        (batch formation -> model invoke) and ``serve_model`` (the
        invocation), siblings under the request's context.  Untraced
        requests cost one attribute check; the spans queue unflushed
        behind the batch's flushing ``serve`` record."""
        t_take = self._t_take_pc
        for r in live:
            ctx = r.trace
            if ctx is None:
                continue
            qs = r.t_submit_pc
            cs = min(max(qs, t_take if t_take is not None
                         else t_invoke), t_invoke)
            for name, a, b in (("serve_queue", qs, cs),
                               ("serve_coalesce", cs, t_invoke),
                               ("serve_model", t_invoke, t_end)):
                rl.span(name, a, b, trace_id=ctx.trace_id,
                        span_id=_tracing.new_span_id(),
                        parent_span_id=ctx.span_id, flush=False,
                        model=self.name, padded_to=int(bucket))

    def _model_failure(self, live, exc):
        err = exc if isinstance(exc, ServeRejected) else ServeRejected(
            "model_error", repr(exc))
        trip = False
        with self._cond:
            self.stats["model_failures"] += 1
            self._consecutive_failures += 1
            # the batch's requests end as structured rejections: they
            # count in shed and in the by-reason breakdown, so
            # shed == sum(rejected.values()) holds
            self.stats["shed"] += len(live)
            by = self.stats["rejected"]
            by[err.reason] = by.get(err.reason, 0) + len(live)
            if self._breaker == "closed" and \
                    self._consecutive_failures >= self.breaker_limit:
                self._breaker = "open"
                self.stats["breaker_trips"] += 1
                self._probe_s = 0.05
                self._next_probe = time.monotonic() + self._probe_s
                trip = True
        self._telemetry_count("serve_shed", len(live))
        for r in live:
            self._finish(r, err=err)
        self._telemetry_event("serve_model_failure", model=self.name,
                              error=repr(exc),
                              consecutive=self._consecutive_failures)
        if trip:
            self._telemetry_count("serve_breaker_trips")
            self._telemetry_event(
                "serve_breaker", model=self.name, state="open",
                failures=self._consecutive_failures)

    def _try_rewarm(self):
        """Breaker open: serve rejections while probing — one dummy
        smallest-bucket batch per (backing-off) probe interval; a
        finite probe result closes the breaker and serving resumes."""
        if time.monotonic() < self._next_probe:
            return
        xb = onp.zeros((self.buckets[0],) + self.item_shape,
                       self.dtype)
        try:
            out = self._invoke(xb)
            if onp.issubdtype(out.dtype, onp.floating) \
                    and not onp.isfinite(out).all():
                raise MXNetError("non-finite probe output")
        except Exception:  # noqa: BLE001 — still broken: back off
            self._probe_s = min(self._probe_s * 2.0, 2.0)
            self._next_probe = time.monotonic() + self._probe_s
            return
        # a warm=False server's probe can be the first dispatch of the
        # smallest bucket: account the program like any other dispatch
        self._note_shape((self.buckets[0],) + self.item_shape)
        with self._cond:
            self._breaker = "closed"
            self._consecutive_failures = 0
        self._telemetry_event("serve_breaker", model=self.name,
                              state="closed")

    def _finish(self, req, out=None, err=None):
        if req.handle.done:
            return  # already terminal: the inflight count must not
            #         double-decrement (loop safety net vs dispatch)
        req.handle._finish(out=out, err=err)
        with self._cond:
            self._inflight -= 1
            if err is None:
                self.stats["completed"] += 1
            self._cond.notify_all()

    # ----------------------------------------------------------- health
    def health(self):
        """Readiness/liveness probe payload.  ``live``: the batcher
        thread exists and made progress recently (or is legitimately
        inside a model call).  ``ready``: started, warm, admitting,
        breaker closed — safe to route traffic to."""
        with self._cond:
            alive = self._thread is not None \
                and self._thread.is_alive()
            hb_age = time.monotonic() - self._hb
            ew = max(self._ewma.values()) if self._ewma else 0.0
            # the coalesce window is legitimate quiet time
            quiet_bound = max(1.0, 10.0 * ew) + self.coalesce_s
            live = alive and (self._batch_running
                              or hb_age < quiet_bound)
            payload = {
                "live": bool(live),
                "ready": bool(self._ready and self._accepting
                              and alive
                              and self._breaker == "closed"),
                "breaker": self._breaker,
                "draining": self._draining,
                "queue_depth": len(self._queue),
                "inflight": self._inflight,
                "heartbeat_age_s": round(hb_age, 3),
                "buckets": list(self.buckets),
                "ewma_ms": {b: round(v * 1e3, 3)
                            for b, v in sorted(self._ewma.items())},
            }
        if not getattr(self, "_suppress_health_gauges", False):
            label = f'{{model="{self.name}"}}'
            self._telemetry_gauge(f"serve_ready{label}",
                                  int(payload["ready"]))
            self._telemetry_gauge(f"serve_live{label}",
                                  int(payload["live"]))
        return payload

    def live(self):
        return self.health()["live"]

    def ready(self):
        return self.health()["ready"]

    def warm_report(self):
        """The warm-start contract: how long start() took, whether the
        program was loaded from an artifact, and how many NEW padded
        shapes were dispatched after warmup (0 once every bucket is
        warm)."""
        return {"warm_start_s": self._warm_start_s, "aot": self.aot,
                "buckets": list(self.buckets),
                "warm_traces": self.stats["warm_traces"],
                "steady_state_traces": self.stats["retraces"]}

    # -------------------------------------------------------- telemetry
    @staticmethod
    def _telemetry_count(counter, delta=1):
        try:
            from .. import telemetry

            telemetry.count(counter, delta)
        except Exception:
            pass

    @staticmethod
    def _telemetry_event(kind, **fields):
        try:
            from .. import telemetry

            telemetry.event(kind, **fields)
        except Exception:
            pass

    @staticmethod
    def _telemetry_gauge(name, value):
        try:
            from .. import telemetry

            telemetry.gauge(name, value)
        except Exception:
            pass
