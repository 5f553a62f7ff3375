"""Multi-model residency and zero-downtime swap on one serving host
(counterpart of the single-host half of ``mxnet_tpu/serving/fleet.py``).

* :class:`ModelHost` — several models resident on one card under an
  explicit device-memory budget: an artifact is admitted only when its
  reserved bytes (:func:`artifact_reserved_bytes`) fit
  ``MXNET_FLEET_HBM_BUDGET_MB`` next to the residents, otherwise a
  structured ``ServeRejected(reason='hbm_budget')``.  Zero-downtime
  :meth:`ModelHost.swap`: the next artifact loads BESIDE the live one
  (on the card its graph is captured while the old model serves, between
  two of its batches), a warm probe must return finite outputs, the
  routing pointer cuts over between batches, the old server drains — a
  failed probe rolls back with the old model still serving.
* :class:`GenerativeHostServer` — the ModelServer-shaped adapter a
  host wraps around a generative artifact (a ``GenerativeServer``).

The ``fleet.swap`` fault point fires at the start of every swap,
before the next artifact loads (``crash`` = a mid-swap death).  The
reference's ``FleetRouter``, ``replica_main`` and their ``fleet.route``
/ ``fleet.replica`` points are ROADMAP §A 10.
"""
from __future__ import annotations

import threading
import time

import numpy as onp

from ..base import MXNetError
from ..resilience import faultsim
from .server import ModelServer, ServeRejected, _torch_dtype

__all__ = ["ModelHost", "SwapRolledBack", "GenerativeHostServer",
           "artifact_reserved_bytes"]


class SwapRolledBack(MXNetError):
    """A model swap failed AFTER it started (bad artifact, failed warm
    probe) and the previous artifact kept serving.  Distinct from the
    refusals that never touch the live model (unknown name, a swap
    already in flight), which raise plain MXNetError — an operator
    must be able to tell 'your artifact is bad' from 'retry in a
    moment'."""


faultsim.register_point(
    "fleet.swap", "ModelHost.swap, before the next artifact loads "
                  "(crash = mid-swap death)")


def _artifact_identity(path):
    """The v2 header's metadata (quantized / param_dtypes / signature)
    for the residency report — a header+metadata read, never the
    payload.  Artifacts without a metadata segment report None."""
    try:
        from .. import deploy

        return deploy.read_artifact_meta(path)
    except Exception:
        return None


def artifact_reserved_bytes(path, ctx=None):
    """Reserved device bytes of a dense artifact — the budget admission
    input, the reference's argument + output + temp bytes.  On the card:
    the bytes of the graph's parameters plus one forward at the
    artifact's batch, measured (``reset_peak_memory_stats``, then the
    peak of ``max_memory_allocated`` above the bytes allocated before it:
    input, activations, cuDNN workspaces, output).  The forward runs op
    by op and holds ``_graph.device_lock`` exclusively, so no other
    server's batch is counted in it.  The server's warm-up then captures
    that forward, and the capture's pool keeps about those bytes for
    good, so they are counted once.  On the host: the bytes of the input
    and outputs, as the reference falls back.  Returns
    ``(reserved_bytes, exported)`` so admission does not read the
    artifact twice."""
    import torch

    from .. import deploy
    from ..gluon._graph import device_lock

    exp = deploy.load_exported(path, ctx=ctx)
    dev = exp.device
    if dev.type != "cuda":
        avals = tuple(exp.in_avals) + tuple(exp.out_avals)
        return int(sum(int(onp.prod(a.shape)) * onp.dtype(a.dtype).itemsize
                       for a in avals)), exp
    params = sum(t.numel() * t.element_size()
                 for t in list(exp.block.parameters())
                 + list(exp.block.buffers()))
    aval = exp.in_avals[0]
    with device_lock.exclusive(), torch.cuda.device(dev), torch.no_grad():
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        x = torch.zeros(aval.shape, dtype=_torch_dtype(aval.dtype),
                        device=dev)
        out = exp.block.forward(x)
        del x, out
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    return int(params + peak), exp


class GenerativeHostServer:
    """The ModelServer-shaped adapter a :class:`ModelHost` wraps around
    a *generative* artifact: builds a
    :class:`~mxnet_tpu_torch.serving.generate.GenerativeServer` on
    ``ctx`` (default: the current context) from the artifact's
    parameters and ``gen`` header configuration, and exposes the submit
    / health / drain / close surface the host, the HTTP frontend and
    the swap drive.

    Requests are rows of token ids (the swap's zeros warm probe is a
    legal all-``<token 0>`` prompt of the smallest bucket); results are
    generated token lists.  A swap cuts the routing pointer between
    SEQUENCES and drains this server: in-flight decode sequences finish
    on the old version, and any sequence outliving the drain budget is
    finished with the structured shutdown rejection at close."""

    #: host/server kwargs that map onto the GenerativeServer (the
    #: dense-server knobs like coalesce_ms are dropped, not errors:
    #: one host serves both artifact classes)
    _GEN_KW = ("slots", "page_tokens", "pool_budget", "kv_dtype",
               "agreement_floor", "slo_ms", "queue_depth",
               "breaker_limit", "evict_after_ms", "eos_id", "max_new",
               "kv_gate")

    generative = True

    def __init__(self, path, name="model", ctx=None, **kw):
        from .. import deploy
        from ..context import current_context, resolve_device
        from .generate import GenerativeServer, params_from_numpy

        params, gen = deploy.load_generative(path)
        device = resolve_device(ctx if ctx is not None
                                else current_context())
        srv_kw = {k: v for k, v in kw.items() if k in self._GEN_KW}
        buckets = tuple(int(b) for b in
                        (gen.get("prompt_buckets") or (4, 8, 16)))
        max_new = int(srv_kw.pop("max_new", gen.get("max_new", 16)))
        self._srv = GenerativeServer(
            params=params_from_numpy(params, device),
            vocab=int(gen["vocab"]), layers=int(gen["layers"]),
            heads=int(gen["heads"]), head_dim=int(gen["head_dim"]),
            prompt_buckets=buckets, max_new=max_new, name=name,
            device=device, **srv_kw)
        self.name = name
        #: warm-probe signature (ModelHost.swap probes
        #: ``zeros(item_shape, dtype)``)
        self.item_shape = (buckets[0],)
        self.dtype = onp.int32
        self._suppress_health_gauges = True

    def start(self, warm=True):
        self._srv.start(warm=warm)
        return self

    def submit(self, x, deadline_ms=None):
        toks = [int(t) for t in onp.asarray(x).reshape(-1)]
        return self._srv.submit(toks, deadline_ms=deadline_ms)

    def in_flight(self):
        return self._srv.in_flight()

    def report(self):
        return self._srv.report()

    @property
    def stats(self):
        st = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in self._srv.stats.items()}
        # the host's metrics aggregation reads the dense counter
        # names; a generative "batch" is one prefill dispatch
        st.setdefault("batches", st.get("prefills", 0))
        return st

    def health(self):
        s = self._srv
        with s._lock:
            live = bool(s._started and not s._stop)
            ready = bool(live and not s._draining
                         and not s._breaker_open)
            return {"ready": ready, "live": live,
                    "queue_depth": len(s._queue),
                    "inflight": s.in_flight()}

    def drain(self, timeout=30.0):
        return self._srv.drain(timeout=timeout)

    def close(self):
        self._srv.close()


class ModelHost:
    """Multi-model residency on one serving host, budgeted in device
    bytes.

    ``hbm_budget_mb`` (None = ``MXNET_FLEET_HBM_BUDGET_MB``; 0 =
    unlimited) bounds the summed reserved bytes of every resident
    model; :meth:`load` refuses past it with a structured
    ``ServeRejected(reason='hbm_budget')`` — a loud admission verdict,
    never an out-of-memory error mid-batch.  ``server_kw`` reaches every
    server the host builds (``ctx=`` places the models; default: the
    current context of the thread that builds the host).  :meth:`swap`
    upgrades ONE model with zero
    downtime: the budget gates the incoming artifact against the OTHER
    residents (the swapped model's old and new programs briefly
    co-reside by design — leave one model's headroom when budgeting a
    host that swaps under load).
    """

    def __init__(self, hbm_budget_mb=None, server_kw=None):
        from ..config import get_env
        from ..context import current_context

        mb = float(hbm_budget_mb if hbm_budget_mb is not None
                   else get_env("MXNET_FLEET_HBM_BUDGET_MB"))
        self.budget_bytes = int(mb * (1 << 20)) if mb > 0 else 0
        self._server_kw = dict(server_kw or {})
        # the context is the constructing thread's: a load or swap from
        # another thread (an HTTP handler's) places its model there too
        self._server_kw.setdefault("ctx", current_context())
        self._lock = threading.RLock()
        self._models = {}     # name -> live ModelServer
        self._reserved = {}   # name -> reserved bytes
        self._paths = {}      # name -> artifact path
        self._info = {}       # name -> artifact_info header metadata
        self._load_kw = {}    # name -> per-model load() overrides
        self._pending = {}    # name -> reserved bytes mid-load/swap
        self.stats = {"loads": 0, "hbm_rejected": 0, "swaps": 0,
                      "rollbacks": 0, "unloads": 0}

    # ------------------------------------------------------ residency
    def used_bytes(self, exclude=None):
        """Resident + in-admission bytes (concurrent loads reserve
        BEFORE they start, so two admits cannot both squeeze past the
        budget)."""
        with self._lock:
            return sum(v for k, v in self._reserved.items()
                       if k != exclude) + \
                sum(v for k, v in self._pending.items()
                    if k != exclude)

    def residency(self):
        """Per-model reserved bytes vs the budget.  With the budget
        unlimited (0) the sizing is skipped entirely and every model
        reports 0 reserved bytes."""
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes or None,
                "used_bytes": self.used_bytes(),
                "models": {
                    name: {
                        "reserved_bytes": self._reserved[name],
                        "path": self._paths[name],
                        "quantized": (self._info.get(name) or
                                      {}).get("quantized"),
                        "param_dtypes": (self._info.get(name) or
                                         {}).get("param_dtypes"),
                    }
                    for name in sorted(self._models)},
            }

    def _admit_locked(self, name, reserved, exclude=None):
        """Budget-gate + reservation, atomically: a passing admit
        records ``reserved`` under ``_pending`` so a concurrent admit
        sees it.  Caller must hold the lock."""
        used = self.used_bytes(exclude=exclude)
        if self.budget_bytes and used + reserved > self.budget_bytes:
            self.stats["hbm_rejected"] += 1
            ModelServer._telemetry_event(
                "fleet_model_reject", model=name, reserved=reserved,
                resident=used, budget=self.budget_bytes)
            raise ServeRejected(
                "hbm_budget",
                f"model {name!r} reserves {reserved} bytes; "
                f"{used} bytes already resident of a "
                f"{self.budget_bytes}-byte host budget")
        self._pending[name] = reserved

    def _size_artifact(self, path, info, kw):
        """Reserved-bytes sizing for admission: one measured forward for
        a dense artifact, the summed parameter bytes for a generative
        one (its programs build only at start).  With the budget
        unlimited (the default) the sizing gates nothing and is
        skipped: admit at 0 bytes."""
        if not self.budget_bytes:
            return 0, None
        if (info or {}).get("generative"):
            from .. import deploy

            params, _ = deploy.load_generative(path)
            flat = deploy._flatten_params(params)
            return sum(int(onp.asarray(a).nbytes)
                       for a in flat.values()), None
        return artifact_reserved_bytes(
            path, ctx={**self._server_kw, **kw}.get("ctx"))

    def _make_server(self, name, path, info, exp, kw):
        """Construct (not started) the server class the artifact's
        header identity asks for — a GenerativeServer adapter for a
        ``"generative": true`` export, the dense ModelServer
        otherwise."""
        if (info or {}).get("generative"):
            return GenerativeHostServer(path, name=name,
                                        **{**self._server_kw, **kw})
        return ModelServer.from_artifact(
            path, exported=exp, name=name,
            **{**self._server_kw, **kw})

    def load(self, name, path, **kw):
        """Admit + start one artifact (budget-gated); returns the live
        server.  The admission read doubles as the warm handle, so a
        torn artifact fails HERE, before anything is started."""
        info = _artifact_identity(path)
        reserved, exp = self._size_artifact(path, info, kw)
        with self._lock:
            # name-claim + budget reservation in ONE lock scope: two
            # concurrent loads of the same name (or two models racing
            # the last budget bytes) cannot both pass
            if name in self._models or name in self._pending:
                raise MXNetError(f"model {name!r} already resident "
                                 "(use swap for an upgrade)")
            self._admit_locked(name, reserved)
        try:
            srv = self._make_server(name, path, info, exp, kw)
            srv._suppress_health_gauges = True  # the host aggregates
            srv.start(warm=True)
        except BaseException:
            with self._lock:
                self._pending.pop(name, None)
            raise
        with self._lock:
            self._pending.pop(name, None)
            self._models[name] = srv
            self._reserved[name] = reserved
            self._paths[name] = str(path)
            self._info[name] = info
            self._load_kw[name] = dict(kw)  # swaps must keep these
            self.stats["loads"] += 1
        ModelServer._telemetry_event(
            "fleet_model_load", model=name, reserved=reserved,
            resident=self.used_bytes(), budget=self.budget_bytes)
        return srv

    def unload(self, name):
        with self._lock:
            if name in self._pending:
                raise MXNetError(
                    f"model {name!r} has a load/swap in flight — "
                    "retry the unload once it resolves")
            srv = self._models.pop(name, None)
            self._reserved.pop(name, None)
            self._paths.pop(name, None)
            self._info.pop(name, None)
            self._load_kw.pop(name, None)
        if srv is None:
            raise MXNetError(f"model {name!r} not resident "
                             f"(resident: {sorted(self._models)})")
        srv.drain(timeout=10.0)
        srv.close()
        with self._lock:
            self.stats["unloads"] += 1
        ModelServer._telemetry_event("fleet_model_unload", model=name)

    def get(self, model=None):
        with self._lock:
            if model is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                if "model" in self._models:
                    return self._models["model"]
                raise MXNetError(
                    "multi-model host needs an explicit model name "
                    f"(resident: {sorted(self._models)})")
            srv = self._models.get(model)
            if srv is None:
                raise MXNetError(
                    f"unknown model {model!r} "
                    f"(resident: {sorted(self._models)})")
            return srv

    # ------------------------------------------------------- serving
    def submit(self, x, deadline_ms=None, model=None):
        """Route one request to the named model.  A request that
        reached the previous server of a model just as a swap cut over
        (it sheds ``'draining'``) is routed again to the server now
        resident, so a swap under load fails no request."""
        srv = self.get(model)
        try:
            return srv.submit(x, deadline_ms=deadline_ms)
        except ServeRejected as exc:
            if exc.reason not in ("draining", "shutdown"):
                raise
            now = self.get(model)
            if now is srv:
                raise
            return now.submit(x, deadline_ms=deadline_ms)

    # ---------------------------------------------------------- swap
    def swap(self, model, path, probe_timeout=60.0):
        """Zero-downtime model swap: load ``path`` beside the live
        server, warm it, require ONE finite probe answer, then cut the
        routing pointer over between batches and drain the old server.
        Any failure before the cutover closes the new server and
        KEEPS the old one serving (rollback), raised as
        :class:`SwapRolledBack`.  Returns the swap wall time in
        milliseconds."""
        faultsim.inject("fleet.swap")
        t0 = time.perf_counter()
        with self._lock:
            old = self.get(model)
            name = old.name
            if name in self._pending:
                raise MXNetError(
                    f"model {name!r} already has a load/swap in "
                    "flight")
            # claim the name NOW (zero bytes while the artifact is
            # sized): a concurrent load/swap/unload of it refuses
            # until this swap resolves
            self._pending[name] = 0
            kw = dict(self._load_kw.get(name, {}))
        info = _artifact_identity(path)
        new = None
        try:
            reserved, exp = self._size_artifact(path, info, kw)
            with self._lock:
                # exclude=name: the swapped model's old and new
                # programs briefly co-reside by design
                self._pending.pop(name)
                self._admit_locked(name, reserved, exclude=name)
            # per-model load() overrides survive the upgrade
            new = self._make_server(name, path, info, exp, kw)
            new._suppress_health_gauges = True  # the host aggregates
            new.start(warm=True)
            probe = onp.zeros(new.item_shape, new.dtype)
            out = new.submit(probe).result(timeout=probe_timeout)
            out = onp.asarray(out)
            if onp.issubdtype(out.dtype, onp.floating) \
                    and not onp.isfinite(out).all():
                raise MXNetError("warm probe returned non-finite "
                                 "outputs")
        except Exception as exc:
            if isinstance(exc, ServeRejected) \
                    and exc.reason == "hbm_budget":
                # the budget refusal never touched the live model:
                # structured passthrough, not a rollback
                with self._lock:
                    self._pending.pop(name, None)
                raise
            if new is not None:
                new.close()
            with self._lock:
                self._pending.pop(name, None)
                self.stats["rollbacks"] += 1
            ModelServer._telemetry_event(
                "fleet_swap_rollback", model=name, path=str(path),
                error=repr(exc))
            raise SwapRolledBack(
                f"swap of {name!r} to {path!r} rolled back "
                f"({exc}); the previous artifact keeps serving") \
                from exc
        # cutover between batches: new submits route to the new
        # server the moment the pointer moves; the old server's
        # in-flight batches finish in its drain
        with self._lock:
            self._pending.pop(name, None)
            self._models[name] = new
            self._reserved[name] = reserved
            self._paths[name] = str(path)
            self._info[name] = info
            self.stats["swaps"] += 1
        gen_extra = {}
        if getattr(old, "generative", False):
            # in-flight decode sequences at cutover ride out on the OLD
            # version; whether they all finished inside the drain
            # budget is reported, never assumed
            gen_extra["gen_inflight_at_cutover"] = old.in_flight()
        drained = old.drain(timeout=30.0)
        if gen_extra:
            gen_extra["gen_drained"] = bool(drained)
            gen_extra["gen_inflight_at_close"] = old.in_flight()
        old.close()
        swap_ms = (time.perf_counter() - t0) * 1e3
        ModelServer._telemetry_event(
            "fleet_swap", model=name, path=str(path),
            swap_ms=round(swap_ms, 3), reserved=reserved, **gen_extra)
        return swap_ms

    # -------------------------------------------------------- health
    def health(self):
        with self._lock:
            servers = dict(self._models)
        per = {name: srv.health() for name, srv in servers.items()}
        ready = bool(per) and all(h["ready"] for h in per.values())
        live = bool(per) and all(h["live"] for h in per.values())
        payload = {
            "ready": ready, "live": live,
            "queue_depth": sum(h["queue_depth"] for h in per.values()),
            "inflight": sum(h["inflight"] for h in per.values()),
            "models": per,
        }
        ModelServer._telemetry_gauge("serve_ready", int(ready))
        ModelServer._telemetry_gauge("serve_live", int(live))
        return payload

    def metrics_text(self):
        from .frontend import _metrics_text

        with self._lock:
            servers = dict(self._models)
        h = self.health()
        counters = {"serve_requests": 0, "serve_shed": 0,
                    "serve_batches": 0, "serve_breaker_trips": 0}
        for srv in servers.values():
            counters["serve_requests"] += srv.stats["requests"]
            counters["serve_shed"] += srv.stats["shed"]
            counters["serve_batches"] += srv.stats["batches"]
            counters["serve_breaker_trips"] += \
                srv.stats["breaker_trips"]
        return _metrics_text(
            h["ready"], h["live"], counters,
            gauges={"serve_queue_depth": h["queue_depth"],
                    "serve_inflight": h["inflight"]})

    # ------------------------------------------------------ lifecycle
    def drain_all(self, timeout=30.0):
        with self._lock:
            servers = list(self._models.values())
        return all(srv.drain(timeout=timeout) for srv in servers)

    def close_all(self):
        with self._lock:
            servers = list(self._models.values())
            self._models.clear()
            self._reserved.clear()
            self._paths.clear()
        for srv in servers:
            srv.close()
