"""Thin HTTP front over the serving core (counterpart of
``mxnet_tpu/serving/frontend.py``).

A stdlib ``ThreadingHTTPServer`` on ``127.0.0.1`` (JSON bodies, no new
dependencies) that maps HTTP onto the submit/deadline/breaker core:
every response a request can get is either its model output or the
same structured :class:`~mxnet_tpu_torch.serving.server.ServeRejected`
reason the in-process API raises, carried as a status code + JSON body.
No endpoint can silently hang.

Endpoints:

==========================  ===========================================
``POST /v1/predict``        ``{"inputs": [[...], ...], "deadline_ms"?,
                            "model"?}`` → ``{"outputs": [...],
                            "latency_ms"}`` or a structured rejection
                            (status from :data:`REJECT_STATUS`, body
                            ``{"error": reason, "detail"}``)
``GET /healthz``            readiness/liveness JSON; HTTP 200 when
                            ready, 503 otherwise
``GET /metrics``            Prometheus text rows (``serve_ready`` /
                            ``serve_live`` gauges + the ``serve_*``
                            counters), the same truth ``health()``
                            computes
``GET /v1/models``          multi-model residency report (reserved
                            bytes per model vs the device budget)
``POST /admin/load``        ``{"model", "path"}`` — admit another
                            artifact (507 on ``hbm_budget``)
``POST /admin/unload``      ``{"model"}``
``POST /admin/swap``        ``{"model"?, "path"}`` — zero-downtime swap
                            of one model; 409 when the warm probe
                            failed and the old model was kept (rolled
                            back)
==========================  ===========================================

A ``POST /v1/predict`` carrying a W3C ``traceparent`` header is
adopted (its rows are submitted under a child context, so the server's
``serve_queue``/``serve_coalesce``/``serve_model`` spans join the
caller's trace) and echoed in the answer with a ``replica_request``
server span; with no header, an armed server (``MXNET_RUNLOG``) roots
its own trace, an unarmed one mints nothing.  The reference's
``fleet.replica`` fault point (a replica process's deterministic death)
comes with its ``FleetRouter`` (ROADMAP §A 10).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as onp

from ..base import MXNetError
from .server import ModelServer, ServeRejected

__all__ = ["ServeFrontend", "REJECT_STATUS", "http_call"]

#: ServeRejected reason -> HTTP status.  Back-pressure sheds map to
#: 429 (retryable by the client), lifecycle states to 503 (route to a
#: sibling), model faults to 500, and a device-memory budget refusal
#: to 507 (insufficient storage — literally).
REJECT_STATUS = {
    "queue_full": 429, "deadline": 429, "expired": 429,
    "breaker_open": 503, "draining": 503, "shutdown": 503,
    "no_replica": 503, "model_error": 500, "hbm_budget": 507,
}


def http_call(addr, port, method, path, body=None, timeout=10.0,
              headers=None):
    """One stdlib HTTP request (a client's side): returns
    ``(status, payload)`` where payload is the parsed JSON body (or
    the raw text for non-JSON responses like ``/metrics``).
    ``headers`` merges extra request headers.  Connection-level failures raise
    ``OSError``/``http.client`` errors — the caller's failover path.

    One fresh connection per call, deliberately: a pool shared across
    threads would need per-connection locking and dead-peer
    invalidation to beat a loopback TCP handshake."""
    import http.client

    conn = http.client.HTTPConnection(addr, int(port),
                                      timeout=float(timeout))
    try:
        data = None
        hdrs = dict(headers) if headers else {}
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        if "json" in ctype and raw:
            return resp.status, json.loads(raw)
        return resp.status, raw.decode(errors="replace")
    finally:
        conn.close()


class _SingleModelHost:
    """Duck-type adapter so the frontend serves a bare ModelServer
    with the same handler the multi-model :class:`~.fleet.ModelHost`
    uses (admin load/swap endpoints answer 501 through it)."""

    def __init__(self, server):
        self.server = server

    def submit(self, x, deadline_ms=None, model=None):
        if model is not None and model != self.server.name:
            # the same request against a ModelHost replica is a 400 —
            # a wrong-model name must never silently serve THIS model
            raise MXNetError(
                f"unknown model {model!r} (this replica serves "
                f"{self.server.name!r})")
        return self.server.submit(x, deadline_ms=deadline_ms)

    def health(self):
        h = self.server.health()
        h["models"] = {self.server.name: {"ready": h["ready"],
                                          "live": h["live"]}}
        return h

    def metrics_text(self):
        h = self.server.health()
        st = self.server.stats
        return _metrics_text(
            h["ready"], h["live"],
            {"serve_requests": st["requests"],
             "serve_shed": st["shed"],
             "serve_batches": st["batches"],
             "serve_breaker_trips": st["breaker_trips"]},
            gauges={"serve_queue_depth": h["queue_depth"],
                    "serve_inflight": h["inflight"]})

    def residency(self):
        return {"budget_bytes": None, "used_bytes": None,
                "models": {self.server.name: {}}}


def _metrics_text(ready, live, counters, gauges=None):
    """Prometheus text rows: the readiness/liveness gauges first (the
    satellite contract: probes and scrapers read health()'s truth),
    then the counters, then further point-in-time gauges (queue
    depth, in-flight — values that go DOWN must not be typed counter
    or rate()/increase() reads every drain as a counter reset)."""
    lines = ["# TYPE mxnet_tpu_serve_ready gauge",
             f"mxnet_tpu_serve_ready {int(bool(ready))}",
             "# TYPE mxnet_tpu_serve_live gauge",
             f"mxnet_tpu_serve_live {int(bool(live))}"]
    for k, v in sorted(counters.items()):
        lines.append(f"# TYPE mxnet_tpu_{k} counter")
        lines.append(f"mxnet_tpu_{k} {int(v)}")
    for k, v in sorted((gauges or {}).items()):
        lines.append(f"# TYPE mxnet_tpu_{k} gauge")
        lines.append(f"mxnet_tpu_{k} {int(v)}")
    return "\n".join(lines) + "\n"


class ServeFrontend:
    """HTTP front over a :class:`~.fleet.ModelHost` (or a bare
    :class:`~mxnet_tpu_torch.serving.server.ModelServer`).

    ``port=0`` (``MXNET_FLEET_PORT``'s default) binds an ephemeral
    port: read it back from ``.port`` after :meth:`start`.  Request
    handling runs on
    ``ThreadingHTTPServer``'s per-request daemon threads, so a slow
    model batch never blocks the health endpoint.
    """

    def __init__(self, host, port=None, addr="127.0.0.1"):
        from ..config import get_env

        if isinstance(host, ModelServer):
            host = _SingleModelHost(host)
        self.host = host
        self.addr = str(addr)
        self._want_port = int(port if port is not None
                              else get_env("MXNET_FLEET_PORT"))
        self.port = None
        self._httpd = None
        self._thread = None

    def start(self):
        if self._httpd is not None:
            raise MXNetError("frontend already started")
        handler = _make_handler(self.host)
        self._httpd = ThreadingHTTPServer((self.addr, self._want_port),
                                          handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"mxnet_tpu_torch-frontend-{self.port}", daemon=True)
        self._thread.start()
        return self

    def close(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def _make_handler(host):
    class Handler(BaseHTTPRequestHandler):
        # one handler class per frontend: `host` rides the closure
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # request logging is telemetry's
            pass                       # job, not stderr's

        # ------------------------------------------------- plumbing
        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(n) if n else b""
            if not raw:
                return {}
            try:
                doc = json.loads(raw)
            except ValueError as e:
                raise MXNetError(f"request body is not JSON: {e}") \
                    from e
            if not isinstance(doc, dict):
                raise MXNetError("request body must be a JSON object")
            return doc

        def _send(self, status, payload, ctype="application/json",
                  extra_headers=None):
            body = payload if isinstance(payload, bytes) else \
                json.dumps(payload).encode() if ctype.endswith("json") \
                else str(payload).encode()
            self.send_response(int(status))
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client gave up: its retry path handles it

        def _send_rejection(self, exc):
            self._send(REJECT_STATUS.get(exc.reason, 500),
                       {"error": exc.reason, "detail": exc.detail})

        # ------------------------------------------------------ GET
        def do_GET(self):
            try:
                if self.path == "/healthz":
                    h = host.health()
                    self._send(200 if h.get("ready") else 503, h)
                elif self.path == "/metrics":
                    self._send(200, host.metrics_text(),
                               ctype="text/plain; version=0.0.4")
                elif self.path == "/v1/models":
                    self._send(200, host.residency())
                else:
                    self._send(404, {"error": "not_found",
                                     "detail": self.path})
            except Exception as exc:  # noqa: BLE001 — wire layer:
                # an endpoint bug answers 500, it never kills the
                # listener thread pool
                self._send(500, {"error": "internal",
                                 "detail": repr(exc)})

        # ----------------------------------------------------- POST
        def do_POST(self):
            try:
                if self.path == "/v1/predict":
                    return self._predict()
                # read the body BEFORE any early answer: unread
                # Content-Length bytes would desync the next request
                # on an HTTP/1.1 keep-alive connection
                body = self._read_json()
                if self.path.startswith("/admin/") \
                        and not hasattr(host, "swap"):
                    # a bare ModelServer behind the frontend has no
                    # admin surface; an explicit capability probe —
                    # NOT a blanket AttributeError catch, which would
                    # disguise a real ModelHost bug as 501
                    return self._send(
                        501, {"error": "not_implemented",
                              "detail": "admin endpoints need a "
                                        "ModelHost"})
                if self.path == "/admin/swap":
                    return self._swap(body)
                if self.path == "/admin/load":
                    return self._load(body)
                if self.path == "/admin/unload":
                    host.unload(body["model"])
                    return self._send(200, {"unloaded": body["model"]})
                self._send(404, {"error": "not_found",
                                 "detail": self.path})
            except ServeRejected as exc:
                self._send_rejection(exc)
            except KeyError as exc:
                # a missing required field is the CLIENT's error
                self._send(400, {"error": "bad_request",
                                 "detail": f"missing field {exc}"})
            except MXNetError as exc:
                self._send(400, {"error": "bad_request",
                                 "detail": str(exc)})
            except Exception as exc:  # noqa: BLE001
                self._send(500, {"error": "internal",
                                 "detail": repr(exc)})

        def _predict(self):
            t0 = time.perf_counter()
            body = self._read_json()
            rows = body.get("inputs")
            if rows is None:
                raise MXNetError("predict body needs 'inputs'")
            x = onp.asarray(rows)
            deadline_ms = body.get("deadline_ms")
            model = body.get("model")
            # trace context: an inbound traceparent is adopted and
            # echoed; with none, an armed server roots its own trace.
            # Unarmed with no header: no minting, no echo
            from ..telemetry import tracing
            inbound = tracing.from_header(
                self.headers.get(tracing.TRACEPARENT_HEADER))
            req_ctx = inbound.child() if inbound is not None else \
                (tracing.mint() if tracing.enabled() else None)
            bind = tracing.use(req_ctx) if req_ctx is not None \
                else contextlib.nullcontext()
            with bind:
                try:
                    handles = [host.submit(row, deadline_ms=deadline_ms,
                                           model=model) for row in x]
                except ServeRejected as exc:
                    # already-admitted sibling rows still reach their
                    # own terminal state server-side; the REQUEST is the
                    # unit of shed here
                    return self._send_rejection(exc)
                wait_s = (float(deadline_ms) / 1e3 + 30.0) \
                    if deadline_ms is not None else 120.0
                outs = []
                try:
                    for h in handles:
                        outs.append(onp.asarray(h.result(timeout=wait_s)))
                except ServeRejected as exc:
                    return self._send_rejection(exc)
            t1 = time.perf_counter()
            if req_ctx is not None:
                tracing.emit_span("replica_request", t0, t1, req_ctx,
                                  kind="server", rows=int(len(x)),
                                  model=model or "")
            self._send(200, {
                "outputs": [o.tolist() for o in outs],
                "latency_ms": round((t1 - t0) * 1e3, 3),
                "model": model},
                extra_headers={tracing.TRACEPARENT_HEADER:
                               req_ctx.to_header()}
                if req_ctx is not None else None)

        def _swap(self, body):
            from .fleet import SwapRolledBack

            try:
                swap_ms = host.swap(body.get("model"), body["path"])
            except ServeRejected as exc:
                return self._send_rejection(exc)
            except SwapRolledBack as exc:
                # an ATTEMPTED swap failed and the old model kept
                # serving: an explicit 409, never a silent half-swap.
                # Refusals that never started (unknown model, another
                # swap in flight) stay plain MXNetError -> 400, so
                # the operator can tell "bad artifact" from "retry"
                return self._send(409, {"error": "swap_rolled_back",
                                        "detail": str(exc)})
            self._send(200, {"swapped": body.get("model"),
                             "swap_ms": round(float(swap_ms), 3)})

        def _load(self, body):
            host.load(body["model"], body["path"])
            self._send(200, host.residency())

    return Handler
