"""The port's model host and HTTP front held against the JAX package on
the CPU.

Each drill of the reference's ``tests/test_fleet.py`` single-host half
runs on both packages (``ModelHost``, ``ServeFrontend``) with the same
weights, and the two must end alike: the same admissions and structured
refusals, the same routing, the same swap and rollback, the same HTTP
statuses and error bodies.  Reserved bytes are each package's own
measure (the reference's XLA memory analysis; the port's input and
output bytes on the host), so the budget drills hold outcomes, not
byte counts.  ``REJECT_STATUS`` and ``_metrics_text`` are the
reference's, byte for byte.  A generative artifact served through the
port's host gives the reference's greedy tokens.  The router
(``FleetRouter``, replica processes) is ROADMAP §A 10.
"""
import threading
import types

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
from mxnet_tpu.resilience import faultsim as jfaultsim  # noqa: E402
from mxnet_tpu.serving import frontend as jfrontend  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import serving as tserving  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as tfaultsim  # noqa: E402
from mxnet_tpu_torch.serving import frontend as tfrontend  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(mx=jmx, serving=jserving,
                                 faultsim=jfaultsim, Error=JMXNetError,
                                 http_call=jfrontend.http_call),
    "port": types.SimpleNamespace(mx=tmx, serving=tserving,
                                  faultsim=tfaultsim, Error=MXNetError,
                                  http_call=tfrontend.http_call),
}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    for p in PKGS.values():
        p.faultsim.reset("")
    with tmx.cpu():
        yield
    for p in PKGS.values():
        p.faultsim.reset("")


def _both(drill):
    out = {name: drill(pkg) for name, pkg in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


class _Artifacts:
    """Dense(5, in=3) artifacts of both packages with the same weights,
    by seed; ``nan=True`` bakes non-finite weights in."""

    def __init__(self, tmp_path):
        self.dir = tmp_path
        self.nets = {}

    def path(self, pkg, name, seed=0, nan=False, batch=4):
        key = (name, seed, nan)
        if key not in self.nets:
            rng = onp.random.RandomState(seed)
            w = rng.randn(5, 3).astype("float32")
            b = rng.randn(5).astype("float32")
            if nan:
                w[:] = onp.nan
            self.nets[key] = (w, b)
        w, b = self.nets[key]
        net = pkg.mx.gluon.nn.Dense(5, in_units=3)
        net.initialize()
        params = net.collect_params()
        params[net.prefix + "weight"].set_data(pkg.mx.nd.array(w))
        params[net.prefix + "bias"].set_data(pkg.mx.nd.array(b))
        tag = "t" if pkg.mx is tmx else "j"
        path = str(self.dir / f"{tag}_{name}.mxje")
        x = pkg.mx.nd.zeros((batch, 3))
        if pkg.mx is tmx:
            pkg.mx.deploy.export_model(net, x, path)
        else:
            pkg.mx.deploy.export_model(net, x, path, platforms=("cpu",))
        return path

    def row(self, name, x, seed=0):
        w, b = self.nets[(name, seed, False)]
        return x @ w.T + b


def _close(got, want):
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return True


# ------------------------------------------------------- fault registry
def test_fault_points_registered():
    pts = set(tfaultsim.points())
    assert {"fleet.swap", "serve.admit", "serve.batch", "serve.model",
            "serve.prefill", "serve.decode"} <= pts
    tfaultsim.reset("fleet.swap:delay=0.1@999;serve.batch:raise@999")
    tfaultsim.reset("")
    with pytest.raises(MXNetError, match="unknown fault point"):
        tfaultsim.reset("fleet.swapp:raise@1")


# ----------------------------------------------------------- the budget
def test_budget_admits_within_and_rejects_past(tmp_path):
    arts = _Artifacts(tmp_path)

    def drill(p):
        p1, p2 = arts.path(p, "m1"), arts.path(p, "m2", seed=1)
        reserved, _ = p.serving.artifact_reserved_bytes(p1)
        assert reserved > 0
        host = p.serving.ModelHost(hbm_budget_mb=reserved * 1.5 / 2 ** 20,
                                   server_kw={"slo_ms": 30000})
        try:
            host.load("m1", p1)
            res = host.residency()
            ok = (res["models"]["m1"]["reserved_bytes"] == reserved
                  and res["used_bytes"] == reserved)
            with pytest.raises(p.serving.ServeRejected) as e:
                host.load("m2", p2)
            refused = (e.value.reason, "budget" in str(e.value),
                       host.stats["hbm_rejected"])
            host.unload("m1")
            host.load("m2", p2)
            after = sorted(host.residency()["models"])
            with pytest.raises(p.Error, match="already resident"):
                host.load("m2", p2)
            return {"ok": ok, "refused": refused, "after": after,
                    "stats": dict(host.stats)}
        finally:
            host.close_all()

    res = _both(drill)
    assert res["ok"] and res["refused"] == ("hbm_budget", True, 1)


def test_residency_routes_by_name(tmp_path):
    arts = _Artifacts(tmp_path)
    x = onp.random.RandomState(5).rand(3).astype("float32")

    def drill(p):
        host = p.serving.ModelHost(server_kw={"slo_ms": 30000,
                                              "coalesce_ms": 0.5})
        try:
            host.load("a", arts.path(p, "a", seed=1))
            host.load("b", arts.path(p, "b", seed=2))
            out_a = host.submit(x, model="a").result(timeout=30)
            out_b = host.submit(x, model="b").result(timeout=30)
            routed = (_close(out_a, arts.row("a", x, 1)),
                      _close(out_b, arts.row("b", x, 2)))
            with pytest.raises(p.Error) as e:
                host.submit(x)
            with pytest.raises(p.Error) as e2:
                host.submit(x, model="ghost")
            return {"routed": routed, "ambiguous": str(e.value),
                    "unknown": str(e2.value),
                    "residency": sorted(host.residency()["models"])}
        finally:
            host.close_all()

    res = _both(drill)
    assert "explicit model name" in res["ambiguous"]


# ------------------------------------------------------------- the swap
def test_swap_cuts_over_and_rolls_back_on_bad_probe(tmp_path):
    arts = _Artifacts(tmp_path)
    x = onp.random.RandomState(6).rand(3).astype("float32")

    def drill(p):
        p1 = arts.path(p, "v1", seed=3)
        p2 = arts.path(p, "v2", seed=4)
        bad = arts.path(p, "vbad", nan=True)
        host = p.serving.ModelHost(server_kw={"slo_ms": 30000,
                                              "coalesce_ms": 0.5})
        try:
            host.load("model", p1)
            steps = [_close(host.submit(x).result(30), arts.row("v1", x, 3))]
            assert host.swap("model", p2) > 0
            steps.append(_close(host.submit(x).result(30),
                                arts.row("v2", x, 4)))
            with pytest.raises(p.Error, match="rolled back") as e:
                host.swap("model", bad)
            steps.append(type(e.value).__name__)
            steps.append(_close(host.submit(x).result(30),
                                arts.row("v2", x, 4)))
            steps.append(host.residency()["models"]["model"]["path"] == p2)
            p.faultsim.reset("fleet.swap:raise@1")
            with pytest.raises(p.faultsim.FaultInjected):
                host.swap("model", p1)
            p.faultsim.reset("")
            steps.append(_close(host.submit(x).result(30),
                                arts.row("v2", x, 4)))
            return {"steps": steps, "stats": dict(host.stats)}
        finally:
            host.close_all()

    res = _both(drill)
    assert res["steps"][2] == "SwapRolledBack"
    assert res["stats"]["swaps"] == 1 and res["stats"]["rollbacks"] == 1


def test_swap_keeps_overrides_and_guards_unload(tmp_path):
    arts = _Artifacts(tmp_path)

    def drill(p):
        host = p.serving.ModelHost(server_kw={"slo_ms": 30000,
                                              "coalesce_ms": 0.5})
        try:
            host.load("model", arts.path(p, "v1", seed=5), slo_ms=1234.0,
                      queue_depth=7)
            host.swap("model", arts.path(p, "v2", seed=6))
            srv = host.get("model")
            kept = (srv.slo_ms, srv.queue_depth)
            host._pending["model"] = 0
            msgs = []
            for call in (lambda: host.unload("model"),
                         lambda: host.swap("model", arts.path(p, "v1",
                                                              seed=5))):
                with pytest.raises(p.Error, match="in flight") as e:
                    call()
                msgs.append(str(e.value))
            host._pending.clear()
            return {"kept": kept, "msgs": msgs}
        finally:
            host.close_all()

    assert _both(drill)["kept"] == (1234.0, 7)


def test_swap_under_load_fails_no_request(tmp_path):
    """Clients keep submitting through the host while it swaps: every
    request completes, each with the old or the new model's row, the
    new one's after the swap returned (a request that reached the old
    server as it began to drain is routed again)."""
    arts = _Artifacts(tmp_path)
    p = PKGS["port"]
    p1, p2 = arts.path(p, "v1", seed=7), arts.path(p, "v2", seed=8)
    x = onp.random.RandomState(9).rand(3).astype("float32")
    host = tserving.ModelHost(server_kw={"slo_ms": 30000,
                                         "coalesce_ms": 0.5})
    host.load("model", p1)
    stop = threading.Event()
    started = threading.Event()
    outs, errs = [], []
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                row = host.submit(x, model="model").result(timeout=30)
                with lock:
                    outs.append(row)
                    if len(outs) >= 50:
                        started.set()
            except Exception as e:  # noqa: BLE001 — counted, asserted 0
                with lock:
                    errs.append(repr(e))

    ts = [threading.Thread(target=client) for _ in range(4)]
    try:
        for t in ts:
            t.start()
        assert started.wait(30)
        host.swap("model", p2)
        with lock:
            n_at_swap = len(outs)
        new = arts.row("v2", x, 8)
        after = host.submit(x, model="model").result(timeout=30)
    finally:
        stop.set()
        for t in ts:
            t.join()
        host.close_all()
    assert not errs, errs[:3]
    old = arts.row("v1", x, 7)
    assert all(onp.allclose(o, old, atol=TOL) or onp.allclose(o, new,
                                                              atol=TOL)
               for o in outs)
    assert n_at_swap >= 50
    _close(after, new)


# -------------------------------------------------------- the HTTP front
def test_reject_status_and_metrics_text_are_the_references():
    assert tfrontend.REJECT_STATUS == jfrontend.REJECT_STATUS
    counters = {"serve_requests": 12, "serve_shed": 3, "serve_batches": 5,
                "serve_breaker_trips": 1}
    gauges = {"serve_queue_depth": 2, "serve_inflight": 4}
    for ready, live in ((True, True), (False, True)):
        assert tfrontend._metrics_text(ready, live, counters, gauges) == \
            jfrontend._metrics_text(ready, live, counters, gauges)


def test_frontend_predict_health_metrics_and_rejections():
    def drill(p):
        srv = p.serving.ModelServer(lambda xb: xb * 2.0 + 1.0, (3,),
                                    max_batch=4, slo_ms=30000,
                                    coalesce_ms=0.5)
        srv.start(warm=True)
        fe = p.serving.ServeFrontend(srv, port=0).start()
        call = p.http_call
        try:
            x = onp.random.RandomState(1).rand(2, 3).astype("float32")
            seen = []
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": x.tolist()})
            seen.append((st, _close(onp.asarray(body["outputs"]),
                                    x * 2.0 + 1.0), body["model"]))
            st, h = call("127.0.0.1", fe.port, "GET", "/healthz")
            seen.append((st, h["ready"], h["live"], sorted(h["models"])))
            st, text = call("127.0.0.1", fe.port, "GET", "/metrics")
            seen.append((st, text))
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": x.tolist(), "deadline_ms": 0.0})
            seen.append((st, body["error"]))
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": [[1.0, 2.0]]})
            seen.append((st, body["error"], body["detail"]))
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": x.tolist(), "model": "ghost"})
            seen.append((st, body["error"], body["detail"]))
            srv.drain(timeout=10)
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": x.tolist()})
            seen.append((st, body["error"]))
            st, h = call("127.0.0.1", fe.port, "GET", "/healthz")
            seen.append((st, h["ready"]))
            for path, payload in (("/v1/predict", {"nope": 1}),
                                  ("/admin/swap", {"path": "x.mxje"}),
                                  ("/nowhere", {})):
                st, body = call("127.0.0.1", fe.port, "POST", path,
                                payload)
                seen.append((st, body["error"]))
            st, body = call("127.0.0.1", fe.port, "GET", "/v1/models")
            seen.append((st, body))
            return seen
        finally:
            fe.close()
            srv.close()

    seen = _both(drill)
    assert seen[0][0] == 200 and seen[1][:3] == (200, True, True)
    assert "mxnet_tpu_serve_ready 1" in seen[2][1]
    assert seen[3] == (429, "deadline")
    assert seen[4][:2] == (400, "bad_request")
    assert seen[6] == (503, "draining") and seen[7] == (503, False)
    assert [s[0] for s in seen[8:11]] == [400, 501, 404]


def test_frontend_admin_load_past_the_budget_is_507(tmp_path):
    arts = _Artifacts(tmp_path)

    def drill(p):
        p1, p2 = arts.path(p, "m1"), arts.path(p, "m2", seed=1)
        reserved, _ = p.serving.artifact_reserved_bytes(p1)
        host = p.serving.ModelHost(hbm_budget_mb=reserved * 1.5 / 2 ** 20,
                                   server_kw={"slo_ms": 30000})
        fe = p.serving.ServeFrontend(host, port=0).start()
        call = p.http_call
        try:
            seen = []
            st, body = call("127.0.0.1", fe.port, "POST", "/admin/load",
                            {"model": "m1", "path": p1})
            seen.append((st, sorted(body["models"])))
            st, body = call("127.0.0.1", fe.port, "POST", "/admin/load",
                            {"model": "m2", "path": p2})
            seen.append((st, body["error"]))
            st, body = call("127.0.0.1", fe.port, "GET", "/v1/models")
            seen.append((st, sorted(body["models"])))
            for payload in ({"path": p2}, {"model": "ghost", "path": p2}):
                st, body = call("127.0.0.1", fe.port, "POST",
                                "/admin/load" if "model" not in payload
                                else "/admin/swap", payload)
                seen.append((st, body["error"]))
            bad = arts.path(p, "mbad", nan=True)
            st, body = call("127.0.0.1", fe.port, "POST", "/admin/swap",
                            {"model": "m1", "path": bad}, timeout=60.0)
            seen.append((st, body["error"]))
            x = onp.random.RandomState(2).rand(3).astype("float32")
            st, body = call("127.0.0.1", fe.port, "POST", "/v1/predict",
                            {"inputs": [x.tolist()], "model": "m1"})
            seen.append((st, _close(onp.asarray(body["outputs"][0]),
                                    arts.row("m1", x))))
            st, body = call("127.0.0.1", fe.port, "POST", "/admin/unload",
                            {"model": "m1"})
            seen.append((st, body))
            return seen
        finally:
            fe.close()
            host.close_all()

    seen = _both(drill)
    assert seen[1] == (507, "hbm_budget")
    assert seen[3] == (400, "bad_request") and seen[4] == (400,
                                                          "bad_request")
    assert seen[5] == (409, "swap_rolled_back")
    assert seen[6] == (200, True)


# ------------------------------------------------------ generative host
def test_generative_artifact_serves_the_references_tokens(tmp_path):
    """The reference's toy decoder exported by the reference, served by
    both packages' ``ModelHost``: the same greedy tokens."""
    from mxnet_tpu.serving import toy_decoder_params as j_toy

    params = jax.tree.map(onp.asarray, j_toy(seed=0))
    path = str(tmp_path / "gen.mxje")
    jmx.deploy.export_generative(params, path, vocab=32, layers=2,
                                 heads=2, head_dim=8,
                                 prompt_buckets=(4, 8, 16), max_new=6)
    prompts = [[1, 2, 3], [5], [7, 3, 9, 2, 11]]

    def drill(p):
        host = p.serving.ModelHost(server_kw={"kv_dtype": "float32",
                                              "slo_ms": 30000,
                                              "coalesce_ms": 0.5})
        try:
            srv = host.load("gen", path)
            out = [list(host.submit(onp.asarray(pr), model="gen")
                        .result(timeout=60)) for pr in prompts]
            st = srv.stats
            return {"tokens": out, "generative": srv.generative,
                    "item_shape": srv.item_shape,
                    "counted": (st["requests"], st["completed"])}
        finally:
            host.close_all()

    res = _both(drill)
    assert all(len(t) == 6 for t in res["tokens"])
