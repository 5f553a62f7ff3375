"""The port's ``ModelServer`` held against the JAX package's on the CPU.

Each drill of the reference's ``tests/test_serving.py`` runs on both
packages' servers with the same numpy ``model_fn`` and the same
``MXNET_FAULT_SPEC`` (armed in each package's ``faultsim``), and the two
runs must end alike: the same terminal outcome for every request and
the same ``stats``.  No drill reads a wall-clock latency.  Where a
drill needs requests to queue behind a running batch, the model blocks
on an event inside the call (``_Gated``) until the test has queued
them, so every batch is the same in both packages and in every run;
where it needs a deadline to pass, it waits until that deadline.
Deadlines are at least 10x what the model takes.  The server's run
log, spans and watchdog are held in ``tests/test_torch_tracing.py``
and ``tests/test_torch_watchdog_numerics.py``.

Run as a script (``python tests/test_torch_serving.py drain OUT``), the
file is the worker of the SIGTERM drain drill: it serves the port alone.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as onp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ != "__main__":
    import pytest

    import jax

    jax.config.update("jax_platforms", "cpu")

    import mxnet_tpu as jmx  # noqa: E402
    from mxnet_tpu import serving as jserving  # noqa: E402
    from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
    from mxnet_tpu.resilience import faultsim as jfaultsim  # noqa: E402

    import mxnet_tpu_torch as tmx  # noqa: E402
    from mxnet_tpu_torch import serving as tserving  # noqa: E402
    from mxnet_tpu_torch.base import MXNetError  # noqa: E402
    from mxnet_tpu_torch.resilience import faultsim as tfaultsim  # noqa: E402

    PKGS = {
        "ref": types.SimpleNamespace(
            mx=jmx, serving=jserving, faultsim=jfaultsim, Error=JMXNetError),
        "port": types.SimpleNamespace(
            mx=tmx, serving=tserving, faultsim=tfaultsim, Error=MXNetError),
    }

    @pytest.fixture(autouse=True)
    def _disarm_faults():
        for p in PKGS.values():
            p.faultsim.reset("")
        with tmx.cpu():
            yield
        for p in PKGS.values():
            p.faultsim.reset("")


def _both(drill):
    """Run ``drill(pkg)`` on the reference and on the port; their
    results must be equal.  Returns the port's."""
    out = {name: drill(pkg) for name, pkg in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _until(pred, timeout=10.0):
    """Wait for ``pred()`` (a server state another thread changes)."""
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, "state never reached"
        time.sleep(0.002)


class _Gated:
    """``out = 2x + 1``; each call records its batch shape, sets
    ``entered`` and waits for ``gate`` (open unless a drill closes it);
    raises while ``fail`` is set."""

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.shapes = []
        self.fail = False

    def __call__(self, xb):
        self.shapes.append(tuple(xb.shape))
        self.entered.set()
        assert self.gate.wait(30)
        if self.fail:
            raise ValueError("model down")
        return xb * 2.0 + 1.0

    def hold(self):
        self.gate.clear()
        self.entered.clear()


def _outcome(h, timeout=30.0):
    """A handle's terminal state: ``("ok", row)`` or the reason."""
    try:
        return ("ok", onp.asarray(h.result(timeout=timeout)).tolist())
    except Exception as e:  # ServeRejected of either package
        return ("rejected", e.reason)


def _stats(srv):
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in srv.stats.items()}


def _z(n=2):
    return onp.zeros((n,), "float32")


# ------------------------------------------------------------- batching
def test_each_request_gets_its_own_row():
    def drill(p):
        m = _Gated()
        srv = p.serving.ModelServer(m, (3,), max_batch=4, slo_ms=30000,
                                    coalesce_ms=5.0)
        srv.start(warm=True)
        try:
            m.hold()
            hs = [srv.submit(onp.full((3,), 0, "float32"))]
            assert m.entered.wait(10)
            hs += [srv.submit(onp.full((3,), i, "float32"))
                   for i in range(1, 11)]
            m.gate.set()
            outs = [_outcome(h) for h in hs]
            for i, (kind, row) in enumerate(outs):
                assert kind == "ok" and row == [2.0 * i + 1.0] * 3
            return {"outs": outs, "stats": _stats(srv),
                    "shapes": m.shapes,
                    "warm": srv.warm_report()["steady_state_traces"]}
        finally:
            srv.close()

    res = _both(drill)
    assert res["stats"]["batches"] == 4  # 1 alone, then 4 + 4 + 2
    assert {s[0] for s in res["shapes"]} <= set(
        tserving.default_buckets(4))
    assert res["warm"] == 0


def test_batch_follows_live_queue_depth():
    def drill(p):
        m = _Gated()
        srv = p.serving.ModelServer(m, (2,), max_batch=8, slo_ms=30000,
                                    coalesce_ms=1.0)
        srv.start(warm=True)
        try:
            m.hold()
            hs = [srv.submit(_z())]
            assert m.entered.wait(10)
            hs += [srv.submit(_z()) for _ in range(16)]
            m.gate.set()
            outs = [_outcome(h) for h in hs]
            return {"outs": outs, "stats": _stats(srv),
                    "shapes": m.shapes[-3:]}
        finally:
            srv.close()

    res = _both(drill)
    assert res["shapes"] == [(1, 2), (8, 2), (8, 2)]
    assert res["stats"]["completed"] == 17


def test_bad_request_shape_is_loud():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (3,), max_batch=2,
                                    slo_ms=1000)
        srv.start(warm=False)
        try:
            with pytest.raises(p.Error) as e:
                srv.submit(onp.zeros((4,), "float32"))
            return str(e.value)
        finally:
            srv.close()

    assert "item shape" in _both(drill)


# ------------------------------------------------------------ admission
def test_queue_full_rejects_structured():
    def drill(p):
        m = _Gated()
        srv = p.serving.ModelServer(m, (2,), max_batch=2, slo_ms=60000,
                                    queue_depth=3, coalesce_ms=0.0)
        srv.start(warm=True)
        try:
            m.hold()
            hs = [srv.submit(_z())]
            assert m.entered.wait(10)
            reasons = []
            for _ in range(20):
                try:
                    hs.append(srv.submit(_z()))
                except p.serving.ServeRejected as e:
                    reasons.append(e.reason)
            m.gate.set()
            outs = [_outcome(h) for h in hs]
            return {"reasons": reasons, "outs": outs,
                    "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["reasons"] == ["queue_full"] * 17
    assert res["stats"]["shed"] == 17 and res["stats"]["completed"] == 4


def test_deadline_shed_at_admission_and_dispatch():
    def drill(p):
        m = _Gated()
        srv = p.serving.ModelServer(m, (2,), max_batch=2, slo_ms=30000,
                                    coalesce_ms=0.0)
        srv.start(warm=True)  # the warm-up seeds the EWMA the estimate uses
        try:
            with pytest.raises(p.serving.ServeRejected) as e:
                srv.submit(_z(), deadline_ms=0.0)
            at_admission = e.value.reason
            m.hold()
            h_slow = srv.submit(_z())
            assert m.entered.wait(10)
            h_tight = srv.submit(_z(), deadline_ms=50.0)
            _until(lambda: time.monotonic() > h_tight.deadline)
            m.gate.set()
            return {"admission": at_admission, "slow": _outcome(h_slow),
                    "tight": _outcome(h_tight), "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["admission"] == "deadline"
    assert res["tight"] == ("rejected", "expired")
    assert res["stats"]["rejected"] == {"deadline": 1, "expired": 1}


# ------------------------------------------------ faults / retry / breaker
def test_transient_model_fault_retried_inside_deadline():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=2,
                                    slo_ms=10000, coalesce_ms=0.0)
        srv.start(warm=True)
        p.faultsim.reset("serve.model:raise@1")
        try:
            out = _outcome(srv.submit(onp.full((2,), 3.0, "float32")))
            return {"out": out, "hits": p.faultsim.hits("serve.model"),
                    "stats": _stats(srv),
                    "breaker": srv.health()["breaker"]}
        finally:
            srv.close()

    res = _both(drill)
    assert res["out"] == ("ok", [7.0, 7.0]) and res["hits"] == 2
    assert res["stats"]["model_failures"] == 0
    assert res["breaker"] == "closed"


def test_persistent_fault_fails_structured_within_budget():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=2,
                                    slo_ms=10000, breaker_limit=100,
                                    coalesce_ms=0.0)
        srv.start(warm=True)
        p.faultsim.reset("serve.model:raise@1+")
        try:
            out = _outcome(srv.submit(_z(), deadline_ms=500))
            return {"out": out, "hits": p.faultsim.hits("serve.model"),
                    "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["out"] == ("rejected", "model_error")
    assert res["hits"] == 3  # retry_call's three attempts


def test_breaker_trips_serves_rejections_and_rewarms():
    def drill(p):
        m = _Gated()
        srv = p.serving.ModelServer(m, (2,), max_batch=2, slo_ms=10000,
                                    breaker_limit=2, coalesce_ms=0.0)
        srv.start(warm=True)
        try:
            outs = [_outcome(srv.submit(_z()))]
            m.fail = True
            outs += [_outcome(srv.submit(_z())) for _ in range(2)]
            _until(lambda: srv.health()["breaker"] == "open")
            h = srv.health()
            with pytest.raises(p.serving.ServeRejected) as e:
                srv.submit(_z())
            m.fail = False
            _until(lambda: srv.health()["breaker"] == "closed")
            outs.append(_outcome(srv.submit(_z())))
            return {"outs": outs, "open_ready": h["ready"],
                    "while_open": e.value.reason, "ready": srv.ready(),
                    "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert [o[0] for o in res["outs"]] == ["ok", "rejected", "rejected",
                                           "ok"]
    assert res["while_open"] == "breaker_open"
    assert res["open_ready"] is False and res["ready"] is True
    assert res["stats"]["breaker_trips"] == 1


def test_batcher_fault_is_fully_accounted():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=2,
                                    slo_ms=10000, breaker_limit=100,
                                    coalesce_ms=0.0)
        srv.start(warm=True)
        p.faultsim.reset("serve.batch:raise@1+")
        try:
            outs = [_outcome(srv.submit(_z())) for _ in range(2)]
            return {"outs": outs, "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["outs"] == [("rejected", "model_error")] * 2
    assert res["stats"]["model_failures"] == 2
    assert res["stats"]["rejected"] == {"model_error": 2}


def test_nan_poison_counts_as_model_failure():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=2,
                                    slo_ms=10000, breaker_limit=3,
                                    coalesce_ms=0.0)
        srv.start(warm=True)
        p.faultsim.reset("serve.model:nan@1+")
        try:
            outs = [_outcome(srv.submit(_z())) for _ in range(3)]
            _until(lambda: srv.health()["breaker"] == "open")
            return {"outs": outs, "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["outs"] == [("rejected", "model_error")] * 3
    assert res["stats"]["breaker_trips"] == 1


def _tripped_with_queue(p, slo_ms):
    """A one-failure breaker trips on the first batch while three more
    requests wait queued behind it."""
    m = _Gated()
    srv = p.serving.ModelServer(m, (2,), max_batch=1, slo_ms=slo_ms,
                                breaker_limit=1, coalesce_ms=0.0)
    srv.start(warm=True)
    m.hold()
    m.fail = True
    hs = [srv.submit(_z())]
    assert m.entered.wait(10)
    hs += [srv.submit(_z()) for _ in range(3)]
    m.gate.set()
    _until(lambda: srv.health()["breaker"] == "open")
    return srv, hs


def test_admitted_requests_expire_behind_open_breaker():
    def drill(p):
        srv, hs = _tripped_with_queue(p, slo_ms=300.0)
        try:
            outs = [_outcome(h, timeout=5) for h in hs]
            return {"outs": outs, "drained": srv.drain(timeout=5.0),
                    "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["outs"] == [("rejected", "model_error")] + \
        [("rejected", "expired")] * 3
    assert res["drained"] is True


def test_drain_with_open_breaker_expires_queued():
    def drill(p):
        srv, hs = _tripped_with_queue(p, slo_ms=60000.0)
        try:
            drained = srv.drain(timeout=10.0)
            assert all(h.done for h in hs)
            return {"outs": [_outcome(h, timeout=0.1) for h in hs],
                    "drained": drained, "stats": _stats(srv)}
        finally:
            srv.close()

    res = _both(drill)
    assert res["drained"] is True
    assert res["outs"][1:] == [("rejected", "expired")] * 3


# ------------------------------------------------------- programs, health
def test_bounded_retraces():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=4,
                                    slo_ms=30000, coalesce_ms=0.0)
        srv.start(warm=True)
        try:
            outs = [_outcome(h) for h in
                    [srv.submit(_z()) for _ in range(9)]]
            st = _stats(srv)
            return {"ok": [o[0] for o in outs],
                    "retraces": st["retraces"],
                    "warm_traces": st["warm_traces"],
                    "report": srv.warm_report()["steady_state_traces"]}
        finally:
            srv.close()

    res = _both(drill)
    assert res == {"ok": ["ok"] * 9, "retraces": 0,
                   "warm_traces": len(tserving.default_buckets(4)),
                   "report": 0}


def test_health_probe_lifecycle():
    keys = ("live", "ready", "breaker", "draining", "queue_depth",
            "inflight", "buckets")

    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=2,
                                    slo_ms=1000)
        seen = [{k: srv.health()[k] for k in keys}]
        srv.start(warm=True)
        seen.append({k: srv.health()[k] for k in keys})
        ewma = sorted(srv.health()["ewma_ms"])
        srv.drain()
        seen.append({k: srv.health()[k] for k in keys})
        srv.close()
        seen.append({k: srv.health()[k] for k in keys})
        return {"seen": seen, "ewma_buckets": ewma}

    res = _both(drill)
    assert [(s["live"], s["ready"]) for s in res["seen"]] == [
        (False, False), (True, True), (True, False), (False, False)]
    assert res["ewma_buckets"] == [1, 2]


def test_warm_start_seeds_the_steady_latency_for_artifacts_too():
    """A loaded program whose first call is slow (the reference's
    ``jax.export`` program compiles there, the port's graph is captured
    there): the port's warm-up times a second call for every server, so
    at the default 100 ms SLO a request is admitted; the reference's
    skips it for an AOT server, seeds its EWMA with the first call and
    sheds the request at admission (``'deadline'``)."""
    def slow_first():
        calls = []

        def model(xb):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(0.5)
            return xb * 2.0 + 1.0

        return model

    got = {}
    for name, p in PKGS.items():
        srv = p.serving.ModelServer(slow_first(), (2,), max_batch=2,
                                    aot=True)
        srv.start(warm=True)
        try:
            got[name] = _outcome(srv.submit(_z()))
        except p.serving.ServeRejected as e:
            got[name] = ("shed", e.reason)
        finally:
            srv.close()
    assert got == {"ref": ("shed", "deadline"), "port": ("ok", [1.0, 1.0])}


def test_wait_estimate_is_per_bucket_not_max():
    def drill(p):
        srv = p.serving.ModelServer(_Gated(), (2,), max_batch=64,
                                    slo_ms=200.0, coalesce_ms=0.5)
        srv.start(warm=False)
        try:
            with srv._cond:
                srv._ewma = {64: 1.0}
                small = srv._ewma_for_locked(1)
                large = srv._ewma_for_locked(64)
            out = _outcome(srv.submit(_z()), timeout=5)
            with srv._cond:
                srv._ewma[1] = 0.004
                direct = srv._ewma_for_locked(1)
            return [small, large, out, direct]
        finally:
            srv.close()

    assert _both(drill) == [1.0 / 64, 1.0, ("ok", [1.0, 1.0]), 0.004]


def test_default_buckets_match_reference():
    for args in ((8,), (32,), (32, 2), (12, 3), (1,)):
        assert tserving.default_buckets(*args) == \
            jserving.default_buckets(*args)
    with pytest.raises(MXNetError, match="not a multiple"):
        tserving.default_buckets(6, step=4)


# ----------------------------------------------- the artifact and the race
def _dense(pkg, prefix=None):
    net = pkg.gluon.nn.Dense(5, in_units=3, prefix=prefix)
    return net


def test_aot_artifact_serving_matches_the_model(tmp_path):
    """The port's artifact through ``from_artifact`` answers as the net
    and as the reference's artifact server does (1e-5)."""
    onp.random.seed(3)
    tnet = _dense(tmx)
    tnet.initialize(tmx.init.Xavier())
    f = str(tmp_path / "w.params")
    tnet.save_parameters(f)
    jnet = _dense(jmx, prefix=tnet.prefix)
    jnet.initialize()
    jnet.load_parameters(f)
    tp, jp = str(tmp_path / "t.mxje"), str(tmp_path / "j.mxje")
    tmx.deploy.export_model(tnet, onp.zeros((4, 3), "float32"), tp)
    jmx.deploy.export_model(jnet, jmx.nd.zeros((4, 3)), jp,
                            platforms=("cpu",))
    x = onp.random.rand(3).astype("float32")
    outs, reports = {}, {}
    for name, mod, path in (("port", tserving, tp), ("ref", jserving, jp)):
        srv = mod.ModelServer.from_artifact(path, slo_ms=30000,
                                            coalesce_ms=1.0)
        srv.start(warm=True)
        try:
            assert srv.aot is True and srv.buckets == (4,)
            outs[name] = srv.submit(x).result(timeout=30)
            reports[name] = srv.warm_report()
        finally:
            srv.close()
    want = tnet(tmx.nd.array(x[None])).asnumpy()[0]
    onp.testing.assert_allclose(outs["port"], want, rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(outs["port"], outs["ref"], rtol=1e-5,
                                atol=1e-5)
    for r in reports.values():
        r.pop("warm_start_s")
    assert reports["port"] == reports["ref"]


def test_from_artifact_refuses_a_reference_artifact(tmp_path):
    jnet = _dense(jmx)
    jnet.initialize()
    jp = str(tmp_path / "j.mxje")
    jmx.deploy.export_model(jnet, jmx.nd.zeros((4, 3)), jp,
                            platforms=("cpu",))
    with pytest.raises(MXNetError, match="StableHLO") as e:
        tserving.ModelServer.from_artifact(jp)
    assert jp in str(e.value)


def test_from_predictor_seeds_buckets_from_tuned_winner(tmp_path,
                                                        monkeypatch):
    """The persisted ``tune_microbatch`` winner seeds the bucket plan in
    both packages; a second server (fresh-process semantics via
    ``cache_clear``) reloads the winner without timing again."""
    from mxnet_tpu_torch import autotune as t_at
    from mxnet_tpu_torch.parallel import functionalize

    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    t_at.cache_clear()
    onp.random.seed(0)
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    params, apply_fn = functionalize(net, train=False)
    ex = onp.random.rand(4, 4).astype("float32")
    plans = {}
    for name in ("port", "ref"):
        if name == "port":
            srv = tserving.ModelServer.from_predictor(
                apply_fn, params, ex, candidates=(1, 2), tune_iters=2,
                slo_ms=30000)
        else:
            from mxnet_tpu.parallel import functionalize as jfunc

            jnet = jmx.gluon.nn.Dense(3, in_units=4)
            jnet.initialize()
            jp, japply = jfunc(jnet, train=False)
            srv = jserving.ModelServer.from_predictor(
                japply, jp, ex, candidates=(1, 2), tune_iters=2,
                slo_ms=30000)
        k, _unroll = srv.microbatch
        plans[name] = srv.buckets == tserving.default_buckets(4, step=k)
        if name == "port":
            srv.start(warm=True)
            try:
                out = srv.submit(ex[0]).result(timeout=30)
                ref = net(tmx.nd.array(ex[:1])).asnumpy()[0]
                onp.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
            finally:
                srv.close()
            winner = srv.microbatch
    assert plans == {"port": True, "ref": True}
    assert os.path.exists(tmp_path / "autotune.json")
    t_at.cache_clear()

    def no_timing(*a, **k):
        raise AssertionError("the cached winner was timed again")

    monkeypatch.setattr(t_at, "time_call", no_timing)
    srv2 = tserving.ModelServer.from_predictor(
        apply_fn, params, ex, candidates=(1, 2), tune_iters=2,
        slo_ms=30000)
    assert srv2.microbatch == winner
    t_at.cache_clear()


def test_what_waits_for_a12_raises(monkeypatch, tmp_path):
    """What waited for ROADMAP §A 12 is ported: ``watchdog_sec`` and
    ``MXNET_WATCHDOG_SEC`` arm the batcher's watchdog, and a server
    serves with ``MXNET_RUNLOG`` set (an unusable path disables the run
    log with a warning, as the reference does); nothing raises."""
    from mxnet_tpu_torch import telemetry as t_tm

    def model(xb):
        return xb * 2.0

    for kw, env in (({"watchdog_sec": 5.0}, None),
                    ({}, ("MXNET_WATCHDOG_SEC", "3"))):
        if env:
            monkeypatch.setenv(*env)
        with tmx.cpu():
            srv = tserving.ModelServer(model, (2,), max_batch=2, **kw)
            srv.start(warm=True)
        try:
            assert srv._wd is not None and srv._wd._thread is not None
            onp.testing.assert_array_equal(
                srv.submit(onp.ones(2, "float32")).result(timeout=30),
                [2.0, 2.0])
        finally:
            srv.close()
        assert srv._wd is None
    monkeypatch.delenv("MXNET_WATCHDOG_SEC")
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("MXNET_RUNLOG", str(blocker / "run.jsonl"))
    t_tm.close()
    try:
        with pytest.warns(UserWarning, match="telemetry disabled"):
            with tmx.cpu():
                srv = tserving.ModelServer(model, (2,), max_batch=2)
                srv.start(warm=True)
        srv.submit(onp.ones(2, "float32")).result(timeout=30)
        srv.close()
    finally:
        monkeypatch.delenv("MXNET_RUNLOG")
        t_tm.close()


def test_serving_env_names_match_reference():
    from mxnet_tpu import config as jcfg
    from mxnet_tpu_torch import config as tcfg

    for name in ("MXNET_SERVE_SLO_MS", "MXNET_SERVE_QUEUE_DEPTH",
                 "MXNET_SERVE_MAX_INFLIGHT", "MXNET_SERVE_BREAKER_LIMIT",
                 "MXNET_FLEET_HBM_BUDGET_MB", "MXNET_FLEET_PORT",
                 "MXNET_WATCHDOG_SEC"):
        assert tcfg.get_env(name) == jcfg.get_env(name)
        assert tcfg._ENV[name].type is jcfg._ENV[name].type


# ------------------------------------------------------- the device lock
def test_device_lock_keeps_captures_exclusive():
    """Threads in ``_graph.DeviceLock``'s shared sections (some nested,
    some asking for the lock exclusively from inside one, as a batcher
    whose bucket captures does) and threads in exclusive sections: no
    exclusive section ever overlaps another section, nothing deadlocks,
    and every section ran."""
    from mxnet_tpu_torch.gluon._graph import DeviceLock

    lock = DeviceLock()
    state = {"shared": 0, "exclusive": 0, "bad": 0, "done": 0}
    guard = threading.Lock()

    def enter(kind):
        with guard:
            state[kind] += 1
            if state["exclusive"] > 1 or (state["exclusive"]
                                          and state["shared"]):
                state["bad"] += 1

    def leave(kind):
        with guard:
            state[kind] -= 1
            state["done"] += 1

    def reader(k):
        for i in range(200):
            with lock.shared():
                enter("shared")
                with lock.shared():  # nested
                    pass
                leave("shared")
                if (i + k) % 25 == 0:  # a capture from a batch
                    with lock.exclusive():
                        enter("exclusive")
                        leave("exclusive")

    def writer():
        for _ in range(100):
            with lock.exclusive():
                enter("exclusive")
                with lock.exclusive():  # nested
                    pass
                leave("exclusive")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=reader, args=(k,)) for k in range(12)]
        ts += [threading.Thread(target=writer) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts), "the lock deadlocked"
    assert state["bad"] == 0
    assert state["done"] == 12 * (200 + 8) + 4 * 100


# --------------------------------------------------------- SIGTERM drain
def test_sigterm_drain_exits_clean(tmp_path):
    """SIGTERM mid-traffic: admitted requests finish, later ones are
    rejected structured, the report flushes and the exit is the signal
    death the orchestrator expects (rc -15)."""
    out_json = str(tmp_path / "drain.json")
    env = dict(os.environ)
    env.pop("MXNET_FAULT_SPEC", None)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "drain", out_json],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ready = out_json + ".ready"
        # the worker starts torch under the load of the other test
        # workers: its start-up alone can take a minute
        deadline = time.monotonic() + 240
        while not os.path.exists(ready) and time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("worker died early: "
                            + proc.stderr.read()[-2000:])
            time.sleep(0.05)
        assert os.path.exists(ready), "worker never started serving"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGTERM
    with open(out_json) as f:
        report = json.load(f)
    assert report["submitted"] > 0
    assert report["terminal"] == report["submitted"]
    assert report["completed"] >= 5
    assert not report["errors"], report["errors"]
    assert report["health_after_drain"]["ready"] is False


def _drain_worker(out_json):
    """Serve on the main thread through ``run_until_drained`` while a
    thread submits; on SIGTERM write the outcome report."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ModelServer, ServeRejected

    outcome = {"handles": [], "rejections": [], "errors": []}
    stop = threading.Event()

    def model(xb):
        time.sleep(0.002)
        return xb * 2.0 + 1.0

    with mx.cpu():
        srv = ModelServer(model, (3,), max_batch=4, slo_ms=30000,
                          coalesce_ms=1.0)
        srv.start(warm=True)

    def traffic():
        x = onp.ones((3,), "float32")
        while not stop.is_set():
            try:
                outcome["handles"].append(srv.submit(x, deadline_ms=5000))
            except ServeRejected as e:
                outcome["rejections"].append(e.reason)
                if e.reason in ("draining", "shutdown"):
                    return
            time.sleep(0.002)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()

    def announce():
        # ready only once run_until_drained's SIGTERM handler is in
        # place (a signal before it kills the worker with no report)
        # and at least 5 requests completed, however slow the host
        _until(lambda: len(outcome["handles"]) >= 20
               and sum(h.ok for h in list(outcome["handles"])) >= 5
               and signal.getsignal(signal.SIGTERM)
               not in (signal.SIG_DFL, signal.SIG_IGN, None),
               timeout=200)
        open(out_json + ".ready", "w").close()

    threading.Thread(target=announce, daemon=True).start()

    def on_drained(server):
        stop.set()
        t.join(timeout=10)
        hs = outcome["handles"]
        for h in hs:
            try:
                h.result(timeout=0.1)
            except ServeRejected:
                pass
            except Exception as e:  # noqa: BLE001
                outcome["errors"].append(repr(e))
        with open(out_json, "w") as f:
            json.dump({"submitted": len(hs),
                       "terminal": sum(h.done for h in hs),
                       "completed": sum(h.ok for h in hs),
                       "errors": outcome["errors"],
                       "health_after_drain": server.health()}, f)

    srv.run_until_drained(on_drained=on_drained)


if __name__ == "__main__":
    if sys.argv[1] == "drain":
        _drain_worker(sys.argv[2])
