"""The port's distributed trace context held against the JAX package's
on the CPU.

A ``traceparent`` header (or ``MXNET_TRACE_CONTEXT`` stamp) that one
package writes parses in the other; records written under a bound
context carry its ids; a request through the port's ``ServeFrontend``
and ``ModelServer`` (and a generation through ``GenerativeServer``)
writes ``span`` records that ``tools/tracemerge.py`` merges and
decomposes into queue, coalesce and compute.  Every comparison is
exact.
"""
import http.client
import importlib.util
import json
import os
import threading
import time

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import telemetry as j_tm  # noqa: E402
from mxnet_tpu.telemetry import schema as j_schema  # noqa: E402
from mxnet_tpu.telemetry import tracing as j_tracing  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import telemetry as t_tm  # noqa: E402
from mxnet_tpu_torch.telemetry import schema as t_schema  # noqa: E402
from mxnet_tpu_torch.telemetry import tracing as t_tracing  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tracemerge():
    spec = importlib.util.spec_from_file_location(
        "tracemerge", os.path.join(_REPO, "tools", "tracemerge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_RUNLOG", t_tracing.TRACE_ENV, t_tracing.ROLE_ENV,
                t_tracing.RANK_ENV):
        monkeypatch.delenv(var, raising=False)
    for tr, tm in ((j_tracing, j_tm), (t_tracing, t_tm)):
        tr._reset_process_context()
        tm.close()
    yield
    for tr, tm in ((j_tracing, j_tm), (t_tracing, t_tm)):
        tr._reset_process_context()
        tm.close()


def _read(path):
    with open(path) as f:
        lines = f.readlines()
    recs, j_probs = j_schema.validate_lines(lines)
    _, t_probs = t_schema.validate_lines(lines)
    assert not j_probs and not t_probs, (j_probs[:5], t_probs[:5])
    return recs


# ------------------------------------------------------------- the wire
@pytest.mark.parametrize("writer,reader", [(j_tracing, t_tracing),
                                           (t_tracing, j_tracing)])
def test_traceparent_written_by_one_parses_in_the_other(writer, reader):
    ctx = writer.mint()
    child = ctx.child()
    for c in (ctx, child):
        got = reader.from_header(c.to_header())
        assert (got.trace_id, got.span_id) == (c.trace_id, c.span_id)
        assert got.to_header() == c.to_header()
    assert child.parent_span_id == ctx.span_id
    env = {}
    stamped = writer.stamp_env(env, "replica", rank=2, ctx=ctx)
    got = reader.from_header(env[reader.TRACE_ENV])
    assert got.trace_id == ctx.trace_id == stamped.trace_id
    assert env[reader.ROLE_ENV] == "replica" and env[reader.RANK_ENV] == "2"


@pytest.mark.parametrize("value", [
    None, "", 7, "00-abc", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "1" * 16,
    " 00-" + "a" * 32 + "-" + "1" * 16 + "-01 ",
    "ff-" + "A" * 32 + "-" + "B" * 16 + "-00-extra"])
def test_from_header_matches_reference(value):
    j, t = j_tracing.from_header(value), t_tracing.from_header(value)
    assert (j is None) == (t is None)
    if t is not None:
        assert (t.trace_id, t.span_id, t.parent_span_id) == \
            (j.trace_id, j.span_id, j.parent_span_id)


def test_constants_and_surface_match_reference():
    for name in ("TRACEPARENT_HEADER", "TRACE_ENV", "ROLE_ENV", "RANK_ENV"):
        assert getattr(t_tracing, name) == getattr(j_tracing, name)
    assert t_tracing.__all__ == j_tracing.__all__
    # the port adds describe_call (describe_program's call-and-report)
    assert sorted(set(t_tm.__all__) - {"describe_call"}) == \
        sorted(j_tm.__all__)


def test_thread_stack_and_process_stamp(monkeypatch):
    assert t_tracing.current_context() is None
    ctx = t_tracing.mint()
    with t_tracing.use(ctx):
        assert t_tracing.current_context() is ctx
        inner = ctx.child()
        with t_tracing.use(inner):
            assert t_tracing.current_context() is inner
        seen = []
        th = threading.Thread(
            target=lambda: seen.append(t_tracing.current_context()))
        th.start()
        th.join()
        assert seen == [None]  # the stack is the thread's own
        assert t_tracing.current_context() is ctx
    assert t_tracing.current_context() is None
    # the reference's stamp is the port process's root
    monkeypatch.setenv(t_tracing.TRACE_ENV, j_tracing.mint().to_header())
    t_tracing._reset_process_context()
    got = t_tracing.current_context()
    assert got.to_header() == os.environ[t_tracing.TRACE_ENV]


def test_unarmed_mints_nothing_armed_emits(tmp_path):
    assert not t_tracing.enabled()
    with t_tracing.span("nothing") as ctx:
        assert ctx is None
    env = {t_tracing.TRACE_ENV: "stale"}
    assert t_tracing.stamp_env(env, "replica", rank=0) is None
    assert t_tracing.TRACE_ENV not in env
    path = str(tmp_path / "r.jsonl")
    t_tm.reset(path)
    with t_tracing.span("something", kind="server", k=1) as ctx:
        assert ctx is not None
    with pytest.raises(ValueError):
        with t_tracing.span("failing"):
            raise ValueError("x")
    child = t_tracing.stamp_env({}, "replica", rank=1)
    assert child is not None
    t_tm.close()
    spans = [r for r in _read(path) if r["type"] == "span"]
    assert [s["name"] for s in spans] == ["something", "failing"]
    assert spans[0]["kind"] == "server" and spans[0]["attrs"]["k"] == 1
    assert spans[1]["attrs"]["error"] == "ValueError"


def test_every_record_type_gains_trace_fields(tmp_path):
    path = str(tmp_path / "r.jsonl")
    rl = t_tm.reset(path)
    rl.event("before")
    ctx = t_tracing.mint()
    with t_tracing.use(ctx):
        rl.event("inside")
        rl.heal("relaunch", attempt=1)
        rl.quantize("rewrite", mode="naive", layers=1)
    t_tm.close()
    recs = _read(path)
    events = {r["kind"]: r for r in recs if r["type"] == "event"}
    assert "trace_id" not in events["before"]
    for r in [events["inside"]] + [r for r in recs
                                   if r["type"] in ("heal", "quantize")]:
        assert (r["trace_id"], r["span_id"]) == (ctx.trace_id, ctx.span_id)


def test_run_start_process_identity(tmp_path, monkeypatch):
    monkeypatch.setenv(t_tracing.ROLE_ENV, "replica")
    monkeypatch.setenv(t_tracing.RANK_ENV, "3")
    path = str(tmp_path / "r.jsonl")
    t_tm.reset(path)
    t_tm.close()
    start = _read(path)[0]
    assert (start["type"], start["role"], start["rank"]) == \
        ("run_start", "replica", 3)
    assert start["parent_pid"] == os.getppid()


def test_pid_suffixed_dump_artifacts(tmp_path):
    from mxnet_tpu_torch.telemetry.watchdog import (find_stack_dumps,
                                                    stack_path_for)

    base = str(tmp_path / "r.jsonl")
    assert t_tm.flight_path_for(base) == j_tm.flight_path_for(base)
    assert stack_path_for(base) == \
        j_tm.stack_path_for(base)
    for name in (f"{base}.flight.111.json", f"{base}.flight.222.json",
                 f"{base}.flight.json"):
        with open(name, "w") as f:
            f.write("{}")
    assert sorted(t_tm.find_flight_dumps(base)) == \
        sorted(j_tm.find_flight_dumps(base))
    assert len(t_tm.find_flight_dumps(base)) == 3
    for name in (f"{base}.stacks.111.txt", f"{base}.stacks.txt"):
        with open(name, "w") as f:
            f.write("x")
    assert len(find_stack_dumps(base)) == 2


# ------------------------------------------------------- served requests
def _post(fe, rows, header=None):
    conn = http.client.HTTPConnection(fe.addr, fe.port, timeout=30)
    headers = {"Content-Type": "application/json"}
    if header is not None:
        headers[t_tracing.TRACEPARENT_HEADER] = header
    conn.request("POST", "/v1/predict", body=json.dumps({"inputs": rows}),
                 headers=headers)
    resp = conn.getresponse()
    echoed = resp.getheader(t_tracing.TRACEPARENT_HEADER)
    body = json.loads(resp.read())
    conn.close()
    return resp.status, echoed, body


def _serve(tmp_path, n_requests):
    """Requests through the port's frontend and server, each carrying a
    router-style root: a ``fleet_request`` client span in the caller's
    run log whose context rides the ``traceparent``."""
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.frontend import ServeFrontend

    path = str(tmp_path / "r.jsonl")
    t_tm.reset(path)

    def model(xb):
        time.sleep(0.002)
        return xb * 2.0

    with tmx.cpu():
        srv = ModelServer(model, (3,), max_batch=4, slo_ms=10000,
                          coalesce_ms=1.0, name="m")
        srv.start(warm=True)
    fe = ServeFrontend(srv, port=0)
    fe.start()
    callers = []
    try:
        for i in range(n_requests):
            root = t_tracing.mint()
            t0 = time.perf_counter()
            status, echoed, body = _post(fe, [[0.1 * i, 0.2, 0.3]],
                                         root.to_header())
            t_tracing.emit_span("fleet_request", t0, time.perf_counter(),
                                root, kind="client")
            assert status == 200
            onp.testing.assert_allclose(body["outputs"],
                                        [[0.2 * i, 0.4, 0.6]], rtol=1e-6)
            callers.append((root, echoed))
        # an untraced request of an armed server roots its own trace
        status, echoed, _ = _post(fe, [[1.0, 1.0, 1.0]])
        assert status == 200 and t_tracing.from_header(echoed) is not None
    finally:
        fe.close()
        srv.close()
    t_tm.close()
    return path, callers


def test_frontend_adopts_and_echoes_traceparent(tmp_path):
    path, callers = _serve(tmp_path, 3)
    recs = _read(path)
    spans = [r for r in recs if r["type"] == "span"]
    for root, echoed in callers:
        got = j_tracing.from_header(echoed)  # the reference parses it
        assert got.trace_id == root.trace_id
        mine = {s["name"]: s for s in spans
                if s["trace_id"] == root.trace_id}
        assert set(mine) == {"fleet_request", "replica_request",
                             "serve_queue", "serve_coalesce",
                             "serve_model"}
        req = mine["replica_request"]
        assert req["kind"] == "server"
        assert req["parent_span_id"] == root.span_id
        for name in ("serve_queue", "serve_coalesce", "serve_model"):
            assert mine[name]["parent_span_id"] == req["span_id"]
    serves = [r for r in recs if r["type"] == "serve"]
    assert serves and all(r["model"] == "m" for r in serves)
    compiles = [r for r in recs if r["type"] == "compile"]
    assert [r["program"] for r in compiles] == ["serve:m"] * 3
    assert recs[-1]["counters"]["serve_batches"] >= 4


def test_tracemerge_merges_and_doctor_attributes(tmp_path):
    tm = _tracemerge()
    path, callers = _serve(tmp_path, 4)
    procs = tm.load_runlogs([path])
    assert len(procs) == 1
    merged = tm.merge_trace(procs)
    names = {e.get("name") for e in merged["traceEvents"]}
    assert {"fleet_request", "replica_request", "serve_queue",
            "serve_coalesce", "serve_model"} <= names
    rep = tm.doctor(procs)
    assert rep["requests"] == 4
    pct = rep["components_pct"]
    assert set(pct) == {"queue", "coalesce", "compute", "other"}
    assert pct["compute"] > 0 and pct["coalesce"] >= 0
    assert sum(pct.values()) == pytest.approx(100.0, abs=0.1)
    for r in rep["per_request"]:
        parts = r["parts_ms"]
        assert parts["compute"] > 0
        assert sum(parts.values()) <= r["e2e_ms"] + 1e-6
    assert rep["bottleneck_process"] is not None
    assert tm.main(["doctor", path]) == 0


def test_generation_spans_decompose_under_doctor(tmp_path):
    from mxnet_tpu_torch.serving.generate import GenerativeServer

    tm = _tracemerge()
    path = str(tmp_path / "g.jsonl")
    t_tm.reset(path)
    srv = GenerativeServer(device="cpu", prompt_buckets=(4, 8), max_new=4,
                           slots=2, page_tokens=4, pool_budget=1 << 16,
                           kv_dtype="float32")
    srv.start(warm=True)
    try:
        hs = [srv.submit([1, 2, 3]), srv.submit([4, 5, 6, 7, 8])]
        for h in hs:
            assert len(h.result(timeout=60)) == 4
        rep = srv.report()
    finally:
        srv.close()
    t_tm.close()
    recs = _read(path)
    gens = [r for r in recs if r["type"] == "generate"]
    assert len(gens) == 1 and gens[0]["tokens"] == rep["tokens"]
    spans = [r for r in recs if r["type"] == "span"]
    roots = [s for s in spans if s["name"] == "gen_request"]
    assert len(roots) == 2
    for root in roots:
        mine = {s["name"] for s in spans
                if s["trace_id"] == root["trace_id"]}
        assert mine == {"gen_request", "gen_admit", "gen_prefill",
                        "gen_decode"}
    doc = tm.doctor(tm.load_runlogs([path]))
    assert doc["requests"] == 2
    assert doc["components_pct"]["compute"] > 0
    assert recs[-1]["counters"]["serve_tokens_total"] == rep["tokens"]
