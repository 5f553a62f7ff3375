"""The port's run log held against the JAX package's on the CPU.

Both packages arm ``MXNET_RUNLOG`` at a precise point
(``telemetry.reset(path)``) and drive the same program; the port's run
log must pass the reference's schema and the port's own copy with no
problems, carry the same sequence of record types, and name the same
retrace causes.  Where an eager step cannot say what XLA says (the
``program_report``'s memory and FLOPs) the divergence is pinned.

Sizes: a tiny channel-last ResNetV1 (widths 8..128, input 32x32, batch
4 then 2) and a Dense(8) step; every comparison is exact (record types,
causes, counters) unless a tolerance is stated.
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import initializer as j_init  # noqa: E402
from mxnet_tpu import nd  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu import telemetry as j_tm  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res  # noqa: E402
from mxnet_tpu.resilience import faultsim as j_faultsim  # noqa: E402
from mxnet_tpu.telemetry import opstats as j_opstats  # noqa: E402
from mxnet_tpu.telemetry import schema as j_schema  # noqa: E402

from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch import telemetry as t_tm  # noqa: E402
from mxnet_tpu_torch.gluon import loss as t_loss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_faultsim  # noqa: E402
from mxnet_tpu_torch.telemetry import opstats as t_opstats  # noqa: E402
from mxnet_tpu_torch.telemetry import schema as t_schema  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = [8, 16, 32, 64, 128]
PREFIX = "resnetv10_"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_RUNLOG", "MXNET_NUMERICS", "MXNET_NUMERICS_SAMPLE",
                "MXNET_TELEMETRY_SAMPLE", "MXNET_FAULT_SPEC",
                "MXNET_METRICS_TEXTFILE", "MXNET_WATCHDOG_SEC"):
        monkeypatch.delenv(var, raising=False)
    for pkg in (j_tm, t_tm):
        pkg.close()
    yield
    for pkg in (j_tm, t_tm):
        pkg.close()
    j_faultsim.reset("")
    t_faultsim.reset("")


def _read(path):
    """(records, reference-schema problems, port-schema problems)."""
    with open(path) as f:
        lines = f.readlines()
    recs, j_probs = j_schema.validate_lines(lines)
    _, t_probs = t_schema.validate_lines(lines)
    return recs, j_probs, t_probs


# ------------------------------------------------------------- the schema
@pytest.mark.parametrize("name", [
    "STEP_FIELDS", "RECORD_TYPES", "COMPILE_CAUSES", "SPAN_FIELDS",
    "TRACE_FIELDS", "SERVE_FIELDS", "GENERATE_FIELDS", "FLEET_FIELDS",
    "HEAL_FIELDS", "DATA_FIELDS", "QUANT_FIELDS", "FRESHNESS_FIELDS",
    "OPSTATS_ROW_FIELDS", "TENSOR_STATS_ROW_FIELDS"])
def test_schema_copy_is_field_for_field(name):
    assert getattr(t_schema, name) == getattr(j_schema, name)


@pytest.mark.parametrize("rec", [
    {"type": "compile", "t": 0.1, "program": "p", "cache": "maybe",
     "causes": ["first_trace"], "fingerprint": {}},
    {"type": "compile", "t": 0.1, "program": "p", "cache": "miss",
     "causes": ["weather"], "fingerprint": {}},
    {"type": "span", "t": 1.0, "name": "s", "kind": "internal",
     "dur_ms": 1.0, "trace_id": "ab", "span_id": "0" * 16,
     "parent_span_id": None},
    {"type": "bogus", "t": 0.0},
    {"type": "step", "t": 0.0},
    {"type": "tensor_stats", "t": 0.0, "step": 0, "where": "grad",
     "nonfinite": False, "tensors": {"w": {"l2": 1.0}}},
    "not a record",
])
def test_validate_record_problems_match(rec):
    assert t_schema.validate_record(rec) == j_schema.validate_record(rec)
    assert t_schema.validate_record(rec)


# --------------------------------------------------------- record writers
def _drive_writers(tm, path):
    """Every writer of the RunLog once, the same calls in both."""
    rl = tm.reset(path)
    rl.set_context(sharding="ps")
    rl.compile_event("p", tm.compile_fingerprint((4, 3), "float32", True))
    rl.compile_event("p", tm.compile_fingerprint((2, 3), "float32", True))
    rl.compile_event("p", tm.compile_fingerprint((2, 3), "float16", True,
                                                 hyper={"lr": 0.1}))
    rl.program_report("p", memory={"argument_bytes": 8}, flops=10.0)
    for i in range(3):
        rl.step(0, i, 0.01, 4, loss=1.0 if i == 2 else None,
                synced=(i == 2))
    rl.checkpoint_event("ck", 1, 0.5, 100)
    rl.checkpoint_event("ck", 1, 0.5, 100, reason="fallback")
    rl.watchdog("fit", 3.0, None)
    rl.opstats({"relu": {"count": 1, "total_us": 1.0, "min_us": 1.0,
                         "max_us": 1.0, "avg_us": 1.0, "p99_us": 1.0,
                         "bytes": None}})
    rl.tensor_stats(0, {"w": {"l2": 1.0, "min": 0.0, "max": 1.0,
                              "nan": 0, "inf": 0, "zero_frac": 0.5}})
    rl.serve(model="m", batch=3, padded_to=4, queue_depth=0,
             latency_ms=1.0, deadline_margin_ms=5.0, shed=0)
    rl.generate(name="g", tokens=5, tokens_s=10.0, ttft_p50_ms=1.0,
                ttft_p99_ms=2.0, in_flight=1, max_in_flight=8,
                evictions=0, shed=0, pages_in_use=3, queue_depth=0,
                kv_dtype="float32", compiles=0)
    rl.fleet(action="probe", replicas=1, ready=1, queue_depth=0,
             queue_ewma=0.0, requests=1, failovers=0, shed=0)
    rl.heal("peer_death", rank=1)
    rl.data_plane("epoch_end", workers=2)
    rl.quantize("rewrite", mode="naive", layers=3)
    rl.freshness("publish", version=2, freshness_ms=5.0)
    rl.span("s", 0.0, 0.001, trace_id="a" * 32, span_id="b" * 16)
    rl.event("bad_step", step=3)
    rl.count("faults")
    rl.gauge("serve_ready", 1)
    assert rl.flight_dump("test") is not None
    counters = dict(rl.counters)
    tm.close()
    return counters


def test_every_writer_validates_and_matches_reference(tmp_path):
    jc = _drive_writers(j_tm, str(tmp_path / "j.jsonl"))
    tc = _drive_writers(t_tm, str(tmp_path / "t.jsonl"))
    assert tc == jc
    j_recs, _, _ = _read(tmp_path / "j.jsonl")
    t_recs, j_probs, t_probs = _read(tmp_path / "t.jsonl")
    assert not j_probs and not t_probs, (j_probs, t_probs)
    assert [r["type"] for r in t_recs] == [r["type"] for r in j_recs]
    # the same bodies, but for the clocks and the process snapshot
    skip = {"t", "time", "pid", "parent_pid", "env", "path", "jax",
            "torch"}
    for t_rec, j_rec in zip(t_recs, j_recs):
        assert {k: v for k, v in t_rec.items() if k not in skip} == \
            {k: v for k, v in j_rec.items() if k not in skip}, t_rec
    start = t_recs[0]
    assert start["torch"]["version"] == torch.__version__
    assert "jax" not in start


def test_flight_dump_and_textfile(tmp_path):
    path = str(tmp_path / "run.jsonl")
    text = str(tmp_path / "metrics.prom")
    rl = t_tm.RunLog(path, sample=2, flight_depth=3, textfile=text)
    for i in range(5):
        rl.step(0, i, 0.01, 8, synced=rl.should_sync(i))
    dump = rl.flight_dump("unit")
    assert dump == t_tm.flight_path_for(path)
    assert t_tm.find_flight_dumps(path) == [dump]
    with open(dump) as f:
        doc = json.load(f)
    assert doc["reason"] == "unit"
    assert [s["step"] for s in doc["steps"]] == [2, 3, 4]
    rl.gauge('serve_ready{model="m"}', 1)
    rl.close()
    with open(text) as f:
        prom = f.read()
    for row in ("mxnet_tpu_steps 5", "mxnet_tpu_retrace_total 0",
                "mxnet_tpu_watchdog_stalls_total 0",
                "# TYPE mxnet_tpu_serve_ready gauge",
                'mxnet_tpu_serve_ready{model="m"} 1'):
        assert row in prom
    recs, j_probs, t_probs = _read(path)
    assert not j_probs and not t_probs
    # unsampled steps flush with the next sampled one: all five landed
    assert sum(r["type"] == "step" for r in recs) == 5


def test_unusable_runlog_path_disables_with_warning(monkeypatch,
                                                    tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("MXNET_RUNLOG", str(blocker / "run.jsonl"))
    t_tm.close()
    with pytest.warns(UserWarning, match="telemetry disabled"):
        assert t_tm.current() is None


# ----------------------------------------------------- the train step log
@pytest.fixture(scope="module")
def resnet_weights():
    mx.random.seed(0)
    onp.random.seed(0)
    with j_nn.default_layout("NHWC"):
        net = j_res.ResNetV1(j_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, no_bias=True, prefix=PREFIX)
    net.initialize(j_init.Xavier())
    net(nd.array(onp.zeros((1, 32, 32, 3), "float32")))
    return net, {n: onp.asarray(p.data().asnumpy())
                 for n, p in net.collect_params().items()}


#: 3 steps, a batch-size change, a dtype change, then the first
#: signature again (a cache hit)
_SIGNATURES = [(4, "float32")] * 3 + [(2, "float32"), (2, "float16"),
                                      (4, "float32")]


def _batches():
    rng = onp.random.RandomState(3)
    for n, dt in _SIGNATURES:
        yield (rng.randn(n, 32, 32, 3).astype(dt),
               rng.randint(0, 10, n).astype("float32"))


_STEP_KW = dict(learning_rate=0.1, momentum=0.9, loss_scale="dynamic",
                compute_dtype="bfloat16", bucket_bound=30000,
                optimizer_sharding="ps")


def _jax_train_log(net, path):
    j_tm.reset(path)
    mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
    with j_at.force(pallas_bnreluconv="pallas", fused_bucket_opt="pallas"):
        step, p, s = j_par.make_train_step(
            net, j_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            mesh=mesh, donate=False, **_STEP_KW)
        for i, (x, y) in enumerate(_batches()):
            loss, p, s = step(p, s, x, y, jax.random.key(0), float(i + 1))
    j_tm.close()


def _port_train_log(weights, path):
    with t_nn.default_layout("NHWC"):
        net = t_res.ResNetV1(t_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, no_bias=True, prefix=PREFIX)
    net.initialize(device="cpu")
    t_par.load_jax_params(net, weights)
    t_tm.reset(path)
    with t_at.force(pallas_bnreluconv="pallas", fused_bucket_opt="pallas"):
        step, p, s = t_par.make_train_step(
            net, t_loss.SoftmaxCrossEntropyLoss(), "sgd",
            mesh=t_par.get_mesh(devices=["cpu"]), **_STEP_KW)
        losses = []
        for i, (x, y) in enumerate(_batches()):
            loss, p, s = step(p, s, torch.from_numpy(x),
                              torch.from_numpy(y), None, float(i + 1))
            losses.append(float(loss))
    t_tm.close()
    return losses


@pytest.fixture(scope="module")
def train_logs(resnet_weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("trainlog")
    net, weights = resnet_weights
    for var in ("MXNET_NUMERICS", "MXNET_FAULT_SPEC"):
        os.environ.pop(var, None)
    _jax_train_log(net, str(d / "j.jsonl"))
    losses = _port_train_log(weights, str(d / "t.jsonl"))
    return _read(d / "j.jsonl")[0], _read(d / "t.jsonl"), losses


def test_train_step_log_validates_under_both_schemas(train_logs):
    _, (recs, j_probs, t_probs), losses = train_logs
    assert not j_probs, j_probs
    assert not t_probs, t_probs
    assert all(onp.isfinite(losses))


def test_train_step_log_has_reference_record_sequence(train_logs):
    j_recs, (t_recs, _, _), _ = train_logs
    assert [r["type"] for r in t_recs] == [r["type"] for r in j_recs]
    assert [r["type"] for r in t_recs] == [
        "run_start", "compile", "program_report", "compile",
        "program_report", "compile", "program_report", "compile",
        "run_end"]


def test_train_step_compile_records_match_reference(train_logs):
    j_recs, (t_recs, _, _), _ = train_logs

    def compiles(recs):
        return [(r["program"], r["cache"], r["causes"],
                 r["fingerprint"]["shape"], r["fingerprint"]["dtype"],
                 r["fingerprint"]["sharding"])
                for r in recs if r["type"] == "compile"]

    assert compiles(t_recs) == compiles(j_recs)
    assert [c[1:3] for c in compiles(t_recs)] == [
        ("miss", ["first_trace"]), ("miss", ["shape"]),
        ("miss", ["dtype"]), ("hit", ["dtype", "shape"])]
    t_end = t_recs[-1]["counters"]
    j_end = j_recs[-1]["counters"]
    assert t_end == j_end


def test_train_step_program_report_divergence(train_logs):
    """Pinned divergence: the reference reports what XLA's compiled
    program says (``memory_analysis``: five byte counts; ``cost_analysis``
    FLOPs of every HLO op; HLO collectives of the one-device mesh); the
    port measures one eager call (argument/output bytes of the call's
    tensors, with ``temp_bytes``/``peak_bytes`` only on a card; FLOPs of
    the aten products plus the hand-written kernels' formulas;
    ``bytes_accessed`` 0.0 and ``collectives`` None)."""
    j_recs, (t_recs, _, _), _ = train_logs
    t_reps = [r for r in t_recs if r["type"] == "program_report"]
    j_reps = [r for r in j_recs if r["type"] == "program_report"]
    required = {"t", "program", "memory", "flops", "collectives"}
    for rep in t_reps:
        assert required <= set(rep)
        assert rep["program"] == "train_step"
        assert set(rep["memory"]) == {"argument_bytes", "output_bytes"}
        assert rep["bytes_accessed"] == 0.0
        assert rep["collectives"] is None
        assert rep["flops"] > 0
    for rep in j_reps:
        assert "temp_bytes" in rep["memory"]
    # the products scale with the batch: batch 2 does half of batch 4's
    assert t_reps[1]["flops"] == pytest.approx(t_reps[0]["flops"] / 2)
    assert t_reps[2]["flops"] == t_reps[1]["flops"]
    # the batch is an argument: 2 rows less of 32x32x3 fp32 (and 2 fp32
    # labels) after the shape change, and fp16 rows take half the bytes
    row = 32 * 32 * 3
    a = [r["memory"]["argument_bytes"] for r in t_reps]
    assert a[0] - a[1] == 2 * row * 4 + 2 * 4
    assert a[1] - a[2] == 2 * row * 2


def test_describe_program_counts_products_and_kernel_formulas():
    """FLOPs of a Dense step: FlopCounterMode's aten products, plus what
    a kernel wrapper reports through ``kernel_flops`` during the call."""
    from mxnet_tpu_torch.telemetry import runlog

    w = torch.randn(6, 8)

    def fn(x):
        runlog.kernel_flops(1000)
        return x @ w

    x = torch.randn(4, 6)
    out, rep = t_tm.describe_call(fn, x, program="p", record=False)
    assert torch.equal(out, x @ w)
    assert rep["flops"] == 2 * 4 * 6 * 8 + 1000
    assert rep["memory"] == {"argument_bytes": 4 * 6 * 4,
                             "output_bytes": 4 * 8 * 4}
    runlog.kernel_flops(5)  # outside a description: counted nowhere
    assert t_tm.describe_program(fn, x, record=False)["flops"] == \
        rep["flops"]


# ------------------------------------------------------------- unarmed
def _dense_steps(pkg, **kw):
    rng = onp.random.RandomState(0)
    w = rng.randn(8, 6).astype("float32")
    b = rng.randn(8).astype("float32")
    if pkg == "jax":
        net = j_nn.Dense(8, in_units=6, prefix="dense0_")
        net.initialize()
        net.weight.set_data(nd.array(w))
        net.bias.set_data(nd.array(b))
        return j_par.make_train_step(net, j_gluon.loss.L2Loss(), "sgd",
                                     learning_rate=0.1, donate=False, **kw)
    net = t_nn.Dense(8, in_units=6, prefix="dense0_")
    net.initialize(device="cpu")
    t_par.load_jax_params(net, {"dense0_weight": w, "dense0_bias": b})
    return t_par.make_train_step(net, t_loss.L2Loss(), "sgd",
                                 learning_rate=0.1, donate=False,
                                 device="cpu", **kw)


def _dense_batch(i):
    rng = onp.random.RandomState(10 + i)
    return (rng.randn(4, 6).astype("float32"),
            rng.randn(4, 8).astype("float32"))


def _run_port_dense(n, **kw):
    step, p, s = _dense_steps("port", **kw)
    out = []
    for i in range(n):
        x, y = _dense_batch(i)
        loss, p, s = step(p, s, torch.from_numpy(x), torch.from_numpy(y),
                          None, float(i + 1))
        out.append((loss, p, s))
    return out


def _mesh_winner_compiles(pkg, path):
    """Two builds of the dense step on the one-device mesh, a
    ``conv1x1_dot`` winner recorded under the mesh key between them;
    ``(causes, fingerprint winners)`` of the train step's compile
    records."""
    tm, at = (j_tm, j_at) if pkg == "jax" else (t_tm, t_at)
    mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",)) \
        if pkg == "jax" else t_par.get_mesh(devices=["cpu"])
    x, y = _dense_batch(0)
    tm.reset(path)
    for i in range(3):
        if i == 1:
            # a winner under the mesh-less key names no cause
            at.record("conv1x1_dot", x.shape, "float32", winner="dot",
                      platform="cpu", mesh="none")
        if i == 2:
            at.record("conv1x1_dot", x.shape, "float32", winner="dot",
                      platform="cpu", mesh="data=1")
        step, p, s = _dense_steps(pkg, mesh=mesh)
        if pkg == "jax":
            step(p, s, x, y, jax.random.key(0), 1.0)
        else:
            step(p, s, torch.from_numpy(x), torch.from_numpy(y), None, 1.0)
    tm.close()
    recs = _read(path)[0]
    return [(r["causes"], r["fingerprint"]["autotune"]) for r in recs
            if r["type"] == "compile" and r["program"] == "train_step"]


def test_retrace_cause_names_a_winner_under_the_mesh_key(tmp_path,
                                                         monkeypatch):
    """The fingerprint's winners are those of the step's ``variant_ops``
    under its mesh key, as the reference's: a winner recorded for the
    one-device mesh names ``autotune_winner`` as the cause of the next
    build's compile record, one recorded without the mesh does not."""
    got = {}
    for pkg in ("jax", "port"):
        monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path / pkg))
        j_at.cache_clear()
        t_at.cache_clear()
        got[pkg] = _mesh_winner_compiles(pkg, str(tmp_path / f"{pkg}.jsonl"))
    j_at.cache_clear()
    t_at.cache_clear()
    assert got["port"] == got["jax"]
    assert got["port"][-1] == (["autotune_winner"], {"conv1x1_dot": "dot"})


def test_unarmed_step_is_bit_identical_and_has_no_numerics(tmp_path,
                                                          monkeypatch):
    plain = _run_port_dense(3)
    assert all("_numerics" not in s for _, _, s in plain)
    t_tm.reset(str(tmp_path / "run.jsonl"))
    logged = _run_port_dense(3)
    t_tm.close()
    monkeypatch.setenv("MXNET_NUMERICS", "1")
    t_tm.reset(str(tmp_path / "run2.jsonl"))
    monitored = _run_port_dense(3)
    t_tm.close()
    for (l0, p0, s0), (l1, p1, s1), (l2, p2, s2) in zip(plain, logged,
                                                        monitored):
        assert torch.equal(l0, l1) and torch.equal(l0, l2)
        for n in p0:
            assert torch.equal(p0[n], p1[n]) and torch.equal(p0[n], p2[n])
        assert set(s1) == set(s0)
        assert set(s2) == set(s0) | {"_numerics"}
        for n in s0:
            for a, b, c in zip(s0[n], s1[n], s2[n]):
                assert torch.equal(a, b) and torch.equal(a, c)


# --------------------------------------------------------- fault points
def test_step_loss_nan_counts_one_bad_step_like_reference(tmp_path):
    """``step.loss_nan:nan@2`` poisons the second batch before the step:
    the guard of both packages holds the update once and counts one bad
    step, then a finite step resets the count; the run log counts the
    fault."""
    got = {}
    for pkg, fs, tm in (("jax", j_faultsim, j_tm),
                        ("port", t_faultsim, t_tm)):
        fs.reset("step.loss_nan:nan@2")
        tm.reset(str(tmp_path / f"{pkg}.jsonl"))
        step, p, s = _dense_steps(pkg, nan_guard=True)
        bad = []
        for i in range(3):
            x, y = _dense_batch(i)
            if pkg == "jax":
                loss, p, s = step(p, s, x, y, jax.random.key(0),
                                  float(i + 1))
            else:
                loss, p, s = step(p, s, torch.from_numpy(x),
                                  torch.from_numpy(y), None, float(i + 1))
            bad.append(int(s["_bad_steps"]))
        got[pkg] = (bad, fs.hits("step.loss_nan"),
                    tm.current().counters["faults"])
        tm.close()
        fs.reset("")
        recs, j_probs, t_probs = _read(tmp_path / f"{pkg}.jsonl")
        assert not j_probs and not t_probs
        faults = [r for r in recs if r["type"] == "event"
                  and r["kind"] == "fault"]
        assert [(r["point"], r["action"], r["hit"]) for r in faults] == \
            [("step.loss_nan", "nan", 2)]
    assert got["port"] == got["jax"] == ([0, 1, 0], 3, 1)


def test_faultsim_armed_probe_and_points_match_reference():
    for fs in (j_faultsim, t_faultsim):
        fs.reset("step.loss_nan:delay=0.0@1;step.loss_nan:raise@2-3")
    for fs in (j_faultsim, t_faultsim):
        assert fs.armed("step.loss_nan")
        assert fs.probe("step.loss_nan") == "delay"
        # probe names the action without raising it
        assert fs.probe("step.loss_nan") == "raise"
        with pytest.raises(fs.FaultInjected):
            fs.inject("step.loss_nan")
        assert fs.inject("step.loss_nan") is None
        assert fs.hits("step.loss_nan") == 4
        fs.reset("")
        assert not fs.armed("step.loss_nan")
    assert "step.loss_nan" in t_faultsim.points()


_CRASH_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.resilience import faultsim
rl = telemetry.reset(sys.argv[2])
rl.step(0, 0, 0.01, 4)
faultsim.register_point("unit.crash", "a test point")
faultsim.on_crash(lambda: open(sys.argv[3], "w").write("flushed"))
faultsim.on_crash(lambda: 1 / 0)  # a broken hook must not stop the crash
faultsim.reset("unit.crash:crash@1")
faultsim.inject("unit.crash")
print("survived")
"""


def test_crash_runs_flight_dump_and_hooks_then_exits_87(tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    marker = str(tmp_path / "hook.txt")
    proc = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, _REPO, runlog, marker],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == t_faultsim.CRASH_EXIT_CODE, proc.stderr
    assert "survived" not in proc.stdout
    with open(marker) as f:
        assert f.read() == "flushed"
    dumps = t_tm.find_flight_dumps(runlog)
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        doc = json.load(f)
    assert doc["reason"] == "fault_crash:unit.crash"
    assert doc["counters"]["faults"] == 1


# ---------------------------------------------------------------- opstats
_EVENTS = [{"ph": "X", "cat": "operator", "name": n, "dur": d,
            "args": {"bytes": b} if b else None}
           for n, d, b in [("relu", 3.0, 16), ("relu", 1.0, 16),
                           ("dot", 10.0, None), ("dot", 30.0, None),
                           ("dot", 20.0, None)]] + [
    {"ph": "X", "cat": "telemetry", "name": "step 0", "dur": 99.0},
    {"ph": "i", "cat": "operator", "name": "mark"}]


@pytest.mark.parametrize("fmt", ["table", "json"])
@pytest.mark.parametrize("sort_by", ["total", "avg", "p99", "count",
                                     "bytes"])
def test_opstats_dumps_match_reference(fmt, sort_by):
    assert t_opstats.dumps(format=fmt, sort_by=sort_by, events=_EVENTS) \
        == j_opstats.dumps(format=fmt, sort_by=sort_by, events=_EVENTS)


def test_opstats_aggregate_and_record_match_reference(tmp_path):
    assert t_opstats.aggregate(_EVENTS) == j_opstats.aggregate(_EVENTS)
    assert t_opstats.aggregate(_EVENTS, cat=None) == \
        j_opstats.aggregate(_EVENTS, cat=None)
    t_tm.reset(str(tmp_path / "run.jsonl"))
    rows = t_opstats.record(events=_EVENTS, top=1)
    t_tm.close()
    assert list(rows) == ["dot"]
    recs, j_probs, t_probs = _read(tmp_path / "run.jsonl")
    assert not j_probs and not t_probs
    assert [r["rows"] for r in recs if r["type"] == "opstats"] == [rows]


# ------------------------------------------ records of the other callers
def _records(tm, path, fn):
    tm.reset(str(path))
    try:
        fn()
    finally:
        tm.close()
    recs, j_probs, t_probs = _read(path)
    assert not j_probs and not t_probs, (j_probs, t_probs)
    return recs


def test_cachedop_compile_records_match_reference(tmp_path):
    """A hybridized Dense called at batch 2, 2, 4 and 2 again: a record
    for each new cache entry, with the reference's causes."""
    import mxnet_tpu_torch as tmx

    def drive(pkg):
        net = pkg.gluon.nn.Dense(3, in_units=5, prefix="dense0_")
        net.initialize()
        net.hybridize()
        for n in (2, 2, 4, 2):
            net(pkg.nd.array(onp.ones((n, 5), "float32"))).asnumpy()

    got = {}
    for tag, pkg, tm in (("jax", mx, j_tm), ("port", tmx, t_tm)):
        if tag == "port":
            with tmx.cpu():
                recs = _records(tm, tmp_path / f"{tag}.jsonl",
                                lambda: drive(pkg))
        else:
            recs = _records(tm, tmp_path / f"{tag}.jsonl",
                            lambda: drive(pkg))
        got[tag] = [(r["program"], r["cache"], r["causes"],
                     r["fingerprint"]["shape"], r["fingerprint"]["dtype"],
                     r["fingerprint"]["train"])
                    for r in recs if r["type"] == "compile"]
    assert got["port"] == got["jax"]
    assert [g[2] for g in got["port"]] == [["first_trace"], ["shape"]]


def test_quantize_records_match_reference(tmp_path):
    """calibrate, quantize_net and export_model write the reference's
    ``quantize`` records (action, mode, layers, excluded)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu import deploy as j_deploy
    from mxnet_tpu import quantization as jq
    from mxnet_tpu_torch import deploy as t_deploy
    from mxnet_tpu_torch import quantization as tq

    def drive(pkg, q, deploy, tag):
        nn = pkg.gluon.nn
        onp.random.seed(0)
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                    nn.MaxPool2D(), nn.Flatten(),
                    nn.Dense(10, in_units=8 * 4 * 4))
        net.initialize(pkg.init.Xavier())
        rs = onp.random.RandomState(1)
        batches = [pkg.nd.array(rs.randn(4, 3, 8, 8).astype("float32"))
                   for _ in range(2)]
        calib = q.calibrate(net, batches, mode="naive")
        q.quantize_net(net, calib)
        deploy.export_model(net, onp.zeros((4, 3, 8, 8), "float32"),
                            str(tmp_path / f"{tag}.mxa"))

    got = {}
    for tag, pkg, q, deploy, tm in (
            ("jax", mx, jq, j_deploy, j_tm),
            ("port", tmx, tq, t_deploy, t_tm)):
        def run():
            if tag == "port":
                with tmx.cpu():
                    drive(pkg, q, deploy, tag)
            else:
                drive(pkg, q, deploy, tag)

        recs = _records(tm, tmp_path / f"{tag}.jsonl", run)
        got[tag] = [(r["action"], r["mode"], r["layers"], r["excluded"])
                    for r in recs if r["type"] == "quantize"]
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == ["calibrate", "rewrite",
                                           "export"]


def test_checkpoint_records_match_reference(tmp_path):
    """A CheckpointManager save writes a ``checkpoint`` record; a load
    that falls back past a corrupt version writes one with
    ``reason="fallback"`` and counts ``ckpt_fallbacks``."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.resilience.checkpoint import CheckpointManager as JCM
    from mxnet_tpu_torch.resilience.checkpoint import \
        CheckpointManager as TCM

    def drive(pkg, cm_cls, tag):
        cm = cm_cls(str(tmp_path / tag / "ck"))
        w = pkg.nd.array(onp.arange(6, dtype="float32").reshape(2, 3))
        for v in (1, 2):
            cm.save(v, arg_params={"w": w}, aux_params={})
        with open(cm.params_path(2), "r+b") as f:  # rot the newest
            f.seek(-2, 2)
            f.write(b"\x00\x01")
        assert cm.load()["version"] == 1

    got = {}
    for tag, pkg, cm_cls, tm in (("jax", mx, JCM, j_tm),
                                 ("port", tmx, TCM, t_tm)):
        (tmp_path / tag).mkdir()
        with pkg.cpu():
            recs = _records(tm, tmp_path / f"{tag}.jsonl",
                            lambda: drive(pkg, cm_cls, tag))
        got[tag] = ([(r["version"], r["bytes"], r.get("reason"),
                      r.get("skipped_versions"))
                     for r in recs if r["type"] == "checkpoint"],
                    {k: recs[-1]["counters"][k]
                     for k in ("checkpoints", "ckpt_fallbacks")})
    assert got["port"] == got["jax"]
    assert [c[2] for c in got["port"][0]] == [None, None, "fallback"]
