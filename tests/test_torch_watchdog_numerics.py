"""The port's hang watchdog, numerics monitor and fit session held
against the JAX package's on the CPU.

* Watchdog: a quiet heartbeat writes the all-thread stack file and a
  ``watchdog`` record with the flight dump (reason ``stall``); a beaten
  one never fires; ``MXNET_WATCHDOG_SEC`` arms it per ``Module.fit``.
  Timeouts stay under a second.
* Numerics: ``summary`` of the same arrays (planted NaN and Inf
  included) matches the reference's — l2/min/max/zero_frac to a
  relative 1e-6 in fp32, nan/inf exactly; the train step's sampled
  ``tensor_stats`` rows name the same tensors and steps as the
  reference's, and under ``optimizer_sharding='ps'`` both warn and
  write none; ``Module.fit`` and ``Monitor(stat_func="numerics")`` emit
  the same rows.
* A SIGTERM during ``Module.fit`` drains: the flight dump is a whole
  JSON document and the process dies by the signal.
"""
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import nd  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu import telemetry as j_tm  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.telemetry import numerics as j_nm  # noqa: E402
from mxnet_tpu.telemetry import schema as j_schema  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch import telemetry as t_tm  # noqa: E402
from mxnet_tpu_torch.gluon import loss as t_loss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.telemetry import numerics as t_nm  # noqa: E402
from mxnet_tpu_torch.telemetry import schema as t_schema  # noqa: E402
from mxnet_tpu_torch.telemetry.watchdog import Watchdog  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: fp32 summaries of the same array: other summation orders
REL = 1e-6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_RUNLOG", "MXNET_NUMERICS", "MXNET_NUMERICS_SAMPLE",
                "MXNET_WATCHDOG_SEC", "MXNET_TELEMETRY_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    for tm in (j_tm, t_tm):
        tm.close()
    yield
    for tm in (j_tm, t_tm):
        tm.close()


def _read(path):
    with open(path) as f:
        lines = f.readlines()
    recs, j_probs = j_schema.validate_lines(lines)
    _, t_probs = t_schema.validate_lines(lines)
    assert not j_probs and not t_probs, (j_probs[:5], t_probs[:5])
    return recs


def _wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return False


# --------------------------------------------------------------- watchdog
def test_quiet_heartbeat_fires_stack_dump(tmp_path):
    sp = str(tmp_path / "stacks.txt")
    fired = []
    wd = Watchdog(timeout=0.2, stack_path=sp,
                  on_stall=lambda ph, q, p: fired.append((ph, q, p)))
    wd.arm("phase-one")
    try:
        assert _wait_for(lambda: wd.stalls >= 1)
    finally:
        wd.close()
    assert fired[0][0] == "phase-one" and fired[0][1] >= 0.2
    assert fired[0][2] == sp
    with open(sp) as f:
        text = f.read()
    assert "watchdog stall #1" in text and "phase=phase-one" in text
    assert "Thread" in text


def test_beaten_heartbeat_never_fires_and_unarmed_is_noop(tmp_path):
    wd = Watchdog(timeout=0.3, stack_path=str(tmp_path / "s.txt"))
    wd.arm("busy")
    try:
        for _ in range(12):
            time.sleep(0.05)
            wd.beat()
    finally:
        wd.close()
    assert wd.stalls == 0
    off = Watchdog(timeout=0, stack_path=str(tmp_path / "s.txt"))
    off.arm("x")
    off.beat()
    assert off._thread is None
    off.close()
    assert not os.path.exists(str(tmp_path / "s.txt"))
    session = t_tm.fit_session(batch_size=8)
    assert session._wd is None and not session
    session.step_begin()
    session.finish()


def test_stall_writes_watchdog_record_and_flight_dump(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rl = t_tm.reset(path)
    rl.step(0, 0, 0.01, 8)
    wd = Watchdog(timeout=0.2, stack_path=str(tmp_path / "s.txt"))
    wd.arm("wedged-phase")
    try:
        assert _wait_for(lambda: rl.counters["watchdog_stalls"] >= 1)
    finally:
        wd.close()
    t_tm.close()
    recs = _read(path)
    wrecs = [r for r in recs if r["type"] == "watchdog"]
    assert wrecs[0]["phase"] == "wedged-phase"
    assert wrecs[0]["quiet_s"] >= 0.2
    assert wrecs[0]["stack_path"] == str(tmp_path / "s.txt")
    with open(t_tm.flight_path_for(path)) as f:
        flight = json.load(f)
    assert flight["reason"] == "stall" and flight["steps"]


def test_max_dumps_and_disarm_bound_the_dumps(tmp_path):
    wd = Watchdog(timeout=0.05, stack_path=str(tmp_path / "s.txt"),
                  max_dumps=2, poll=0.02)
    wd.arm("stuck")
    time.sleep(0.5)
    wd.close()
    assert wd.stalls == 2
    with open(tmp_path / "s.txt") as f:
        assert f.read().count("watchdog stall #") == 2
    wd2 = Watchdog(timeout=0.1, stack_path=str(tmp_path / "t.txt"),
                   poll=0.02)
    wd2.arm("a")
    assert _wait_for(lambda: wd2.stalls >= 1)
    wd2.disarm()
    n = wd2.stalls
    time.sleep(0.3)
    assert wd2.stalls == n
    wd2.close()


def _mlp(mx):
    d = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, mx.sym.Variable("softmax_label"),
                                name="softmax")


def _fit_data(mx, n=64):
    rng = onp.random.RandomState(7)
    x = rng.randn(n, 10).astype("float32")
    y = (x @ rng.randn(10, 4)).argmax(axis=1).astype("float32")
    return mx.io.NDArrayIter(x, y, batch_size=8, shuffle=False)


def _fit(mx, **kw):
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.fit(_fit_data(mx), num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1),),
            initializer=mx.init.Xavier(), **kw)
    return mod


def test_fit_armed_watchdog_catches_a_wedged_step(tmp_path, monkeypatch):
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("MXNET_WATCHDOG_SEC", "0.2")
    t_tm.reset(path)

    def wedge(param):
        if param.epoch == 0 and param.nbatch == 2:
            time.sleep(0.6)

    with tmx.cpu():
        _fit(tmx, batch_end_callback=wedge)
    t_tm.close()
    recs = _read(path)
    assert [r for r in recs if r["type"] == "watchdog"]
    assert os.path.exists(t_tm.stack_path_for(path))
    assert sum(r["type"] == "step" for r in recs) == 8
    ends = [r for r in recs if r["type"] == "event"
            and r["kind"] == "fit_end"]
    assert ends[-1]["outcome"] == "ok" and ends[-1]["steps"] == 8


def test_fit_run_log_matches_reference_records(tmp_path, monkeypatch):
    """The same MLP fit in both packages: the same record types in the
    same order (but the compile records), the same sampled steps, the
    same step count."""
    monkeypatch.setenv("MXNET_TELEMETRY_SAMPLE", "3")
    got = {}
    for tag, mx, tm in (("jax", jmx, j_tm), ("port", tmx, t_tm)):
        path = str(tmp_path / f"{tag}.jsonl")
        tm.reset(path)
        with mx.cpu():
            _fit(mx)
        tm.close()
        got[tag] = _read(path)
    for recs in got.values():
        for r in recs:
            r.pop("t", None)
    # pinned divergence: the reference's graph Executor jit-compiles
    # its program and writes compile + program_report records; the
    # port's executor runs op by op and writes neither
    skip = ("compile", "program_report")
    assert not [r for r in got["port"] if r["type"] in skip]
    assert [r for r in got["jax"] if r["type"] in skip]
    kinds = [[(r["type"], r.get("kind")) for r in got[tag]
              if r["type"] not in skip] for tag in got]
    assert kinds[0] == kinds[1]
    steps = [[(r["step"], r["batch"], r["synced"], r["loss"] is None,
               r["samples"]) for r in got[tag] if r["type"] == "step"]
             for tag in got]
    assert steps[0] == steps[1]
    assert [s[2] for s in steps[1]] == [True, False, False] * 2 + \
        [True, False]
    assert got["port"][-1]["counters"]["steps"] == \
        got["jax"][-1]["counters"]["steps"] == 8


# --------------------------------------------------------------- numerics
_ARRAYS = {
    "plain": onp.random.RandomState(0).randn(64, 33).astype("float32"),
    "zeros": onp.where(onp.random.RandomState(1).rand(500) > 0.7,
                       onp.random.RandomState(2).randn(500), 0.0
                       ).astype("float32"),
    "nan_inf": onp.array([3.0, -4.0, 0.0, 0.0, onp.nan, onp.inf, -onp.inf,
                          2.5], "float32"),
    "all_nan": onp.full((3, 3), onp.nan, "float32"),
    "ints": onp.arange(-3, 9, dtype="int32"),
    "bf16": None,
}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_summary_matches_reference_on_the_same_array(name):
    a = _ARRAYS[name]
    if a is None:  # bf16 values, exactly representable in both
        a = onp.linspace(-2, 2, 17).astype("float32")
        j_in = jnp.asarray(a, jnp.bfloat16)
        t_in = torch.from_numpy(a).to(torch.bfloat16)
    else:
        j_in, t_in = jnp.asarray(a), torch.from_numpy(a)
    j_row = j_nm.stats_row(j_nm.summary(j_in))
    t_row = t_nm.stats_row(t_nm.summary(t_in))
    assert list(t_row) == list(j_row) == list(t_nm.STAT_FIELDS)
    assert (t_row["nan"], t_row["inf"]) == (j_row["nan"], j_row["inf"])
    for k in ("l2", "min", "max", "zero_frac"):
        if math.isnan(j_row[k]):
            assert math.isnan(t_row[k]), k
        else:
            assert t_row[k] == pytest.approx(j_row[k], rel=REL), k
    assert t_nm.nonfinite({name: t_row}) == j_nm.nonfinite({name: j_row})


def test_numerics_knobs_match_reference(monkeypatch):
    for env in ({}, {"MXNET_NUMERICS": "1"},
                {"MXNET_NUMERICS_SAMPLE": "4"},
                {"MXNET_TELEMETRY_SAMPLE": "7"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert t_nm.armed() == j_nm.armed()
        assert t_nm.sample_period() == j_nm.sample_period()
    assert t_nm.STAT_FIELDS == j_nm.STAT_FIELDS


def _dense_step(pkg, **kw):
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


def _batches():
    rng = onp.random.RandomState(4)
    out = []
    for i in range(5):
        x = rng.randn(4, 6).astype("float32")
        if i == 3:  # a planted NaN and Inf: step 3 is explained
            x[0, 0] = onp.nan
            x[2, 4] = onp.inf
        out.append((x, rng.randn(4, 8).astype("float32")))
    return out


def _stats_run(pkg, tmp_path, **kw):
    tm = j_tm if pkg == "jax" else t_tm
    path = str(tmp_path / f"{pkg}.jsonl")
    tm.reset(path)
    step, p, s = _dense_step(pkg, **kw)
    for i, (x, y) in enumerate(_batches()):
        if pkg == "jax":
            _, p, s = step(p, s, x, y, jax.random.key(0), float(i + 1))
        else:
            _, p, s = step(p, s, torch.from_numpy(x), torch.from_numpy(y),
                           None, float(i + 1))
    tm.close()
    return [r for r in _read(path) if r["type"] == "tensor_stats"], s


@pytest.mark.parametrize("guard", [False, True])
def test_train_step_tensor_stats_match_reference(guard, tmp_path,
                                                 monkeypatch):
    """Every step sampled; step 3's batch carries a planted NaN and Inf
    (unguarded, the poisoned update leaves step 4 non-finite too): the
    same steps, names, nan/inf counts and, for the finite steps, rows
    within the fp32 tolerance of two implementations of the same
    gradients (1e-5)."""
    monkeypatch.setenv("MXNET_NUMERICS", "1")
    monkeypatch.setenv("MXNET_NUMERICS_SAMPLE", "1")
    j_ts, j_s = _stats_run("jax", tmp_path, nan_guard=guard)
    t_ts, t_s = _stats_run("port", tmp_path, nan_guard=guard)
    assert "_numerics" in t_s and "_numerics" in j_s
    assert [r["step"] for r in t_ts] == [r["step"] for r in j_ts] == \
        [0, 1, 2, 3, 4]
    for t_rec, j_rec in zip(t_ts, j_ts):
        assert t_rec["where"] == j_rec["where"] == "grad"
        bad = t_rec["step"] == 3 or (t_rec["step"] > 3 and not guard)
        assert t_rec["nonfinite"] == j_rec["nonfinite"] == bad
        assert set(t_rec["tensors"]) == set(j_rec["tensors"]) == \
            {"dense0_weight", "dense0_bias", "__loss"}
        for name, row in t_rec["tensors"].items():
            want = j_rec["tensors"][name]
            assert (row["nan"], row["inf"]) == (want["nan"], want["inf"])
            if not t_rec["nonfinite"]:
                for k in ("l2", "min", "max", "zero_frac"):
                    assert row[k] == pytest.approx(want[k], rel=1e-5,
                                                   abs=1e-7), (name, k)
    if guard:
        assert int(t_s["_bad_steps"]) == int(j_s["_bad_steps"]) == 0


def test_ps_arm_warns_and_writes_no_tensor_stats(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_NUMERICS", "1")
    mesh_j = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
    for pkg, mesh in (("jax", mesh_j),
                      ("port", t_par.get_mesh(devices=["cpu"]))):
        with pytest.warns(UserWarning, match="MXNET_NUMERICS under "
                                             "optimizer_sharding='ps'"):
            ts, s = _stats_run(pkg, tmp_path, optimizer_sharding="ps",
                               mesh=mesh)
        assert ts == [] and "_numerics" not in s


def test_module_fit_emits_grad_tensor_stats(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_NUMERICS", "1")
    monkeypatch.setenv("MXNET_NUMERICS_SAMPLE", "3")
    got = {}
    for tag, mx, tm in (("jax", jmx, j_tm), ("port", tmx, t_tm)):
        path = str(tmp_path / f"{tag}.jsonl")
        tm.reset(path)
        with mx.cpu():
            _fit(mx)
        tm.close()
        got[tag] = [r for r in _read(path) if r["type"] == "tensor_stats"]
    for tag in got:
        assert [r["step"] for r in got[tag]] == [0, 3, 6]
        assert got[tag][0]["epoch"] == 0
        assert set(got[tag][0]["tensors"]) == {"fc1_weight", "fc1_bias",
                                               "fc2_weight", "fc2_bias"}
        assert not any(r["nonfinite"] for r in got[tag])


def test_monitor_numerics_stat_func_matches_reference():
    rows = {}
    for tag, mx in (("jax", jmx), ("port", tmx)):
        mon = mx.monitor.Monitor(interval=1, stat_func="numerics")
        mon.activated = True
        with mx.cpu():
            mon._stat_helper("layer_output0", mx.nd.array(
                onp.asarray([[3.0, -4.0, 0.0]], "float32")))
        stats = mon.toc()
        rows[tag] = [(name, val) for _, name, val in stats]
    assert rows["port"] == rows["jax"]
    assert "l2=5" in rows["port"][0][1]


# ------------------------------------------------------- SIGTERM in fit
_FIT_WORKER = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as onp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
telemetry.reset(sys.argv[2])
rng = onp.random.RandomState(7)
x = rng.randn(4000, 10).astype("float32")
y = (x @ rng.randn(10, 4)).argmax(axis=1).astype("float32")
it = mx.io.NDArrayIter(x, y, batch_size=8, shuffle=False)
d = mx.sym.Variable("data")
net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(d, num_hidden=4,
                                                 name="fc"),
                           mx.sym.Variable("softmax_label"),
                           name="softmax")

def announce(param):
    if param.nbatch == 20:
        open(sys.argv[3], "w").close()
    time.sleep(0.01)

with mx.cpu():
    mx.mod.Module(net).fit(it, num_epoch=1, optimizer="sgd",
                           batch_end_callback=announce,
                           checkpoint=sys.argv[4])
print("not drained")
"""


def test_sigterm_during_fit_leaves_a_whole_flight_dump(tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    ready = str(tmp_path / "ready")
    proc = subprocess.Popen(
        [sys.executable, "-c", _FIT_WORKER, _REPO, runlog, ready,
         str(tmp_path / "ck")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert _wait_for(lambda: os.path.exists(ready)
                         or proc.poll() is not None, timeout=240)
        assert proc.poll() is None, proc.stderr.read()[-2000:]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGTERM, err[-2000:]
    assert "not drained" not in out
    dumps = t_tm.find_flight_dumps(runlog)
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        flight = json.load(f)  # whole: the atomic writer's rename
    assert flight["reason"] == "preempt_drain"
    assert flight["counters"]["preempt_signals"] == 1
    assert flight["steps"] and flight["counters"]["checkpoints"] == 1
    recs = _read(runlog)
    ends = [r for r in recs if r["type"] == "event"
            and r["kind"] == "fit_end"]
    assert ends[-1]["outcome"] == "preempted"
    assert [r for r in recs if r["type"] == "checkpoint"]
