"""The port's ``mx.profiler`` held against the JAX package's on the CPU.

The same program runs under both profilers (``with mx.cpu():`` for the
port): the dumped Chrome trace has the reference's top-level keys, its
event categories and phases and its op names; ``dumps()`` has the
reference's columns in table and JSON form; the telemetry lane (tid 7)
lands in the same timeline.  The device capture (``profile_device``)
is the port's ``torch.profiler`` in place of the reference's
``jax.profiler``: on the host it records the CPU activity, and its
Chrome trace names the op scopes and user scopes open around the work.
Comparisons are exact; no timing is compared.
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import profiler as j_prof  # noqa: E402
from mxnet_tpu import telemetry as j_tm  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import profiler as t_prof  # noqa: E402
from mxnet_tpu_torch import telemetry as t_tm  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKGS = {"jax": (jmx, j_prof, j_tm), "port": (tmx, t_prof, t_tm)}


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.delenv("MXNET_RUNLOG", raising=False)
    yield
    for _, prof, tm in _PKGS.values():
        prof.set_state("stop")
        prof._events.clear()
        prof._agg.clear()
        prof.set_config(aggregate_stats=False, continuous_dump=False,
                        filename="profile.json", profile_device=False,
                        tensorboard_logdir=None)
        tm.close()


def _program(mx, prof, tm, tmp_path, tag):
    """Ops, user scopes, counters, a marker and telemetry-lane records
    under one profiler run; returns the dumped trace."""
    out = str(tmp_path / f"{tag}.json")
    prof.set_config(filename=out, aggregate_stats=True)
    prof.set_state("run")
    rl = tm.reset(str(tmp_path / f"{tag}.jsonl"))
    dom = prof.Domain("train")
    with dom.new_task("epoch"):
        with prof.Event("forward"):
            a = mx.nd.array(onp.ones((4, 4), "float32"))
            b = mx.nd.dot(a + 1, a)
            for _ in range(3):
                b = b * 2
            b.asnumpy()
    ctr = dom.new_counter("samples", 0)
    ctr += 5
    ctr -= 2
    dom.new_marker("checkpoint").mark()
    rl.step(0, 0, 0.004, 32, loss=0.5, synced=True, feed_wait_s=0.001)
    rl.compile_event("train_step", {"shape": "(32, 6)",
                                    "dtype": "float32"})
    rl.checkpoint_event("pfx", 1, 0.002, 1234)
    tm.close()
    prof.set_state("stop")
    assert prof.dump() == out
    with open(out) as f:
        return json.load(f)


@pytest.fixture()
def traces(tmp_path):
    got = {}
    for tag, (mx, prof, tm) in _PKGS.items():
        if tag == "port":
            with mx.cpu():
                got[tag] = _program(mx, prof, tm, tmp_path, tag)
        else:
            got[tag] = _program(mx, prof, tm, tmp_path, tag)
        got[tag + "_table"] = prof.dumps(format="table", sort_by="count")
        got[tag + "_json"] = json.loads(prof.dumps(format="json"))
    return got


def test_dump_has_reference_keys_categories_and_names(traces):
    t, j = traces["port"], traces["jax"]
    assert set(t) == set(j) == {"traceEvents", "displayTimeUnit"}
    assert t["displayTimeUnit"] == j["displayTimeUnit"]

    def shape(trace):
        return sorted({(e["cat"], e["ph"], e["name"])
                       for e in trace["traceEvents"]})

    assert shape(t) == shape(j)
    for e in t["traceEvents"]:
        assert isinstance(e["ts"], (int, float))
        assert set(e) - {"dur", "args"} == {"name", "cat", "ph", "ts",
                                            "pid", "tid"}


def test_dumps_has_reference_columns(traces):
    t_lines = traces["port_table"].splitlines()
    j_lines = traces["jax_table"].splitlines()
    assert t_lines[0] == j_lines[0]
    assert sorted(line.split()[0] for line in t_lines[1:]) == \
        sorted(line.split()[0] for line in j_lines[1:])
    t_rows = {r["name"]: r for r in traces["port_json"]}
    j_rows = {r["name"]: r for r in traces["jax_json"]}
    assert set(t_rows) == set(j_rows)
    for name, row in t_rows.items():
        assert set(row) == set(j_rows[name])
        assert row["count"] == j_rows[name]["count"]
    assert t_rows["_mul_scalar"]["count"] == 3


def test_telemetry_lane_rides_the_timeline(traces):
    for tag in ("port", "jax"):
        evs = traces[tag]["traceEvents"]
        tele = [e for e in evs if e.get("cat") == "telemetry"]
        assert {e["name"] for e in tele if e["ph"] == "X"} == \
            {"step 0", "feed_wait", "checkpoint"}
        assert {e["name"] for e in tele if e["ph"] == "C"} == \
            {"throughput", "loss"}
        lane = [e for e in evs if e["ph"] == "M"
                and e.get("args", {}).get("name") == "telemetry"]
        assert lane and all(e["tid"] == lane[0]["tid"] == 7 for e in tele)


def test_pause_resume_and_reset():
    with tmx.cpu():
        t_prof.set_config(aggregate_stats=True)
        t_prof.set_state("run")
        t_prof.pause()
        _ = tmx.nd.ones((2,)) + 1
        t_prof.resume()
        _ = tmx.nd.ones((2,)) * 3
        t_prof.set_state("stop")
    names = [e["name"] for e in t_prof._events]
    assert "_mul_scalar" in names and "_plus_scalar" not in names
    assert json.loads(t_prof.dumps(reset=True, format="json"))
    assert t_prof.dumps(format="json") == "[]"


def test_dump_unfinished_keeps_collecting(tmp_path):
    out = str(tmp_path / "t.json")
    t_prof.set_config(filename=out)
    t_prof.set_state("run")
    with tmx.cpu():
        (tmx.nd.ones((2,)) + 1).asnumpy()
        t_prof.dump(finished=False)
        assert t_prof.is_running()
        with open(out) as f:
            n_mid = len(json.load(f)["traceEvents"])
        (tmx.nd.ones((2,)) * 3).asnumpy()
    t_prof.dump()
    assert not t_prof.is_running()
    with open(out) as f:
        assert len(json.load(f)["traceEvents"]) > n_mid


@pytest.mark.parametrize("bad", [dict(nonsense=1)])
def test_bad_config_and_state_raise_as_reference(bad):
    for mx, prof, _ in _PKGS.values():
        with pytest.raises(mx.MXNetError):
            prof.set_config(**bad)
        with pytest.raises(mx.MXNetError):
            prof.set_state("bogus")
        prof.set_state("run")
        with pytest.raises(mx.MXNetError, match="running"):
            prof.set_config(filename="elsewhere.json")
        prof.set_state("stop")
        with pytest.raises(mx.MXNetError):
            prof.dumps(sort_by="p50")


def test_device_capture_names_the_open_host_scopes(tmp_path):
    """``profile_device=True``: set_state('run'/'stop') brackets a
    ``torch.profiler`` capture whose Chrome trace lands in
    ``tensorboard_logdir`` and names each op scope and user scope that
    was open (``record_function``), while the host trace stays the
    reference's."""
    logdir = str(tmp_path / "tb")
    t_prof.set_config(profile_device=True, tensorboard_logdir=logdir,
                      filename=str(tmp_path / "host.json"))
    t_prof.set_state("run")
    with tmx.cpu():
        with t_prof.Domain("train").new_frame("step_frame"):
            a = tmx.nd.array(onp.ones((8, 8), "float32"))
            tmx.nd.dot(a, a).asnumpy()
    assert t_prof.device_profile() is None  # still capturing
    t_prof.set_state("stop")
    path = t_prof.device_trace_path()
    assert path is not None and os.path.dirname(path) == logdir
    with open(path) as f:
        dev = json.load(f)
    names = {e.get("name") for e in dev["traceEvents"]}
    assert {"dot", "step_frame"} <= names
    # the capture saw the aten work inside the scopes
    assert any(str(n).startswith("aten::") for n in names)
    avgs = {e.key for e in t_prof.device_profile().key_averages()}
    assert "dot" in avgs
    t_prof.dump()
    with open(tmp_path / "host.json") as f:
        host = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"dot", "step_frame", "profiler_start"} <= host


def test_device_capture_off_opens_no_record_function():
    t_prof.set_state("run")
    scope = t_prof.op_scope("dot")
    with scope:
        pass
    assert scope._rf is None
    t_prof.set_state("stop")
    assert t_prof.op_scope("dot") is None  # stopped: the fast exit


def test_profiler_autostart_env():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mxnet_tpu_torch as mx; "
            "print(mx.profiler.is_running())")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1")
    out = subprocess.run([sys.executable, "-c", code, _REPO], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
    from mxnet_tpu import config as j_config
    from mxnet_tpu_torch import config as t_config

    for name in ("MXNET_PROFILER_AUTOSTART", "MXNET_PROFILER_MODE"):
        assert t_config._ENV[name].default == j_config._ENV[name].default
        assert t_config._ENV[name].type is j_config._ENV[name].type
    assert tmx.profiler is t_prof
