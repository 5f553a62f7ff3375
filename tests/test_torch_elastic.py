"""The port's elastic runtime (``resilience/elastic.py``, ``runtime.py``,
``parallel/zero.py``'s plan functions) held against the JAX package on
the CPU.

- ``plan_fingerprint``, ``topology_block``, ``reshard_verdict`` and
  ``reslice_cursor`` give the reference's outputs on the reference's
  cases (``tests/test_elastic.py:74-133``), and the topology stamp
  round-trips through a manifest either package reads.
- ``ElasticHostIter`` gives the reference's partitions, pads included,
  for worlds 1, 2, 4 and 8.
- ``elastic_init``'s knob resolution equals the reference's; several
  processes without a coordinator are refused with the reference's
  message; a world of 1 is a local context and ``elastic_mesh`` the
  one-card mesh.
- A two-process CPU gloo job retries an armed ``dist.init:raise@1``
  (``tests/torch_elastic_worker.py init``).
- (slow) Two processes SIGTERM-drain at one step boundary, the
  relaunch at world 1 reshards and finishes equal to the uninterrupted
  run: the replicated counterpart of
  ``tests/test_elastic.py::test_two_process_real_distributed_resize_drill``.
- ``runtime.feature_list()`` names and ``Features``.
"""
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.parallel import zero as j_zero  # noqa: E402
from mxnet_tpu.resilience import elastic as j_elastic  # noqa: E402
from mxnet_tpu.resilience.checkpoint import \
    CheckpointManager as JMgr  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import runtime as t_runtime  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import zero as t_zero  # noqa: E402
from mxnet_tpu_torch.resilience import elastic as t_elastic  # noqa: E402
from mxnet_tpu_torch.resilience.checkpoint import \
    CheckpointManager as TMgr  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_elastic_worker.py")


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=_REPO, MXNET_DEFAULT_CTX="cpu",
               OMP_NUM_THREADS="1")
    env.pop("MXNET_FAULT_SPEC", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _both(fn):
    """``fn(elastic_module)`` for each package: (port's, reference's)."""
    return fn(t_elastic), fn(j_elastic)


# ------------------------------------------------ topology + verdicts
def test_plan_fingerprint_and_reshard_verdict():
    params = {"w": onp.zeros((64, 16), "float32"),
              "b": onp.zeros((16,), "float32")}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for n in (1, 2, 4):
        for stage in (None, 1, 3):
            assert t_zero.plan_fingerprint(
                t_zero.plan_buckets(tparams, n), n, stage) == \
                j_zero.plan_fingerprint(j_zero.plan_buckets(params, n), n,
                                        stage)
    plan4 = {"port": t_zero.plan_buckets(tparams, 4),
             "ref": j_zero.plan_buckets(params, 4)}
    plan2 = {"port": t_zero.plan_buckets(tparams, 2),
             "ref": j_zero.plan_buckets(params, 2)}
    out = {}
    for name, el in (("port", t_elastic), ("ref", j_elastic)):
        topo4 = el.topology_block(world_size=4, num_processes=1,
                                  sharding="ps", plan=plan4[name],
                                  global_batch=8)
        topo2 = el.topology_block(world_size=2, num_processes=1,
                                  sharding="ps", plan=plan2[name],
                                  global_batch=8, zero_stage=3)
        out[name] = (topo4, topo2, el.reshard_verdict(topo4, topo2),
                     el.reshard_verdict(topo4, dict(topo4)),
                     el.reshard_verdict(None, topo2),
                     el.topology_block(world_size=3, num_processes=1))
    assert out["port"] == out["ref"]
    v = out["port"][2]
    assert v["reshard"] and v["cursor_compatible"]
    assert (v["old_world"], v["new_world"]) == (4, 2)
    assert not out["port"][3]["reshard"] and not out["port"][4]["reshard"]


def test_reslice_cursor_guards_global_batch():
    for el in (t_elastic, j_elastic):
        old = el.topology_block(world_size=4, num_processes=1,
                                global_batch=8)
        new2 = el.topology_block(world_size=2, num_processes=1,
                                 global_batch=8)
        bad = el.topology_block(world_size=2, num_processes=1,
                                global_batch=16)
        assert el.reslice_cursor(3, old, new2) == 3
        assert el.reslice_cursor(0, old, bad) == 0
    msgs = []
    for el, err in ((t_elastic, MXNetError), (j_elastic, jmx.MXNetError)):
        with pytest.raises(err, match="global batch") as e:
            el.reslice_cursor(3, el.topology_block(world_size=4,
                                                   global_batch=8),
                              el.topology_block(world_size=2,
                                                global_batch=16))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("raw", ["", "1", "2", "3", " 2 ", "4", "x"])
def test_zero_stage_knob_matches_reference(raw, monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_STAGE", raw)
    out = []
    for z, err in ((t_zero, MXNetError), (j_zero, jmx.MXNetError)):
        try:
            out.append(z.resolve_zero_stage())
        except err as e:
            out.append(str(e))
    assert out[0] == out[1]


def test_make_train_step_reads_the_zero_knobs(monkeypatch):
    """``MXNET_ZERO_STAGE`` overrides the argument and implies the
    sharded arm, ``MXNET_OPTIMIZER_SHARDING=0`` vetoes it (the
    reference's precedence); stages 1 and 3 build the stage the knob
    names."""
    from mxnet_tpu_torch import gluon, parallel

    zero_keys = parallel.zero.stage3_param_keys
    mesh = parallel.get_mesh(devices=["cpu"])
    resolve = parallel._resolve_ps_mode
    monkeypatch.setenv("MXNET_ZERO_STAGE", "2")
    assert resolve(None, None, mesh) is True
    assert resolve(None, 3, mesh) is True  # the env wins
    with pytest.warns(UserWarning, match="needs a mesh"):
        assert resolve(None, None, None) is False
    monkeypatch.setenv("MXNET_OPTIMIZER_SHARDING", "0")
    assert resolve("ps", None, mesh) is False
    monkeypatch.setenv("MXNET_OPTIMIZER_SHARDING", "ps")
    monkeypatch.setenv("MXNET_ZERO_STAGE", "")
    assert resolve(None, None, mesh) is True
    monkeypatch.delenv("MXNET_OPTIMIZER_SHARDING")
    assert resolve(None, None, mesh) is False
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize()
    for stage in ("1", "3"):
        monkeypatch.setenv("MXNET_ZERO_STAGE", stage)
        step, p, _ = parallel.make_train_step(
            net, lambda out, y: ((out - y) ** 2).sum(-1), mesh=mesh,
            zero_stage=2)
        assert step.zero_stage == int(stage)
        assert (set(p) == set(zero_keys(step.zero_plan))) == (stage == "3")
    monkeypatch.setenv("MXNET_ZERO_STAGE", "x")
    with pytest.raises(MXNetError, match="not a recognized stage"):
        resolve(None, None, mesh)


def test_topology_roundtrips_through_manifest(tmp_path):
    topo = t_elastic.topology_block(world_size=4, num_processes=1,
                                    sharding="ps", global_batch=8)
    TMgr(str(tmp_path / "t")).save(
        1, arg_params={"w": tmx.nd.ones((2, 2))}, batch_cursor=5,
        topology=topo)
    for Mgr in (TMgr, JMgr):
        st = Mgr(str(tmp_path / "t")).load()
        assert st["topology"] == topo and st["batch_cursor"] == 5
    TMgr(str(tmp_path / "old")).save(1, arg_params={"w": tmx.nd.ones(2)})
    assert TMgr(str(tmp_path / "old")).load()["topology"] is None


@pytest.mark.parametrize("name", ["MXNET_PEER_TIMEOUT_SEC",
                                  "MXNET_DIST_INIT_TIMEOUT_SEC"])
def test_float_knobs_match_reference(name, monkeypatch):
    from mxnet_tpu import config as j_config
    from mxnet_tpu_torch import config as t_config

    got, want = t_config._ENV[name], j_config._ENV[name]
    assert (got.default, got.type) == (want.default, want.type)
    monkeypatch.setenv(name, "2.5")
    assert t_config.get_env(name) == j_config.get_env(name) == 2.5


# ----------------------------------------------------- host re-slicing
def _partition(el, pkg, hosts, n=60, gb=8):
    X = onp.arange(n, dtype="float32").reshape(n, 1)
    y = onp.arange(n, dtype="float32")
    out = []
    for r in range(hosts):
        it = el.ElasticHostIter(pkg.io.NDArrayIter(X, y, batch_size=gb),
                                r, hosts)
        out.append([(b.data[0].asnumpy().ravel().tolist(),
                     b.label[0].asnumpy().ravel().tolist(), b.pad)
                    for b in it] + [it.provide_data[0][1],
                                    it.provide_label[0][1]])
    return out


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_elastic_host_iter_partitions_match_reference(hosts):
    for n in (64, 60, 58):  # no pad, pad 4, pad 6
        got = _partition(t_elastic, tmx, hosts, n=n)
        want = _partition(j_elastic, jmx, hosts, n=n)
        assert got == want, (hosts, n)
    # the union over the hosts is the global stream, batch by batch
    parts = _partition(t_elastic, tmx, hosts, n=64)
    for b in range(8):
        union = sorted(v for r in range(hosts) for v in parts[r][b][0])
        assert union == list(range(8 * b, 8 * (b + 1)))
    with pytest.raises(MXNetError, match="divide"):
        t_elastic.ElasticHostIter(tmx.io.NDArrayIter(
            onp.zeros((8, 1), "float32"), batch_size=8), 0, 3).provide_data


# ------------------------------------------------------------ bring-up
def test_elastic_init_env_resolution(monkeypatch):
    for k in ("MXNET_COORDINATOR", "MXNET_NUM_PROCESSES",
              "MXNET_PROCESS_ID", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
              "DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    assert _both(lambda el: el._resolve_bringup(None, None, None)) == \
        ((None, None, None),) * 2
    assert _both(lambda el: el.elastic_enabled()) == (False, False)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9999")
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    monkeypatch.setenv("DMLC_WORKER_ID", "2")
    got, want = _both(lambda el: el._resolve_bringup(None, None, None))
    assert got == want == ("10.0.0.1:9999", 3, 2)
    monkeypatch.setenv("MXNET_COORDINATOR", "coord:1234")
    monkeypatch.setenv("MXNET_NUM_PROCESSES", "4")
    monkeypatch.setenv("MXNET_PROCESS_ID", "1")
    got, want = _both(lambda el: el._resolve_bringup(None, None, None))
    assert got == want == ("coord:1234", 4, 1)
    got, want = _both(lambda el: el._resolve_bringup("x:1", 2, 0))
    assert got == want == ("x:1", 2, 0)
    assert _both(lambda el: el.elastic_enabled()) == (True, True)


def test_elastic_init_refuses_several_processes_without_coordinator(
        monkeypatch):
    for k in ("MXNET_COORDINATOR", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
              "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    msgs = []
    for el in (t_elastic, j_elastic):
        monkeypatch.setitem(el._STATE, "ctx", None)
        with pytest.raises(Exception, match="no coordinator") as e:
            el.elastic_init(num_processes=2, process_id=1)
        msgs.append(str(e.value))
        assert el.context() is None
    assert msgs[0] == msgs[1]


def test_elastic_init_world_one_and_mesh(monkeypatch):
    for k in ("MXNET_COORDINATOR", "DMLC_PS_ROOT_URI", "DMLC_NUM_WORKER",
              "MXNET_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setitem(t_elastic._STATE, "ctx", None)
    ctx = t_elastic.elastic_init()
    assert (ctx.num_processes, ctx.process_id, ctx.world_devices) == \
        (1, 0, 1)
    assert not ctx.distributed and ctx.is_coordinator
    assert ctx.backend == "cpu"  # inside `with mx.cpu():`
    assert t_elastic.elastic_init() is ctx  # idempotent
    assert t_runtime.distributed_info() is ctx
    assert t_runtime.init_distributed() is ctx
    mesh = t_elastic.elastic_mesh(devices=["cpu"])
    assert mesh.axis_names == ("data",) and len(mesh.devices) == 1
    assert t_elastic.topology_block(mesh=mesh, global_batch=8) == \
        j_elastic.topology_block(world_size=1, num_processes=1,
                                 global_batch=8)
    with pytest.raises(MXNetError, match="devices"):
        t_elastic.elastic_mesh(dp=3, tp=7)
    # a world of two processes is the two-process mesh, this one rank 1
    monkeypatch.setitem(t_elastic._STATE, "ctx", t_elastic.ElasticContext(
        "127.0.0.1:1", 2, 1, 2, 1, "gloo"))
    mesh2 = t_elastic.elastic_mesh(devices=["cpu"])
    assert mesh2.shape == {"data": 2} and mesh2.rank == 1
    assert str(mesh2.devices[0]) == "cpu"
    assert t_elastic.topology_block(mesh=mesh2) == \
        j_elastic.topology_block(world_size=2, num_processes=2)
    x = tmx.nd.array(onp.arange(6.0).reshape(2, 3))
    onp.testing.assert_array_equal(t_elastic.host_gather(x),
                                   onp.arange(6.0).reshape(2, 3))


def test_two_process_gloo_retries_dist_init_flake():
    """Both processes of a CPU gloo job retry an armed
    ``dist.init:raise@1`` and pass the barrier all-reduce."""
    port = _free_port()
    env = _env(MXNET_FAULT_SPEC="dist.init:raise@1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, "init", f"127.0.0.1:{port}", str(pid),
         "2"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for pid in (0, 1)]
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            raise
        assert p.returncode == 0, err[-3000:]
        assert (f"[{pid}] up: procs=2 backend=gloo dist.init hits=2 "
                "dist.collective hits=1") in out, out


@pytest.mark.slow
def test_two_process_sigterm_drain_then_resume_at_world_one(tmp_path):
    """Two CPU gloo processes SIGTERM-drain at one step boundary (rank 0
    writes the topology-stamped checkpoint, both exit by the signal);
    the relaunch at world 1 reshards, continues from the cursor and
    matches the uninterrupted run."""
    prefix = str(tmp_path / "mp" / "ck")
    os.makedirs(os.path.dirname(prefix))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, "train", f"127.0.0.1:{port}", str(pid),
         "2", prefix], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == -signal.SIGTERM, (pid, p.returncode,
                                                 out[-2000:])
        assert f"[{pid}] draining" in out
    assert "[0] drain checkpoint at cursor 3" in outs[0]
    st = TMgr(prefix).load()
    assert st["batch_cursor"] == 3
    assert st["topology"]["world_size"] == 2
    r = subprocess.run([sys.executable, _WORKER, "resume", prefix],
                       env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    resumed = json.loads(r.stdout.strip().splitlines()[-1])
    assert resumed["verdict"] == {"reshard": True, "old_world": 2,
                                  "new_world": 1}
    assert resumed["resumed_cursor"] == 3
    r = subprocess.run([sys.executable, _WORKER, "reference"], env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    for k in ref["final"]:
        onp.testing.assert_allclose(onp.asarray(resumed["final"][k]),
                                    onp.asarray(ref["final"][k]),
                                    rtol=1e-5, atol=1e-7, err_msg=k)


def test_two_process_zero_drain_then_reshard_at_world_one(tmp_path):
    """The drill of the reference's
    ``test_two_process_real_distributed_resize_drill`` through the real
    sharded step (``make_train_step``'s ps arm, each process holding
    its momentum shard): both ranks SIGTERM-drain at one step, gather
    jointly, rank 0 writes the topology-stamped checkpoint; the world-1
    relaunch gets ``reshard``, re-plans, re-slices the momentum and
    continues from the cursor to the uninterrupted run's parameters."""
    prefix = str(tmp_path / "z" / "ck")
    os.makedirs(os.path.dirname(prefix))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, "zero_train", f"127.0.0.1:{port}",
         str(pid), "2", prefix], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    ref = subprocess.Popen([sys.executable, _WORKER, "zero_reference"],
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == -signal.SIGTERM, (pid, p.returncode,
                                                 out[-2000:])
        assert f"[{pid}] draining" in out
    assert "[0] drain checkpoint at cursor 3" in outs[0]
    st = TMgr(prefix).load()
    assert st["batch_cursor"] == 3
    assert st["topology"]["world_size"] == 2
    assert st["topology"]["sharding"] == "ps"
    r = subprocess.run([sys.executable, _WORKER, "zero_resume", prefix],
                       env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    resumed = json.loads(r.stdout.strip().splitlines()[-1])
    assert resumed["verdict"] == {"reshard": True, "old_world": 2,
                                  "new_world": 1}
    assert resumed["resumed_cursor"] == 3
    out, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    for k in want["final"]:
        onp.testing.assert_allclose(onp.asarray(resumed["final"][k]),
                                    onp.asarray(want["final"][k]),
                                    rtol=1e-6, atol=1e-6, err_msg=k)


# -------------------------------------------------------------- runtime
def test_runtime_feature_list_names():
    names = [f.name for f in t_runtime.feature_list()]
    assert names == ["CUDA", "CUDNN", "NCCL", "CPU", "BF16",
                     "INT64_TENSOR_SIZE", "DIST_KVSTORE", "ELASTIC",
                     "SIGNAL_HANDLER", "PROFILER", "OPENCV", "MKLDNN",
                     "TENSORRT", "LAPACK"]
    from mxnet_tpu import runtime as j_runtime

    ref = {f.name for f in j_runtime.feature_list()}
    # the upstream rows the reference names too
    assert set(names) - ref == {"CUDNN", "NCCL"}
    feats = t_runtime.Features()
    assert feats.is_enabled("cpu") and feats.is_enabled("DIST_KVSTORE")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert repr(feats["CPU"]) == "✔ CPU"
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("TPU_PODS")
    assert tmx.runtime is t_runtime
