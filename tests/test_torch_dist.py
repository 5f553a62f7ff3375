"""The port's distributed store and launcher, multi-process on the CPU.

Every job goes through the port's launcher with ``--cpu``
(``python mxnet_tpu_torch/tools/launch.py -n N --cpu ...``), 2 or 3
workers, each a Python process; every port is bound as port 0 (the
launcher's rendezvous, the parameter-server shards), so parallel test
runs do not collide.  The jobs start together when the module's first
test asks (``_jobs``, a module fixture) and each test waits for its
own, so the file's wall time is about its slowest job's, the
reference's half of the cross-package check.

- ``tests/torch_dist_sync_kvstore.py``: the closed-form invariants of
  ``tests/dist_sync_kvstore.py`` (rank 0's init, the sum over workers
  over rounds and dtypes, the parameter server keeping f64/int32/bf16,
  2-bit compression with its wire bytes and residual, an optimizer on
  the server shards, the server profiler), 3 workers on the native
  shard and 2 on the Python one.
- ``tests/torch_dist_async_worker.py``: ``dist_async`` applies each
  push on arrival (the fast workers do not wait for the slow one), the
  closed-form total, the stopped heartbeat in ``num_dead_node``; native
  and Python shards.
- The shard-restart drill of ``tests/dist_ps_restart_worker.py``
  (``tests/torch_dist_ps_restart_worker.py``): re-resolved addresses,
  refill, the liveness probe's failover.
- ``--max-restarts``, the exit code, the ssh launcher through a shim (as
  ``tests/test_dist.py`` drives it), and a ``dist_sync`` store outside
  a launched job (a group of one).
- The cross-package check: ``tests/torch_dist_trainer_worker.py`` runs
  the port's distributed Trainer under the port's launcher and the
  reference's under ``tools/launch.py -n 2 --cpu`` (ResNet-18 v1, 32²,
  batch 4 a worker, 3 steps of SGD with momentum, float64 throughout),
  with each worker updating its replica and with
  ``update_on_kvstore=True``; every trained parameter agrees to 1e-5 of
  its tensor's largest magnitude (2.1e-9 read), and the two workers'
  replicas are equal bit for bit.
- ``mxnet_tpu_torch/example/distributed_training/cifar10_dist.py``
  trains with two workers under ``dist_sync`` and ``dist_async``.
"""
import hashlib
import json
import os
import shutil
import stat
import subprocess
import sys
import tempfile

import numpy as onp
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT = 240
#: the worker's runs held against the reference: each worker updating
#: its replica, and the store's updater applying the summed gradient
_TRAINER_RUNS = ("f64", "f64_uokv")


def _env(**extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO
    env.update(extra)
    return env


_LAUNCH = os.path.join(_REPO, "mxnet_tpu_torch", "tools", "launch.py")


def _launch_cmd(n, *command, launcher_args=()):
    return [sys.executable, _LAUNCH, "-n", str(n), "--cpu", *launcher_args,
            sys.executable, *command]


def _test(name):
    return os.path.join(_REPO, "tests", name)


class _Job:
    def __init__(self, cmd, env=None):
        self.cmd = cmd
        # a session of its own, so that a job past its time is killed
        # with its workers
        self._p = subprocess.Popen(cmd, env=env or _env(), cwd=_REPO,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   start_new_session=True)
        self._res = None

    def result(self):
        if self._res is None:
            try:
                out, err = self._p.communicate(timeout=_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(self._p.pid, 9)
                out, err = self._p.communicate()
            self._res = (self._p.returncode, out, err)
            sys.stdout.write(out[-2000:])
            sys.stderr.write(err[-4000:])
        return self._res


def _ssh_shim(d):
    shim = os.path.join(d, "fake_ssh")
    with open(shim, "w") as f:
        f.write("#!/usr/bin/env bash\n"
                "# args: -o StrictHostKeyChecking=no <host> <command>\n"
                "shift 2; shift\n"
                'exec bash -c "$1"\n')
    os.chmod(shim, stat.S_IRWXU)
    hosts = os.path.join(d, "hosts.txt")
    with open(hosts, "w") as f:
        f.write("127.0.0.1\n127.0.0.1\n")
    return shim, hosts


_FLAKY = """import os, sys
m = {marker!r} + os.environ['DMLC_WORKER_ID']
n = int(open(m).read()) if os.path.exists(m) else 0
open(m, 'w').write(str(n + 1))
# rank 1 fails on its first attempt only
if os.environ['DMLC_WORKER_ID'] == '1' and n == 0:
    sys.exit(3)
assert os.environ['MXNET_DEFAULT_CTX'] == 'cpu'
print('worker', os.environ['DMLC_WORKER_ID'], 'ok', flush=True)
"""


@pytest.fixture(scope="module")
def _jobs():
    d = tempfile.mkdtemp(prefix="torch_dist_")
    marker = os.path.join(d, "attempt")
    flaky = os.path.join(d, "flaky.py")
    with open(flaky, "w") as f:
        f.write(_FLAKY.format(marker=marker))
    shim, hosts = _ssh_shim(d)
    cifar = os.path.join(_REPO, "mxnet_tpu_torch", "example",
                         "distributed_training", "cifar10_dist.py")
    slow = {"SLOW_SLEEP": "4"}
    # the reference's runs in jobs of their own: each compiles its own
    # programs, so together they take about as long as one
    jobs = {
        **{f"reference_{run}": _Job(
            [sys.executable, os.path.join(_REPO, "tools", "launch.py"),
             "-n", "2", "--cpu", sys.executable,
             _test("torch_dist_trainer_worker.py"), "jax",
             os.path.join(d, "jax"), run]) for run in _TRAINER_RUNS},
        "port_trainer": _Job(_launch_cmd(
            2, _test("torch_dist_trainer_worker.py"), "torch",
            os.path.join(d, "torch"), *_TRAINER_RUNS)),
        "sync_native": _Job(_launch_cmd(
            3, _test("torch_dist_sync_kvstore.py"))),
        "sync_python": _Job(_launch_cmd(
            2, _test("torch_dist_sync_kvstore.py"),
            launcher_args=("--env", "MXNET_PS_NATIVE=0"))),
        "async_native": _Job(_launch_cmd(
            3, _test("torch_dist_async_worker.py")), env=_env(**slow)),
        "async_python": _Job(_launch_cmd(
            3, _test("torch_dist_async_worker.py"),
            launcher_args=("--env", "MXNET_PS_NATIVE=0")),
            env=_env(**slow)),
        "restarts": _Job(_launch_cmd(
            2, flaky, launcher_args=("--max-restarts", "2"))),
        "restart_drill": _Job(_launch_cmd(
            3, _test("torch_dist_ps_restart_worker.py"),
            launcher_args=("--env", "MXNET_PS_NATIVE=0"))),
        "ssh": _Job([sys.executable, _LAUNCH,
                     "-n", "2", "--launcher", "ssh", "-H", hosts,
                     "--ssh-cmd", shim, "--workdir", _REPO, "--cpu",
                     "--port", str(_free_port()), sys.executable,
                     _test("torch_dist_async_worker.py")]),
        "cifar_sync": _Job(_launch_cmd(
            2, cifar, "--synthetic", "--steps", "3", "--batch-size", "4",
            "--out", os.path.join(d, "cifar_sync"))),
        "cifar_async": _Job(_launch_cmd(
            2, cifar, "--synthetic", "--steps", "3", "--batch-size", "4",
            "--kvstore", "dist_async", "--out",
            os.path.join(d, "cifar_async"))),
    }
    jobs["_dir"] = d
    jobs["_marker"] = marker
    yield jobs
    for job in jobs.values():
        if isinstance(job, _Job):
            job.result()
    shutil.rmtree(d, ignore_errors=True)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ok(job, n, what):
    rc, out, _ = job.result()
    assert rc == 0
    for r in range(n):
        assert f"[worker {r}] {what}" in out
    return out


@pytest.mark.parametrize("job,n,shard", [("sync_native", 3, "native"),
                                         ("sync_python", 2, "python")])
def test_dist_sync_kvstore_invariants(_jobs, job, n, shard):
    out = _ok(_jobs[job], n, "dist_sync_kvstore OK")
    assert out.count(f"shard {shard})") == n


@pytest.mark.parametrize("job,shard", [("async_native", "native"),
                                       ("async_python", "python")])
def test_dist_async_applies_on_arrival(_jobs, job, shard):
    out = _ok(_jobs[job], 3, "dist_async OK")
    assert out.count(f"shard {shard})") == 3


def test_local_launcher_restarts_failed_worker(_jobs):
    rc, out, err = _jobs["restarts"].result()
    assert rc == 0, err
    assert "worker 0 ok" in out and "worker 1 ok" in out
    assert "restarting" in err
    with open(_jobs["_marker"] + "1") as f:
        assert f.read() == "2"  # rank 1 ran twice


def test_launcher_propagates_exit_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text("import os, sys\n"
                      "sys.exit(5 if os.environ['DMLC_WORKER_ID'] == '1' "
                      "else 0)\n")
    res = subprocess.run(_launch_cmd(2, str(script)), env=_env(),
                         cwd=_REPO, timeout=120, capture_output=True,
                         text=True)
    assert res.returncode == 5


def test_ps_shard_restart_and_heartbeat_failover(_jobs):
    """A shard that comes back empty on a new port is found under its
    next address epoch and refilled; the liveness probe outlives rank
    0's shard (``tests/torch_dist_ps_restart_worker.py``)."""
    _ok(_jobs["restart_drill"], 3, "ps_restart drill OK")


def test_ssh_launcher_with_shim(_jobs):
    _ok(_jobs["ssh"], 2, "dist_async OK")


def test_dist_sync_single_process_is_a_group_of_one():
    """Outside a launched job ``dist_sync`` is rank 0 of 1, and push/pull
    still sum (reference ``tests/test_dist.py:54``)."""
    import mxnet_tpu_torch as mx

    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        assert kv.num_workers == 1 and kv.rank == 0
        kv.init("w", mx.nd.ones((2,)))
        kv.push("w", mx.nd.full((2,), 3.0))
        out = mx.nd.zeros((2,))
        kv.pull("w", out=out)
        onp.testing.assert_allclose(out.asnumpy(), [3.0, 3.0])


def _trainer_matches_reference(jobs, run):
    _ok(jobs[f"reference_{run}"], 2, "jax trainer OK")
    _ok(jobs["port_trainer"], 2, "torch trainer OK")
    d = jobs["_dir"]

    def load(name):
        with onp.load(os.path.join(d, name)) as f:
            return dict(f)

    ref = load(f"jax.{run}.r0.npz")
    got = [load(f"torch.{run}.r{r}.npz") for r in (0, 1)]
    assert sorted(got[0]) == sorted(ref)
    moved = 0.0
    for name in ref:
        want = ref[name]
        scale = max(float(onp.abs(want).max()), 1e-30)
        assert float(onp.abs(got[0][name] - want).max()) <= 1e-5 * scale, \
            name
        if ":" in name:
            continue  # the start, and each worker's loss on its own data
        assert hashlib.sha256(got[0][name].tobytes()).hexdigest() \
            == str(got[1][name]), name  # rank 1's replica, bit for bit
        moved = max(moved, float(onp.abs(want - ref["init:" + name]).max()))
    assert moved > 0.1  # the steps moved the weights by far more


def test_trainer_matches_reference_two_workers(_jobs):
    _trainer_matches_reference(_jobs, "f64")


def test_trainer_update_on_kvstore_matches_reference(_jobs):
    """``update_on_kvstore=True``, the default for a ``dist*`` name: the
    store's updater applies the summed gradient to the stored weight."""
    _trainer_matches_reference(_jobs, "f64_uokv")


@pytest.mark.parametrize("kvstore", ["sync", "async"])
def test_cifar10_dist_example_two_workers(_jobs, kvstore):
    rc, out, err = _jobs[f"cifar_{kvstore}"].result()
    assert rc == 0, err[-2000:]
    prefix = os.path.join(_jobs["_dir"], f"cifar_{kvstore}")
    reports = []
    for r in (0, 1):
        with open(f"{prefix}.r{r}.json") as f:
            reports.append(json.load(f))
    for rep in reports:
        assert rep["num_workers"] == 2 and rep["backend"] == "gloo"
        assert rep["device"] == "cpu(0)"
        assert all(onp.isfinite(rep["losses"]))
        assert rep["wire_bytes_per_step"] > 0
    if kvstore == "async":
        assert reports[0]["shard"] in ("native", "python")
    a, b = (onp.load(f"{prefix}.r{r}.npz") for r in (0, 1))
    for name in a.files:
        if "running_" not in name and kvstore == "sync":
            assert onp.array_equal(a[name], b[name]), name
