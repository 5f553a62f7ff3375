"""The port's asynchronous checkpoint (``CheckpointManager.save_async``,
``wait_async``, ``close_async``, ``flush_emergency``) and its
``tools/ckpt_fsck.py`` held against the JAX package on the CPU.

- ``save_async`` versions, the bounded queue's back-pressure, the
  emergency flush of the freshest unwritten snapshot and a
  ``ckpt.async`` crash mid-payload run on both packages with the same
  fault spec; versions, cursors and arrays agree exactly.
- A version the port writes asynchronously verifies and loads in the
  reference's ``CheckpointManager`` (arrays bit for bit, the ``.params``
  bytes equal, the cursor and the topology equal), and a reference
  version loads in the port; ``.states`` stay per package (ROADMAP
  §A 7).
- The port's ``ckpt_fsck`` report equals the reference tool's on clean
  and corrupted trees, and so do the exit codes.

The card's counterpart (the asynchronous capture of CUDA tensors
updated in place right after ``save_async`` returns equals a
synchronous ``save`` byte for byte) is
``tests/test_torch_cuda.py::test_async_capture_of_cuda_tensors_equals_sync_save``:
that file runs on the card's host, which has no JAX.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.resilience import elastic as j_elastic  # noqa: E402
from mxnet_tpu.resilience import faultsim as j_faultsim  # noqa: E402
from mxnet_tpu.resilience.checkpoint import \
    CheckpointManager as JMgr  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.resilience import elastic as t_elastic  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_faultsim  # noqa: E402
from mxnet_tpu_torch.resilience.checkpoint import \
    CheckpointManager as TMgr  # noqa: E402
from mxnet_tpu_torch.tools import ckpt_fsck as t_fsck  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from tools import ckpt_fsck as j_fsck  # noqa: E402

#: (package, its CheckpointManager, its faultsim)
PKGS = {"port": (tmx, TMgr, t_faultsim), "ref": (jmx, JMgr, j_faultsim)}


@pytest.fixture(autouse=True)
def _host():
    t_faultsim.reset("")
    j_faultsim.reset("")
    with tmx.cpu():
        yield
    t_faultsim.reset("")
    j_faultsim.reset("")


def _arr(pkg, a):
    return pkg.nd.array(onp.asarray(a, "float32"))


def _run_port(body, timeout=120):
    env = dict(os.environ, PYTHONPATH=_REPO, MXNET_DEFAULT_CTX="cpu",
               OMP_NUM_THREADS="1")
    env.pop("MXNET_FAULT_SPEC", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


# ======================================================== async writes
@pytest.mark.parametrize("which", sorted(PKGS))
def test_save_async_versions_and_emergency(tmp_path, which):
    pkg, Mgr, _ = PKGS[which]
    mgr = Mgr(str(tmp_path / "ck"))
    v1 = mgr.save_async(arg_params={"w": _arr(pkg, onp.ones((4, 4)))},
                        batch_cursor=1)
    v2 = mgr.save_async(
        arg_params={"w": _arr(pkg, onp.full((4, 4), 2.0))},
        batch_cursor=2)
    assert (v1, v2) == (1, 2)
    assert mgr.wait_async(timeout=10)
    st = mgr.load()
    assert (st["version"], st["batch_cursor"]) == (2, 2)
    onp.testing.assert_array_equal(st["arg_params"]["w"].asnumpy(), 2.0)
    # the freshest capture is already durable: the flush is a no-op
    assert mgr.flush_emergency("test") is None
    assert mgr.close_async()
    assert mgr.close_async()  # idempotent
    assert [mgr.verify(e) for e in mgr.epochs()] == [True, True]


@pytest.mark.parametrize("which", sorted(PKGS))
def test_save_async_backpressure_bounded_queue(tmp_path, which):
    """A slow disk (a ``ckpt.async`` delay) back-pressures the producer
    through the bounded queue instead of accumulating snapshots."""
    pkg, Mgr, fs = PKGS[which]
    mgr = Mgr(str(tmp_path / "ck"))
    w = {"w": _arr(pkg, onp.ones((4,)))}
    fs.reset("ckpt.async:delay=0.25@1-10")
    t0 = time.monotonic()
    for c in range(4):  # depth 1: submits 2..4 wait for the disk
        mgr.save_async(arg_params=w, batch_cursor=c + 1, queue_depth=1)
    blocked = time.monotonic() - t0
    assert blocked > 0.4, blocked  # at least two waits landed on us
    assert mgr.wait_async(timeout=10)
    mgr.close_async()
    assert Mgr(str(tmp_path / "ck")).load()["batch_cursor"] == 4


def test_backpressure_depth_two_holds_two_captures(tmp_path):
    """At the default depth of 2 a writer stuck on its first snapshot
    lets two more captures queue, and the third submit waits."""
    mgr = TMgr(str(tmp_path / "ck"))
    w = {"w": _arr(tmx, onp.ones((4,)))}
    t_faultsim.reset("ckpt.async:delay=0.6@1")
    t0 = time.monotonic()
    for c in range(3):  # one in the writer, two queued: no wait
        mgr.save_async(arg_params=w, batch_cursor=c + 1)
    queued = time.monotonic() - t0
    mgr.save_async(arg_params=w, batch_cursor=4)  # the queue is full
    blocked = time.monotonic() - t0
    assert queued < 0.3 < blocked, (queued, blocked)
    assert mgr.wait_async(timeout=10)
    mgr.close_async()
    assert [mgr.load(e)["batch_cursor"] for e in mgr.epochs()] == \
        [1, 2, 3, 4]


@pytest.mark.parametrize("which", sorted(PKGS))
def test_emergency_flush_writes_unwritten_freshest(tmp_path, which):
    """A peer death mid-queue: the freshest CAPTURED snapshot is flushed
    synchronously though the writer never got to it, and the armed
    fault spec cannot touch the emergency write."""
    pkg, Mgr, fs = PKGS[which]
    mgr = Mgr(str(tmp_path / "ck"))
    fs.reset("ckpt.async:delay=1.5@1")
    mgr.save_async(arg_params={"w": _arr(pkg, onp.full((4,), 7.0))},
                   batch_cursor=5, queue_depth=2)
    path = mgr.flush_emergency("peer_death")
    assert path == mgr.manifest_path(1) and os.path.exists(path)
    st = Mgr(str(tmp_path / "ck")).load()
    assert st["batch_cursor"] == 5
    assert st["extra"]["emergency"] == "peer_death"
    onp.testing.assert_array_equal(st["arg_params"]["w"].asnumpy(), 7.0)
    mgr.close_async()


def test_capture_is_a_copy_the_next_update_cannot_reach(tmp_path):
    """The reference's arrays are immutable; the port's are updated in
    place.  A snapshot captured before an in-place update holds the
    values at capture time, even while the writer is still behind."""
    mgr = TMgr(str(tmp_path / "ck"))
    w = _arr(tmx, onp.arange(6.0))
    t_faultsim.reset("ckpt.async:delay=0.3@1")
    mgr.save_async(arg_params={"w": w}, batch_cursor=1)
    w._data.add_(100.0)  # the next step's optimizer update
    assert mgr.wait_async(timeout=10)
    mgr.close_async()
    onp.testing.assert_array_equal(
        mgr.load()["arg_params"]["w"].asnumpy(), onp.arange(6.0))


def test_ckpt_async_crash_leaves_previous_good(tmp_path):
    """A crash mid-payload inside the background writer leaves latest ==
    previous-good and no torn final file (the stray temp is the
    proof); both fsck tools read the tree clean."""
    prefix = str(tmp_path / "ck")
    r = _run_port(f"""
        import numpy as onp
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.resilience import faultsim
        from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

        mgr = CheckpointManager({prefix!r})
        w = {{"w": mx.nd.array(onp.ones((64,), "float32"))}}
        mgr.save(1, arg_params=w, batch_cursor=1)
        faultsim.reset("ckpt.async:crash@2")
        mgr.save_async(arg_params=w, batch_cursor=2)
        assert mgr.wait_async(timeout=10)
        raise SystemExit("unreachable: the crash must have fired")
        """)
    assert r.returncode == t_faultsim.CRASH_EXIT_CODE, r.stderr[-2000:]
    for Mgr in (TMgr, JMgr):
        mgr = Mgr(prefix)
        assert mgr.latest_epoch() == 1
        assert mgr.load()["batch_cursor"] == 1
        assert not os.path.exists(mgr.params_path(2))
    assert any(".tmp." in n for n in os.listdir(tmp_path))
    for fsck in (t_fsck, j_fsck):
        report = fsck.fsck(str(tmp_path), check_all=True)
        assert report["clean"], report["problems"]
        assert report["prefixes"][0]["stray_temps"]


# ================================================== across the packages
def test_async_version_crosses_packages(tmp_path):
    rng = onp.random.RandomState(0)
    arg = {"fc_weight": rng.randn(8, 5).astype("float32"),
           "fc_bias": rng.randn(8).astype("float32")}
    aux = {"bn_moving_var": rng.rand(8).astype("float32")}
    topo = {}
    for name, el in (("port", t_elastic), ("ref", j_elastic)):
        topo[name] = el.topology_block(world_size=2, num_processes=2,
                                       sharding="none", global_batch=16)
    assert topo["port"] == topo["ref"]
    written = {}
    for name in ("port", "ref"):
        pkg, Mgr, _ = PKGS[name]
        mgr = Mgr(str(tmp_path / name / "ck"))
        v = mgr.save_async(
            arg_params={k: _arr(pkg, a) for k, a in arg.items()},
            aux_params={k: _arr(pkg, a) for k, a in aux.items()},
            batch_cursor=3, epoch=1, topology=topo[name])
        assert mgr.wait_async(timeout=10) and mgr.close_async()
        written[name] = (mgr, v)
    # the same arrays give the same .params bytes
    paths = [m.params_path(v) for m, v in written.values()]
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()
    # each package's version verifies and loads in the other's manager
    for writer, Reader in (("port", JMgr), ("ref", TMgr)):
        mgr, v = written[writer]
        reader = Reader(mgr.prefix)
        assert reader.verify(v)
        st = reader.load()
        assert (st["version"], st["epoch"], st["batch_cursor"]) == \
            (v, 1, 3)
        assert st["topology"] == topo["ref"]
        for k, a in arg.items():
            onp.testing.assert_array_equal(st["arg_params"][k].asnumpy(), a)
        for k, a in aux.items():
            onp.testing.assert_array_equal(st["aux_params"][k].asnumpy(), a)


# ================================================================ fsck
def _fsck_tree(root):
    mgr = TMgr(str(root / "ck"))
    w = {"w": _arr(tmx, onp.ones((16,)))}
    mgr.save(1, arg_params=w, batch_cursor=0)
    mgr.save_async(arg_params=w, batch_cursor=3)
    mgr.wait_async(timeout=10)
    mgr.close_async()
    other = JMgr(str(root / "other"))
    other.save(1, arg_params={"w": _arr(jmx, onp.zeros((3,)))})
    return mgr


@pytest.mark.parametrize("mode", ["clean", "torn_params", "torn_manifest"])
def test_ckpt_fsck_report_matches_reference(tmp_path, mode, capsys):
    mgr = _fsck_tree(tmp_path)
    if mode == "torn_params":
        with open(mgr.params_path(2), "r+b") as f:
            f.truncate(10)
    elif mode == "torn_manifest":
        with open(mgr.manifest_path(2), "w") as f:
            f.write("{not json")
    for target in (str(tmp_path), str(tmp_path / "ck")):
        for check_all in (False, True):
            want = j_fsck.fsck(target, check_all=check_all)
            got = t_fsck.fsck(target, check_all=check_all)
            assert got == want, (target, check_all)
    assert got["clean"] == (mode == "clean")
    argv = [str(tmp_path), "--all"]
    assert t_fsck.main(argv) == j_fsck.main(argv) == \
        (0 if mode == "clean" else 1)
    assert t_fsck.main(argv + ["--json"]) == j_fsck.main(argv + ["--json"])
    empty = [str(tmp_path / "empty")]
    assert t_fsck.main(empty) == j_fsck.main(empty) == 2
    capsys.readouterr()
