"""The port's self-healing runtime (``resilience/healing.py``, its
supervisor, the watchdog's abort and ``Module.fit``'s wiring) held
against the JAX package on the CPU.

- The failure detector's four cases (a stale beat, a dead same-host
  pid, grace for a leftover beat, grace for a peer that never beat),
  each on a heartbeat directory one package writes and both packages'
  detectors read, in both directions: the same verdicts.
- ``guard_collective``: abandonment of a wedged call, translation of a
  backend error under a confirmed death (in process, and on a
  two-process CPU gloo group whose peer is SIGKILLed:
  ``tests/torch_elastic_worker.py guard``), the timeout.
- ``surviving_ranks`` / ``elect_coordinator`` equal the reference's,
  rank 0's death included.
- The supervisor relaunches on exactly the statuses the reference
  heals (0, 1, 83, 87, -9, -15 compared), bounded, with the
  ``heal.relaunch`` point; its CLI.
- ``heal`` records validate against the reference's schema
  (``mxnet_tpu.telemetry.schema.validate_lines``).
- ``Module.fit``'s ``MXNET_SNAPSHOT_EVERY`` cadence: the same versions
  and cursors as the reference's fit on the same MLP and iterator.
- The ghost-peer stand-in of ``tests/test_healing.py``: fit heal-exits
  rc 83 with the heal chain in its run log; the relaunched
  ``fit(resume_from=)`` equals the port's uninterrupted run bit for bit
  and the reference's within ``FIT_TOL`` (1e-5, what
  ``tests/test_torch_module.py`` holds ``fit`` to).
- ``fit(resume_from=)`` at world 1 of a snapshot stamped by a world of
  2: ``reshards``, the ``resize`` event and, on a relaunch,
  ``auto_reshards`` with the ``heal`` "resume" record; the resume
  equals the uninterrupted run bit for bit.
- ``MXNET_WATCHDOG_ABORT``: rc 85 with the emergency checkpoint on disk.
- (slow) THE drill: two CPU gloo processes, rank 1 SIGKILLed mid-step,
  rank 0 under the supervisor heals to world 1; its final parameters
  against ``tests/healing_worker.py reference`` within rtol 1e-5,
  atol 1e-7.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.resilience import faultsim as j_faultsim  # noqa: E402
from mxnet_tpu.resilience import healing as j_healing  # noqa: E402
from mxnet_tpu.resilience.checkpoint import \
    CheckpointManager as JMgr  # noqa: E402
from mxnet_tpu.telemetry import schema as j_schema  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.resilience import elastic as t_elastic  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_faultsim  # noqa: E402
from mxnet_tpu_torch.resilience import healing as t_healing  # noqa: E402
from mxnet_tpu_torch.resilience.checkpoint import \
    CheckpointManager as TMgr  # noqa: E402
from mxnet_tpu_torch.telemetry.watchdog import \
    WATCHDOG_ABORT_EXIT_CODE  # noqa: E402

FIT_TOL = 1e-5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAL = {"port": t_healing, "ref": j_healing}


@pytest.fixture(autouse=True)
def _clean_state():
    for fs in (t_faultsim, j_faultsim):
        fs.reset("")
    for h in HEAL.values():
        h.disarm()
    with tmx.cpu():
        yield
    for fs in (t_faultsim, j_faultsim):
        fs.reset("")
    for h in HEAL.values():
        h.disarm()


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=_REPO, MXNET_DEFAULT_CTX="cpu",
               OMP_NUM_THREADS="1")
    env.pop("MXNET_FAULT_SPEC", None)
    env.pop("XLA_FLAGS", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _start(body, env=None):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(body)],
                            env=env or _env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _done(p, timeout=120):
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


def _reaped_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _edit_beat(path, **fields):
    with open(path) as f:
        payload = json.load(f)
    payload.update(fields)
    with open(path, "w") as f:
        f.write(json.dumps(payload))


# ====================================================== peer liveness
def _detectors(hb, timeout):
    return {k: h.FailureDetector(hb, rank=0, num_ranks=2, timeout=timeout)
            for k, h in HEAL.items()}


def _verdicts(dets):
    return {k: (d.dead_peers(), sorted(d.reasons())) for k, d in
            dets.items()}


@pytest.mark.parametrize("writer", sorted(HEAL))
def test_detector_stale_beat_and_sticky(tmp_path, writer):
    hb = str(tmp_path / "hb")
    w = HEAL[writer]
    w._write_beat(hb, 0)
    ghost = w._write_beat(hb, 1)
    _edit_beat(ghost, host="test-ghost")  # no pid fast path
    dets = _detectors(hb, 0.4)
    assert _verdicts(dets) == {k: ([], []) for k in HEAL}
    old = time.time() - 99.0
    os.utime(ghost, (old, old))
    assert _verdicts(dets) == {k: ([1], [1]) for k in HEAL}
    assert all("stale" in d.reasons()[1] for d in dets.values())
    w._write_beat(hb, 1)  # a resurrected beat cannot undo the death
    assert [d.dead_peers() for d in dets.values()] == [[1], [1]]
    with pytest.raises(t_healing.PeerDeadError, match=r"\[1\]"):
        dets["port"].check()


@pytest.mark.parametrize("writer", sorted(HEAL))
def test_detector_dead_pid_is_immediate(tmp_path, writer):
    hb = str(tmp_path / "hb")
    w = HEAL[writer]
    w._write_beat(hb, 0)
    dets = _detectors(hb, 60.0)  # armed first: the drill's order
    path = w._write_beat(hb, 1)
    _edit_beat(path, pid=_reaped_pid())
    t0 = time.monotonic()
    assert [d.dead_peers() for d in dets.values()] == [[1], [1]]
    assert time.monotonic() - t0 < 1.0
    assert all("pid" in d.reasons()[1] for d in dets.values())


@pytest.mark.parametrize("writer", sorted(HEAL))
def test_detector_leftover_beat_gets_grace(tmp_path, writer):
    hb = str(tmp_path / "hb")
    w = HEAL[writer]
    leftover = w._write_beat(hb, 1)
    _edit_beat(leftover, pid=_reaped_pid())  # the old incarnation's
    old = time.time() - 999.0
    os.utime(leftover, (old, old))
    time.sleep(0.05)
    dets = _detectors(hb, 0.6)
    assert _verdicts(dets) == {k: ([], []) for k in HEAL}
    w._write_beat(hb, 1)  # the new incarnation beats: alive
    assert _verdicts(dets) == {k: ([], []) for k in HEAL}
    time.sleep(0.7)
    assert _verdicts(dets) == {k: ([1], [1]) for k in HEAL}
    assert all("stale" in d.reasons()[1] for d in dets.values())


@pytest.mark.parametrize("writer", sorted(HEAL))
def test_detector_never_beat_grace(tmp_path, writer):
    hb = str(tmp_path / "hb")
    HEAL[writer]._write_beat(hb, 0)
    dets = _detectors(hb, 0.3)
    assert _verdicts(dets) == {k: ([], []) for k in HEAL}
    time.sleep(0.35)
    assert _verdicts(dets) == {k: ([1], [1]) for k in HEAL}
    assert all("never beat" in d.reasons()[1] for d in dets.values())


def test_beats_have_the_reference_layout(tmp_path):
    hb = str(tmp_path / "hb")
    for r, h in enumerate(HEAL.values()):
        h._write_beat(hb, r, step=5)
    got, want = (h._read_beat(hb, r)[0] for r, h in
                 enumerate(HEAL.values()))
    assert sorted(got) == sorted(want) == ["host", "pid", "rank", "step",
                                           "time"]
    assert (got["host"], got["pid"], got["step"]) == \
        (want["host"], want["pid"], want["step"])
    t_faultsim.reset("peer.heartbeat:delay=0.01@1-2")
    with t_healing.Heartbeater(str(tmp_path / "hb2"), 0, interval=0.05):
        time.sleep(0.3)
        payload, age = j_healing._read_beat(str(tmp_path / "hb2"), 0)
        assert payload["rank"] == 0 and payload["pid"] == os.getpid()
        assert age < 0.25
        assert t_faultsim.hits("peer.heartbeat") >= 2
    assert t_healing._read_beat(str(tmp_path / "hb2"), 0) == (None, None)


def test_surviving_ranks_and_elect_coordinator(tmp_path):
    hb = str(tmp_path / "hb")
    for r in (1, 2, 3):
        t_healing._write_beat(hb, r)
    # rank 0 never beat: survivors renumber from the lowest survivor
    assert t_healing.surviving_ranks(hb, 4) == \
        j_healing.surviving_ranks(hb, 4) == [1, 2, 3]
    # rank 0's beat names a dead pid: the same verdict
    dead = j_healing._write_beat(hb, 0)
    _edit_beat(dead, pid=_reaped_pid())
    assert t_healing.surviving_ranks(hb, 4) == \
        j_healing.surviving_ranks(hb, 4) == [1, 2, 3]
    # the caller's own rank always survives
    assert t_healing.surviving_ranks(hb, 4, self_rank=0) == \
        j_healing.surviving_ranks(hb, 4, self_rank=0) == [0, 1, 2, 3]
    for s in ([1, 2, 3], [3, 0], [2]):
        assert t_healing.elect_coordinator(s) == \
            j_healing.elect_coordinator(s)
    with pytest.raises(MXNetError, match="no survivors"):
        t_healing.elect_coordinator([])


# ================================================= guarded collectives
def test_guard_collective_abandons_on_peer_death(tmp_path):
    hb = str(tmp_path / "hb")
    os.makedirs(hb)
    det = t_healing.FailureDetector(hb, rank=0, num_ranks=2, timeout=0.2)
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(t_healing.PeerDeadError, match="abandoned"):
        t_healing.guard_collective(lambda: release.wait(30), det,
                                   poll=0.02)
    assert time.monotonic() - t0 < 5.0  # not the 30 s block
    release.set()


def test_guard_collective_translates_and_times_out(tmp_path):
    hb = str(tmp_path / "hb")
    os.makedirs(hb)
    dead = t_healing.FailureDetector(hb, rank=0, num_ranks=2, timeout=0.0)

    def boom():
        raise RuntimeError("Connection closed by peer")

    with pytest.raises(t_healing.PeerDeadError) as e:
        t_healing.guard_collective(boom, dead, poll=0.01)
    assert isinstance(e.value.__cause__, RuntimeError)
    hb2 = str(tmp_path / "hb2")
    t_healing._write_beat(hb2, 1)
    alive = t_healing.FailureDetector(hb2, rank=0, num_ranks=2,
                                      timeout=60.0)
    with pytest.raises(RuntimeError, match="closed by peer"):
        t_healing.guard_collective(boom, alive, poll=0.01)
    assert t_healing.guard_collective(lambda: 41 + 1, alive) == 42
    ev = threading.Event()
    with pytest.raises(t_healing.CollectiveTimeout):
        t_healing.guard_collective(lambda: ev.wait(30), alive, poll=0.02,
                                   timeout=0.2)
    ev.set()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_guard_collective_on_a_gloo_group_with_a_sigkilled_peer(tmp_path):
    """A real two-process gloo group: rank 1 is SIGKILLed after one
    all-reduce, and rank 0's next all-reduce, under the guard, fails
    with gloo's connection error, which the guard translates."""
    worker = os.path.join(_REPO, "tests", "torch_elastic_worker.py")
    port, hb = _free_port(), str(tmp_path / "hb")
    procs = [subprocess.Popen(
        [sys.executable, worker, "guard", f"127.0.0.1:{port}", str(pid),
         "2", hb], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert procs[1].returncode == -signal.SIGKILL
    assert procs[0].returncode == 0, outs[0][1][-3000:]
    assert "[0] PeerDeadError translated [1]" in outs[0][0], outs[0]
    assert "RuntimeError" in outs[0][0]


# =========================================================== supervisor
_STATUS_SCRIPT = """import os, signal, sys
a = os.environ.get("MXNET_HEAL_ATTEMPT", "?")
open({marker!r}, "a").write(a + "\\n")
rc = {rc} if a == "0" else 0
if rc < 0:
    os.kill(os.getpid(), -rc)
sys.exit(rc)
"""


@pytest.mark.parametrize("rc", [0, 1, 83, 87, -9, -15])
def test_supervisor_relaunches_on_the_reference_statuses(tmp_path, rc):
    runs = {}
    for name, h in HEAL.items():
        marker = str(tmp_path / f"{name}.txt")
        final = h.supervise([sys.executable, "-c", _STATUS_SCRIPT.format(
            marker=marker, rc=rc)], max_relaunch=3)
        with open(marker) as f:
            runs[name] = (h._healable(rc), final, f.read().split())
    assert runs["port"] == runs["ref"]
    healable = rc in (83, 87) or rc < 0
    assert runs["port"] == (
        healable, 0 if healable else rc,
        ["0", "1"] if healable else ["0"])
    assert t_faultsim.hits("heal.relaunch") == int(healable)


def test_supervisor_bounded_and_heal_relaunch_point(tmp_path):
    always = [sys.executable, "-c", "import sys; sys.exit(83)"]
    assert t_healing.supervise(always, max_relaunch=2) == 83
    assert t_faultsim.hits("heal.relaunch") == 2
    t_faultsim.reset("heal.relaunch:raise@1")
    with pytest.raises(t_faultsim.FaultInjected):
        t_healing.supervise(always, max_relaunch=2)


def test_supervisor_cli(tmp_path):
    script = ("import os, sys\n"
              "m = sys.argv[1]\n"
              "open(m, 'a').write(os.environ.get('MXNET_HEAL_ATTEMPT', '?')"
              " + '\\n')\n"
              "sys.exit(87 if os.environ.get('MXNET_HEAL_ATTEMPT') == '0' "
              "else 0)\n")
    cli = [sys.executable, "-m", "mxnet_tpu_torch.resilience.healing"]
    m1, m2, m3 = (str(tmp_path / f"m{i}.txt") for i in range(3))
    jobs = [
        subprocess.Popen(cli + ["--relaunch", "--max-relaunch", "1", "--",
                                sys.executable, "-c", script, m1],
                         env=_env()),
        # without --relaunch the command runs once, MXNET_HEAL_ATTEMPT
        # unset, and its status is the CLI's
        subprocess.Popen(cli + ["--", sys.executable, "-c",
                                script.replace("else 0", "else 3"), m2],
                         env=_env()),
        # MXNET_HEAL_MAX_RELAUNCH bounds it when --max-relaunch is absent
        subprocess.Popen(cli + ["--relaunch", "--", sys.executable, "-c",
                                "import sys; open(sys.argv[1], 'a')"
                                ".write('x\\n'); sys.exit(83)", m3],
                         env=_env(MXNET_HEAL_MAX_RELAUNCH=1))]
    rcs = [p.wait(timeout=120) for p in jobs]
    assert rcs == [0, 3, 83]
    reads = []
    for m in (m1, m2, m3):
        with open(m) as f:
            reads.append(f.read().split())
    assert reads == [["0", "1"], ["?"], ["x", "x"]]


# ============================================================ records
def test_heal_records_validate_against_reference_schema(tmp_path):
    from mxnet_tpu_torch import telemetry

    tf = str(tmp_path / "metrics.prom")
    log = telemetry.RunLog(str(tmp_path / "rl.jsonl"), textfile=tf)
    log.count("peer_deaths")
    log.heal("peer_death", peer=1, detail="pid gone")
    log.heal("emergency_ckpt", detail="peer_death", paths=["a", "b"])
    log.heal("resume", old_world=2, new_world=1, batch_cursor=3)
    log.heal("watchdog_abort", phase="fit", quiet_s=0.4, stalls=1,
             code=WATCHDOG_ABORT_EXIT_CODE)
    log.close()
    with open(tmp_path / "rl.jsonl") as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems
    heals = [r for r in records if r["type"] == "heal"]
    assert [h["action"] for h in heals] == [
        "peer_death", "emergency_ckpt", "resume", "watchdog_abort"]
    assert heals[0]["peer_deaths"] == 1 and heals[0]["peer"] == 1
    with open(tf) as f:
        prom = f.read()
    for row in ("mxnet_tpu_peer_deaths 1", "mxnet_tpu_auto_reshards 0",
                "mxnet_tpu_ckpt_async_writes 0",
                "mxnet_tpu_emergency_ckpts 0",
                "mxnet_tpu_heal_relaunches 0"):
        assert row in prom, (row, prom)


# ===================================================== fit + stand-in
def _mlp(pkg):
    sym = pkg.sym
    d = sym.Variable("data")
    fc1 = sym.FullyConnected(d, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def _fit_mlp(pkg, prefix=None):
    """The MLP's 2-epoch Adam fit on the 8 batches of 8 (the reference's
    stand-in recipe), checkpointing to ``prefix`` when given; returns
    the final parameters."""
    pkg.random.seed(11)
    onp.random.seed(11)
    rng = onp.random.RandomState(7)
    X = rng.randn(64, 10).astype("float32")
    y = (X @ rng.randn(10, 4)).argmax(axis=1).astype("float32")
    it = pkg.io.NDArrayIter(X, y, batch_size=8, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.fit(it, num_epoch=2, optimizer="adam",
            optimizer_params=(("learning_rate", 0.05),),
            initializer=pkg.init.Xavier(), checkpoint=prefix)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_snapshot_cadence_matches_reference(tmp_path, monkeypatch):
    from mxnet_tpu_torch import telemetry

    monkeypatch.setenv("MXNET_SNAPSHOT_EVERY", "3")
    runlog = str(tmp_path / "rl.jsonl")
    telemetry.reset(runlog)
    try:
        t_final = _fit_mlp(tmx, str(tmp_path / "t"))
    finally:
        telemetry.close()
    j_final = _fit_mlp(jmx, str(tmp_path / "j"))
    series = {}
    for name, Mgr in (("t", TMgr), ("j", JMgr)):
        mgr = Mgr(str(tmp_path / name))
        series[name] = [(e, mgr.load(e)["epoch"], mgr.load(e)
                         ["batch_cursor"], mgr.verify(e))
                        for e in mgr.epochs()]
    assert series["t"] == series["j"]
    cursors = [c for _, _, c, _ in series["t"]]
    assert any(c > 0 for c in cursors) and 0 in cursors
    for k in j_final:
        onp.testing.assert_allclose(t_final[k], j_final[k], atol=FIT_TOL)
    with open(runlog) as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems[:5]
    end = [r for r in records if r["type"] == "run_end"][-1]
    assert end["counters"]["ckpt_async_writes"] >= 2
    assert end["counters"]["checkpoints"] >= 3


_FIT_BODY = """
    import json, os
    import numpy as onp
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym

    mx.random.seed(11); onp.random.seed(11)
    rng = onp.random.RandomState(7)
    X = rng.randn(64, 10).astype("float32")
    y = (X @ rng.randn(10, 4)).argmax(axis=1).astype("float32")
    it = mx.io.NDArrayIter(X, y, batch_size=8, shuffle=False)
    d = sym.Variable("data")
    fc1 = sym.FullyConnected(d, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                            name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    prefix = {prefix!r}
    FIT = dict(num_epoch=2, optimizer="adam",
               optimizer_params=(("learning_rate", 0.05),),
               initializer=mx.init.Xavier())

    def dump():
        arg_p, _ = mod.get_params()
        print(json.dumps({{k: v.asnumpy().ravel().tolist()
                           for k, v in sorted(arg_p.items())}}))
"""

_GHOST = """
    import time
    from mxnet_tpu_torch.resilience import healing

    hb = prefix + ".hb"
    state = {"armed": False, "stale": False}

    def _ghost():
        p = healing._write_beat(hb, 1)
        with open(p) as f:
            payload = json.load(f)
        payload["host"] = "test-ghost"
        with open(p, "w") as f:
            f.write(json.dumps(payload))

    def cb(param):
        if not state["armed"]:
            state["armed"] = True
            healing.arm(hb, rank=0, num_ranks=2, timeout=0.5)
            _ghost()
        elif not state["stale"] and param.nbatch >= 4:
            state["stale"] = True
            p = healing._hb_path(hb, 1)
            os.utime(p, (time.time() - 99, time.time() - 99))
        elif not state["stale"]:
            _ghost()

    try:
        mod.fit(it, checkpoint=prefix, batch_end_callback=cb, **FIT)
    except healing.PeerDeadError:
        healing.heal_exit("peer_death")
    raise SystemExit("ghost never declared dead")
"""


def test_fit_peer_death_heals_and_resume_matches(tmp_path):
    """A fit armed with peer healing sees a ghost peer die mid-epoch,
    heal-exits rc 83 with an emergency checkpoint and the heal chain in
    its run log; the relaunched fit resumes and equals the port's
    uninterrupted run bit for bit, and the reference's within
    FIT_TOL."""
    prefix = str(tmp_path / "heal")
    runlog = str(tmp_path / "rl0.jsonl")
    ghost = _start(textwrap.dedent(_FIT_BODY.format(prefix=prefix))
                   + textwrap.dedent(_GHOST),
                   env=_env(MXNET_SNAPSHOT_EVERY=2, MXNET_RUNLOG=runlog))
    plain = _start(_FIT_BODY.format(prefix=str(tmp_path / "none"))
                   + "\n    mod.fit(it, **FIT)\n    dump()\n")
    rc, out, err = _done(ghost)
    assert rc == t_healing.PEER_DEATH_EXIT_CODE, (rc, err[-3000:])
    with open(runlog) as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems[:5]
    actions = {r["action"] for r in records if r["type"] == "heal"}
    assert {"peer_death", "heal_exit"} <= actions, actions
    end = [r for r in records if r["type"] == "run_end"][-1]
    assert end["counters"]["peer_deaths"] == 1
    st = TMgr(prefix).load(ctx=tmx.cpu())
    assert st["batch_cursor"] > 0
    resumed = _start(_FIT_BODY.format(prefix=prefix)
                     + "\n    mod.fit(it, resume_from=prefix, **FIT)"
                       "\n    dump()\n")
    rc, out, err = _done(resumed)
    assert rc == 0, err[-3000:]
    healed = json.loads(out.strip().splitlines()[-1])
    rc, out, err = _done(plain)
    assert rc == 0, err[-3000:]
    port = json.loads(out.strip().splitlines()[-1])
    ref = {k: v.ravel() for k, v in _fit_mlp(jmx).items()}
    assert sorted(healed) == sorted(port) == sorted(ref)
    for k in ref:
        onp.testing.assert_array_equal(healed[k], port[k], err_msg=k)
        onp.testing.assert_allclose(healed[k], ref[k], atol=FIT_TOL,
                                    err_msg=k)


@pytest.mark.parametrize("attempt", [0, 1])
def test_fit_resume_reshards_a_world_two_checkpoint(tmp_path, monkeypatch,
                                                    attempt):
    """``fit(resume_from=)`` at world 1 of a mid-epoch snapshot stamped
    by a world of 2 (local batch 4, the same global batch of 8): the
    verdict 2 → 1 is counted (``reshards``, a ``resize`` event) and, on
    a supervisor relaunch, also ``auto_reshards`` with a ``heal``
    "resume" record; the cursor carries over unchanged, and the resumed
    run equals the uninterrupted one bit for bit."""
    from mxnet_tpu_torch import telemetry

    prefix = str(tmp_path / "w2")
    monkeypatch.setenv("MXNET_SNAPSHOT_EVERY", "3")
    _fit_mlp(tmx, prefix)
    monkeypatch.delenv("MXNET_SNAPSHOT_EVERY")
    mgr = TMgr(prefix)
    mid = [e for e in mgr.epochs()
           if mgr._read_manifest(e)["batch_cursor"] > 0]
    assert mid, mgr.epochs()
    mid = mid[-1:]
    cursor = mgr._read_manifest(mid[0])["batch_cursor"]
    for e in mgr.epochs():  # the resume's newest version is the mid one
        if e > mid[0]:
            for suffix in (".manifest.json", ".params", ".states"):
                path = f"{prefix}-{e:04d}{suffix}"
                if os.path.exists(path):
                    os.remove(path)
    os.remove(mgr.latest_path())
    man = mgr._read_manifest(mid[0])
    assert man["topology"] == t_elastic.topology_block(
        world_size=1, num_processes=1, sharding="none", global_batch=8)
    man["topology"] = t_elastic.topology_block(
        world_size=2, num_processes=2, sharding="none", global_batch=8)
    with open(mgr.manifest_path(mid[0]), "w") as f:
        json.dump(man, f)
    assert mgr.latest_epoch() == mid[0]

    monkeypatch.setenv("MXNET_HEAL_ATTEMPT", str(attempt))
    runlog = str(tmp_path / "rl.jsonl")
    telemetry.reset(runlog)
    try:
        tmx.random.seed(11)
        onp.random.seed(11)
        rng = onp.random.RandomState(7)
        X = rng.randn(64, 10).astype("float32")
        y = (X @ rng.randn(10, 4)).argmax(axis=1).astype("float32")
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8, shuffle=False),
                num_epoch=2, optimizer="adam",
                optimizer_params=(("learning_rate", 0.05),),
                initializer=tmx.init.Xavier(), resume_from=prefix)
    finally:
        telemetry.close()
    healed = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    with open(runlog) as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems[:5]
    counters = [r for r in records if r["type"] == "run_end"][-1][
        "counters"]
    assert counters["reshards"] == 1
    assert counters["auto_reshards"] == attempt
    resize = [r for r in records if r.get("kind") == "resize"]
    assert [(r["old_world"], r["new_world"], r["batch_cursor"])
            for r in resize] == [(2, 1, cursor)]
    heals = [(r["action"], r["old_world"], r["new_world"],
              r["batch_cursor"], r["attempt"])
             for r in records if r["type"] == "heal"]
    assert heals == ([("resume", 2, 1, cursor, 1)] if attempt else [])
    plain = _fit_mlp(tmx)
    assert sorted(healed) == sorted(plain)
    for k in plain:
        onp.testing.assert_array_equal(healed[k], plain[k], err_msg=k)


# ============================================================ watchdog
_WEDGE = """
    import time
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import healing
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager
    from mxnet_tpu_torch.telemetry.watchdog import Watchdog

    # the freshest snapshot the abort must flush: captured, not written
    mgr = CheckpointManager({prefix!r})
    mgr._freshest = mgr._capture(
        7, arg_params={{"w": mx.nd.full((4,), 9.0)}}, batch_cursor=5)
    healing.register_emergency(mgr._emergency_hook)
    wd = Watchdog(timeout=0.2, max_dumps=1, poll=0.05).arm("wedge")
    time.sleep({sleep})
    print("survived", wd.stalls)
"""


def test_watchdog_abort_exits_with_the_emergency_checkpoint(tmp_path):
    from mxnet_tpu_torch.telemetry import find_flight_dumps

    runlog = str(tmp_path / "rl.jsonl")
    prefix = str(tmp_path / "ck")
    env = _env(MXNET_RUNLOG=runlog, MXNET_WATCHDOG_ABORT=1)
    wedged = _start(_WEDGE.format(prefix=prefix, sleep=30), env=env)
    # the observe-only default: the same wedge survives its dumps
    observed = _start(_WEDGE.format(prefix=str(tmp_path / "ck2"),
                                    sleep=1.2),
                      env=_env(MXNET_RUNLOG=str(tmp_path / "rl2.jsonl")))
    rc, out, err = _done(wedged, timeout=60)
    assert rc == WATCHDOG_ABORT_EXIT_CODE == 85, (rc, err[-2000:])
    st = TMgr(prefix).load(ctx=tmx.cpu())
    assert st["batch_cursor"] == 5
    assert st["extra"]["emergency"] == "watchdog_abort"
    assert JMgr(prefix).verify(st["version"])
    assert find_flight_dumps(runlog)
    with open(runlog) as f:
        records, problems = j_schema.validate_lines(f)
    assert not problems, problems[:5]
    heals = [r for r in records if r["type"] == "heal"]
    assert {"emergency_ckpt", "watchdog_abort"} <= \
        {h["action"] for h in heals}
    assert any(r["type"] == "run_end" for r in records)
    rc, out, err = _done(observed, timeout=60)
    assert rc == 0 and "survived" in out, (rc, err[-2000:])


# =====================================================================
# THE drill (slow): two CPU gloo processes, rank 1 SIGKILLed mid-step
# =====================================================================
@pytest.mark.slow
def test_sigkill_drill_two_process_supervised_heal(tmp_path):
    worker = os.path.join(_REPO, "tests", "torch_healing_worker.py")
    prefix = str(tmp_path / "mp" / "ck")
    hb_dir = str(tmp_path / "mp" / "hb")
    os.makedirs(os.path.dirname(prefix))
    port, die_at, timeout_sec = _free_port(), 4, 5.0
    sup = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.resilience.healing",
         "--relaunch", "--max-relaunch", "1", "--",
         sys.executable, worker, "run", f"127.0.0.1:{port}", "0", "2",
         prefix, hb_dir],
        env=_env(MXNET_PEER_TIMEOUT_SEC=timeout_sec),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    victim = subprocess.Popen(
        [sys.executable, worker, "run", f"127.0.0.1:{port}", "1", "2",
         prefix, hb_dir],
        env=_env(MXNET_PEER_TIMEOUT_SEC=timeout_sec,
                 HEAL_DIE_AT_STEP=die_at),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    v_out, _ = victim.communicate(timeout=300)
    assert victim.returncode == -signal.SIGKILL, (victim.returncode,
                                                  v_out[-2000:])
    s_out, _ = sup.communicate(timeout=300)
    assert sup.returncode == 0, (sup.returncode, s_out[-3000:])
    payload = json.loads([ln for ln in s_out.splitlines()
                          if ln.strip().startswith("{")][-1])
    assert payload["verdict"] == {"reshard": True, "old_world": 2,
                                  "new_world": 1}
    assert payload["survivors"] == [0] and payload["coordinator"] == 0
    assert payload["resumed_cursor"] > payload["sync_cursor"]
    assert die_at - 1 <= payload["resumed_cursor"] <= die_at
    m = [ln for ln in s_out.splitlines() if "peer death detected in" in ln]
    assert m, s_out[-2000:]
    detect_s = float(m[0].split("detected in ")[1].split("s")[0])
    assert detect_s < timeout_sec, detect_s
    with open(f"{prefix}.runlog.r0.a0.jsonl") as f:
        rec0, problems0 = j_schema.validate_lines(f)
    assert not problems0, problems0[:5]
    assert {"peer_death", "survivor_detected", "heal_exit"} <= \
        {r["action"] for r in rec0 if r["type"] == "heal"}
    end0 = [r for r in rec0 if r["type"] == "run_end"][-1]
    assert end0["counters"]["peer_deaths"] == 1
    assert end0["counters"]["ckpt_async_writes"] >= 1
    with open(f"{prefix}.runlog.r0.a1.jsonl") as f:
        rec1, problems1 = j_schema.validate_lines(f)
    assert not problems1, problems1[:5]
    assert "resume" in {r["action"] for r in rec1 if r["type"] == "heal"}
    assert [r for r in rec1 if r["type"] == "run_end"][-1][
        "counters"]["auto_reshards"] == 1
    from mxnet_tpu_torch.tools import ckpt_fsck

    report = ckpt_fsck.fsck(os.path.dirname(prefix), check_all=True)
    assert report["clean"], report["problems"]
    ref_env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=_REPO)
    ref_env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tests", "healing_worker.py"),
         "reference"], env=ref_env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    for k in ref["final"]:
        onp.testing.assert_allclose(onp.asarray(payload["final"][k]),
                                    onp.asarray(ref["final"][k]),
                                    rtol=1e-5, atol=1e-7, err_msg=k)
