"""Worker of the port's SIGKILL drill (``tests/test_torch_healing.py``),
the counterpart of ``tests/healing_worker.py``.

A real two-process CPU gloo job: rank 1 (``HEAL_DIE_AT_STEP=K``)
SIGKILLs itself right before its step-K all-reduce; rank 0 runs every
step under ``healing.guard_collective`` with a heartbeat and a failure
detector, writes a synchronous checkpoint at cursor ``SYNC_AT`` and an
asynchronous snapshot after every step, detects the death (same-host
pid probe), flushes the emergency checkpoint and leaves with rc 83.
Rank 0 runs under the port's supervisor, which relaunches it with
``MXNET_HEAL_ATTEMPT=1``: the relaunch reads the surviving world from
the heartbeat directory, brings up a world of 1, takes the reshard
verdict (2 → 1), resumes from the snapshot and finishes, printing its
final parameters, which ``tests/healing_worker.py reference`` computes
too.  The model and the data are ``tests/torch_elastic_worker.py``'s.

``run <coordinator> <pid> <nprocs> <prefix> <hb_dir>``; the run log of
each attempt is ``{prefix}.runlog.r{pid}.a{attempt}.jsonl``.
"""
import json
import os
import pickle
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_elastic_worker as ew  # noqa: E402

TOTAL_STEPS = 7
SYNC_AT = 2           # the synchronous "epoch-cadence" save cursor


def _survivor_run(coordinator, pid, nprocs, prefix, hb_dir):
    """Attempt 0: both ranks; rank 1 is the victim."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import elastic, healing
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    die_at = int(os.environ.get("HEAL_DIE_AT_STEP", "0"))
    ctx = elastic.elastic_init(coordinator=coordinator,
                               num_processes=nprocs, process_id=pid)
    print(f"[{pid}] elastic up: procs={ctx.num_processes}", flush=True)
    det = healing.arm(hb_dir, pid, nprocs)
    mgr = CheckpointManager(prefix)
    params, mom = ew.init_params(), ew.zero_momentum()
    t0 = time.monotonic()
    try:
        for t in range(TOTAL_STEPS):
            if die_at and t == die_at:
                print(f"[{pid}] SIGKILL self at step {t}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            t0 = time.monotonic()
            loss, params, mom = healing.guard_collective(
                lambda: ew.step(params, mom, t), det, poll=0.05,
                label=f"step{t}")
            healing.poll(step=t)
            print(f"[{pid}] step {t} loss={loss:.6f}", flush=True)
            if pid == 0:
                if t + 1 == SYNC_AT:
                    mgr.save(1, arg_params=ew.nd_tree(params),
                             batch_cursor=SYNC_AT, topology=ew.topo())
                mgr.save_async(arg_params=ew.nd_tree(params),
                               optimizer_states=pickle.dumps(mom),
                               batch_cursor=t + 1, topology=ew.topo())
    except healing.PeerDeadError as e:
        t_death = time.monotonic() - t0
        print(f"[{pid}] peer death detected in {t_death:.2f}s: {e}",
              flush=True)
        telemetry.heal("survivor_detected", detail=str(e),
                       detect_s=round(t_death, 3))
        healing.heal_exit("peer_death")
    raise AssertionError("drill never reached the peer death")


def _healed_resume(prefix, hb_dir, nprocs):
    """Attempt >= 1: the supervisor's relaunch at the surviving world."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.resilience import elastic, healing
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    survivors = healing.surviving_ranks(hb_dir, nprocs, self_rank=0)
    coord_rank, remap = healing.elect_coordinator(survivors)
    print(f"[heal] survivors={survivors} coordinator={coord_rank} "
          f"remap={remap}", flush=True)
    elastic.elastic_init()  # world size 1: local bring-up
    st = CheckpointManager(prefix).load(ctx=ew._cpu())
    assert st["batch_cursor"] > SYNC_AT, st["batch_cursor"]
    # the verdict, the cursor and the reshard's counts and records, as
    # Module.fit's resume takes them
    cursor, verdict = elastic._apply_resume_topology(
        st["topology"], ew.topo(), st["batch_cursor"])
    assert verdict["reshard"], verdict
    params = {k: v.asnumpy() for k, v in st["arg_params"].items()}
    params, _ = ew.run_steps(params, pickle.loads(st["optimizer_states"]),
                             cursor, TOTAL_STEPS)
    telemetry.close()
    print(ew.final_json(
        params, resumed_cursor=int(cursor), sync_cursor=SYNC_AT,
        verdict={k: verdict[k] for k in ("reshard", "old_world",
                                         "new_world")},
        survivors=survivors, coordinator=coord_rank), flush=True)


def main():
    if sys.argv[1] != "run":
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
    coordinator, pid, nprocs, prefix, hb_dir = (
        sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
        sys.argv[6])
    from mxnet_tpu_torch.resilience import healing

    attempt = healing.relaunch_attempt()
    os.environ["MXNET_RUNLOG"] = f"{prefix}.runlog.r{pid}.a{attempt}.jsonl"
    if attempt > 0:
        _healed_resume(prefix, hb_dir, nprocs)
        return
    _survivor_run(coordinator, pid, nprocs, prefix, hb_dir)


if __name__ == "__main__":
    main()
