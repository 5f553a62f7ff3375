"""Worker of the port's elastic drills (``tests/test_torch_elastic.py``,
``tests/test_torch_healing.py``).

The model and data are the reference drills' (``tests/elastic_worker.py``,
``tests/healing_worker.py``): a linear model on 6 inputs and 4 outputs,
SGD with momentum 0.9 at learning rate 0.1 on the mean squared error
over a global batch of 8, global batch ``t`` drawn from
``RandomState(100 + t)``.  Every step is a pure function of the step
index, so every world size consumes the same global stream: each
process takes its rows of the global batch, the gradients sum over the
processes with one gloo all-reduce (replicated parameters, the port's
data parallelism), and a world of 1 computes the same update.

Modes (argv[1]):

* ``init <coordinator> <pid> <nprocs>`` — ``elastic_init`` under the
  inherited ``MXNET_FAULT_SPEC`` (a ``dist.init`` raise is retried),
  one barrier, then prints ``[pid] up`` with the retries it took.
* ``guard <coordinator> <pid> <nprocs> <hb_dir>`` — rank 1 SIGKILLs
  itself after the first all-reduce; rank 0 runs the second under
  ``healing.guard_collective`` and prints how the death surfaced.
* ``train <coordinator> <pid> <nprocs> <prefix>`` — every rank SIGTERMs
  itself during step ``DRAIN_AT - 1``: the ``PreemptionDrain`` finishes
  the step, rank 0 writes the topology-stamped checkpoint at cursor
  ``DRAIN_AT``, both re-raise (rc -15).
* ``resume <prefix>`` — world size 1: the verdict, the cursor, the
  remaining steps; prints the final parameters as JSON.
* ``reference [steps]`` — one process, every step uninterrupted; prints
  the final parameters as JSON.
* ``zero_train``, ``zero_resume``, ``zero_reference`` — the same drill
  through ``parallel.make_train_step``'s sharded arm (ZeRO stage 2: the
  linear model as a ``Dense(4, in_units=6)``, each process holding its
  shard of the momentum bucket): the drained ranks gather the
  parameters and the momentum shards jointly (``host_gather``) and rank
  0 writes them per parameter with the topology; the world-1 resume
  re-plans the buckets and re-slices the momentum
  (``zero.shard_bucket_state``).
"""
import json
import os
import pickle
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as onp  # noqa: E402
import torch  # noqa: E402

TOTAL_STEPS = 6
DRAIN_AT = 3
GLOBAL_BATCH = 8
DIM_IN, DIM_OUT = 6, 4


def init_params():
    rng = onp.random.RandomState(3)
    return {"w": (rng.randn(DIM_IN, DIM_OUT) * 0.1).astype("float32"),
            "b": onp.zeros((DIM_OUT,), "float32")}


def zero_momentum():
    return {"w": onp.zeros((DIM_IN, DIM_OUT), "float32"),
            "b": onp.zeros((DIM_OUT,), "float32")}


def global_batch(t):
    rng = onp.random.RandomState(100 + t)
    x = rng.randn(GLOBAL_BATCH, DIM_IN).astype("float32")
    y = rng.randn(GLOBAL_BATCH, DIM_OUT).astype("float32")
    return x, y


def world():
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def step(params, mom, t):
    """One data-parallel step: this process's rows of global batch
    ``t``, the gradient of the batch-mean loss summed over the processes
    by one all-reduce, then the momentum update.  Returns (loss, params,
    momentum) as new host arrays."""
    import torch.distributed as dist

    rank, n = world()
    x, y = global_batch(t)
    b = GLOBAL_BATCH // n
    x = torch.from_numpy(x[rank * b:(rank + 1) * b])
    y = torch.from_numpy(y[rank * b:(rank + 1) * b])
    w, bias = torch.from_numpy(params["w"]), torch.from_numpy(params["b"])
    r = x @ w + bias - y
    flat = torch.cat([(2.0 / GLOBAL_BATCH * (x.T @ r)).reshape(-1),
                      2.0 / GLOBAL_BATCH * r.sum(0),
                      (r * r).sum().reshape(1) / GLOBAL_BATCH])
    if n > 1:
        dist.all_reduce(flat)
    gw = flat[:DIM_IN * DIM_OUT].reshape(DIM_IN, DIM_OUT)
    gb = flat[DIM_IN * DIM_OUT:-1]
    new_m = {"w": 0.9 * torch.from_numpy(mom["w"]) + gw,
             "b": 0.9 * torch.from_numpy(mom["b"]) + gb}
    new_p = {"w": w - 0.1 * new_m["w"], "b": bias - 0.1 * new_m["b"]}
    return (float(flat[-1]), {k: v.numpy() for k, v in new_p.items()},
            {k: v.numpy() for k, v in new_m.items()})


def _cpu():
    import mxnet_tpu_torch as mx

    return mx.cpu()


def nd_tree(tree):
    import mxnet_tpu_torch as mx

    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in tree.items()}


def topo():
    from mxnet_tpu_torch.resilience.elastic import topology_block

    return topology_block(world_size=world()[1], sharding="none",
                          global_batch=GLOBAL_BATCH)


def run_steps(params, mom, start, stop):
    for t in range(start, stop):
        loss, params, mom = step(params, mom, t)
        print(f"step {t} loss={loss:.6f}", flush=True)
    return params, mom


def final_json(params, **extra):
    return json.dumps({"final": {k: onp.asarray(v).tolist()
                                 for k, v in params.items()}, **extra})


def _init(coordinator, pid, nprocs):
    from mxnet_tpu_torch.resilience import elastic, faultsim

    ctx = elastic.elastic_init(coordinator=coordinator,
                               num_processes=nprocs, process_id=pid)
    print(f"[{pid}] up: procs={ctx.num_processes} backend={ctx.backend} "
          f"dist.init hits={faultsim.hits('dist.init')} "
          f"dist.collective hits={faultsim.hits('dist.collective')}",
          flush=True)
    os._exit(0)  # no group teardown: the peer may already be gone


def _guard(coordinator, pid, nprocs, hb_dir):
    import torch.distributed as dist

    from mxnet_tpu_torch.resilience import elastic, healing

    elastic.elastic_init(coordinator=coordinator, num_processes=nprocs,
                         process_id=pid)
    det = healing.arm(hb_dir, pid, nprocs, timeout=2.0)
    t = torch.ones(4)
    dist.all_reduce(t)
    if pid == 1:
        # beat past the peer's detector start first: an unchanged beat
        # older than the detector is a leftover, which gets the startup
        # grace instead of the pid probe
        time.sleep(1.2)
        os.kill(os.getpid(), signal.SIGKILL)
    while healing._read_beat(hb_dir, 1)[0] is not None and \
            healing._pid_alive(healing._read_beat(hb_dir, 1)[0]["pid"]):
        time.sleep(0.01)  # the peer's death comes before the call
    t0 = time.monotonic()
    try:
        # a poll longer than gloo takes to fail: the death surfaces as
        # gloo's error, which the detector then confirms
        healing.guard_collective(lambda: dist.all_reduce(t), det,
                                 poll=5.0, label="drill")
        print("[0] no error", flush=True)
    except healing.PeerDeadError as e:
        how = "translated" if e.__cause__ is not None else "abandoned"
        print(f"[0] PeerDeadError {how} {e.dead} in "
              f"{time.monotonic() - t0:.3f}s: "
              f"{type(e.__cause__).__name__}", flush=True)
    os._exit(0)


def _train(coordinator, pid, nprocs, prefix):
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager
    from mxnet_tpu_torch.resilience.preempt import PreemptionDrain

    elastic.elastic_init(coordinator=coordinator, num_processes=nprocs,
                         process_id=pid)
    params, mom = init_params(), zero_momentum()
    drain = PreemptionDrain()
    with drain:
        for t in range(TOTAL_STEPS):
            if t + 1 == DRAIN_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            loss, params, mom = step(params, mom, t)
            print(f"[{pid}] step {t} loss={loss:.6f}", flush=True)
            if drain.requested is not None:
                print(f"[{pid}] draining", flush=True)
                if pid == 0:
                    CheckpointManager(prefix).save(
                        1, arg_params=nd_tree(params),
                        optimizer_states=pickle.dumps(mom),
                        batch_cursor=t + 1, topology=topo())
                    print(f"[0] drain checkpoint at cursor {t + 1}",
                          flush=True)
                break
    drain.reraise()
    raise SystemExit("the drain never came")


def _resume(prefix):
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    elastic.elastic_init()
    st = CheckpointManager(prefix).load(ctx=_cpu())
    verdict = elastic.reshard_verdict(st["topology"], topo())
    cursor = elastic.reslice_cursor(st["batch_cursor"], st["topology"],
                                    topo())
    params = {k: v.asnumpy() for k, v in st["arg_params"].items()}
    params, _ = run_steps(params, pickle.loads(st["optimizer_states"]),
                          cursor, TOTAL_STEPS)
    print(final_json(params, resumed_cursor=cursor, verdict={
        k: verdict[k] for k in ("reshard", "old_world", "new_world")}),
        flush=True)


def _zero_step(mesh, params=None):
    """(step_fn, params, opt_state) of the linear model in the sharded
    arm over ``mesh``; ``params``: its weights (default the drill's)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel

    params = init_params() if params is None else params
    with mx.cpu():
        net = gluon.nn.Dense(DIM_OUT, in_units=DIM_IN, prefix="lin_")
        net.initialize()
        parallel.load_jax_params(net, {"lin_weight": params["w"].T,
                                       "lin_bias": params["b"]})
        return parallel.make_train_step(
            net, lambda out, y: ((out - y) ** 2).sum(-1), "sgd",
            learning_rate=0.1, momentum=0.9, mesh=mesh, donate=False,
            autotune=False, optimizer_sharding="ps")


def _zero_steps(step_fn, p, s, start, stop, drain=None, pid=0):
    rank, n = world()
    b = GLOBAL_BATCH // n
    done = start
    for t in range(start, stop):
        if drain is not None and t + 1 == DRAIN_AT:
            os.kill(os.getpid(), signal.SIGTERM)
        x, y = (torch.from_numpy(a[rank * b:(rank + 1) * b])
                for a in global_batch(t))
        loss, p, s = step_fn(p, s, x, y, 0, float(t + 1))
        done = t + 1
        print(f"[{pid}] step {t} loss={float(loss):.6f}", flush=True)
        if drain is not None and drain.requested is not None:
            break
    return p, s, done


def _zero_final(p):
    from mxnet_tpu_torch.resilience.elastic import host_gather

    return {"w": host_gather(p["lin_weight"]).T,
            "b": host_gather(p["lin_bias"])}


def _zero_train(coordinator, pid, nprocs, prefix):
    from mxnet_tpu_torch.parallel import zero
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager
    from mxnet_tpu_torch.resilience.preempt import PreemptionDrain

    elastic.elastic_init(coordinator=coordinator, num_processes=nprocs,
                         process_id=pid)
    mesh = elastic.elastic_mesh(devices=["cpu"])
    step_fn, p, s = _zero_step(mesh)
    plan = step_fn.zero_plan
    drain = PreemptionDrain()
    with drain:
        p, s, cursor = _zero_steps(step_fn, p, s, 0, TOTAL_STEPS, drain, pid)
    # the joint gather: every rank, at the same step
    params = {n: elastic.host_gather(v) for n, v in p.items()}
    mom = {n: tuple(x.numpy() for x in leaves) for n, leaves in
           zero.named_bucket_state(plan, s, elastic.host_gather).items()}
    print(f"[{pid}] draining", flush=True)
    if pid == 0:
        CheckpointManager(prefix).save(
            1, arg_params=nd_tree(params), optimizer_states=pickle.dumps(mom),
            batch_cursor=cursor, topology=elastic.topology_block(
                mesh=mesh, sharding="ps", plan=plan,
                global_batch=GLOBAL_BATCH))
        print(f"[0] drain checkpoint at cursor {cursor}", flush=True)
    drain.reraise()
    raise SystemExit("the drain never came")


def _zero_resume(prefix):
    from mxnet_tpu_torch.parallel import zero
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    elastic.elastic_init()
    st = CheckpointManager(prefix).load(ctx=_cpu())
    mesh = elastic.elastic_mesh(devices=["cpu"])
    arg = {k: v.asnumpy() for k, v in st["arg_params"].items()}
    step_fn, p, s = _zero_step(mesh, {"w": arg["lin_weight"].T,
                                      "b": arg["lin_bias"]})
    new = elastic.topology_block(mesh=mesh, sharding="ps",
                                 plan=step_fn.zero_plan,
                                 global_batch=GLOBAL_BATCH)
    verdict = elastic.reshard_verdict(st["topology"], new)
    cursor = elastic.reslice_cursor(st["batch_cursor"], st["topology"], new)
    if verdict["reshard"]:
        # re-plan at this world and re-slice the momentum into it
        s.update(zero.shard_bucket_state(
            step_fn.zero_plan, pickle.loads(st["optimizer_states"]), mesh))
    p, s, _ = _zero_steps(step_fn, p, s, cursor, TOTAL_STEPS)
    print(final_json(_zero_final(p), resumed_cursor=cursor, verdict={
        k: verdict[k] for k in ("reshard", "old_world", "new_world")}),
        flush=True)


def main():
    mode = sys.argv[1]
    if mode == "init":
        _init(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif mode == "guard":
        _guard(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])
    elif mode == "train":
        _train(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])
    elif mode == "resume":
        _resume(sys.argv[2])
    elif mode == "zero_train":
        _zero_train(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5])
    elif mode == "zero_resume":
        _zero_resume(sys.argv[2])
    elif mode == "zero_reference":
        from mxnet_tpu_torch.parallel import get_mesh

        step_fn, p, s = _zero_step(get_mesh(devices=["cpu"]))
        p, _, _ = _zero_steps(step_fn, p, s, 0, TOTAL_STEPS)
        print(final_json(_zero_final(p)), flush=True)
    elif mode == "reference":
        steps = int(sys.argv[2]) if len(sys.argv) > 2 else TOTAL_STEPS
        params, _ = run_steps(init_params(), zero_momentum(), 0, steps)
        print(final_json(params), flush=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
