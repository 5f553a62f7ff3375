"""Worker of ``tests/test_torch_dist_module.py``: the Module over a
process mesh, run under the port's launcher on a CPU gloo group::

    python -m mxnet_tpu_torch.tools.launch -n N --cpu \\
        python tests/torch_dist_module_worker.py MODE IN.npz OUT [PREFIX...]

Every rank builds ``Module(context=[cpu(0)..cpu(N-1)])`` over the same
global batches (the reference's multi-context contract) and writes what
it computed to ``OUT.r<rank>.npz``, keyed ``<case>/<what>``.  It imports
only torch, numpy and the port.

Modes:

- ``main``: the cases below, then the drill: ``drill_u``, the
  uninterrupted Adam fit of the reference's resize drill (3 epochs, the
  16->4 MLP on 64 rows, batch 8, ``kvstore="dist_sync"``), written to
  ``OUT.drill.r<rank>.npz``; then the same fit checkpointing to
  ``PREFIX``, every rank SIGTERMing itself after epoch 1 batch 2: the
  drain gathers the sharded state, rank 0 writes, both re-raise (the
  process ends by the signal).
- ``resume``: for each ``PREFIX``, the drill's fit resumed from its
  drain checkpoint at this world; the verdict and the final parameters.

Cases of ``main``:

- ``mc`` / ``mc1``: ``tests/test_symbol_module.py``'s multi-context
  data parallelism (256 rows, batch 32, SGD 0.2/0.9, 3 epochs from the
  seeded ``mc/init``) over the mesh and on one context; the score and
  the parameters; ``mc/out``: the gathered outputs of one batch, and
  ``mc1/out`` one process's.
- ``fit_<kv>_<case>``: ``tests/test_zero_sharding.py``'s ``_fit_module``
  (64 rows, batch 8, 2 epochs from ``fit/init``) for ``kv`` in
  ``dist_sync`` and ``local``: ``sgd`` (lr 0.1, momentum 0.9), ``wd``
  (wd 1e-2), ``adam`` (``begin_num_update`` 5), ``lrwd`` (lr 0.01 and wd
  1e-2 from epoch 2 of 4), ``mom`` (momentum 0 and clip 0.05 from epoch
  2 of 4), ``kernel`` (dist_sync only: the bucket kernels forced, their
  plain versions on the CPU); the parameters, the updater kind, its
  clock and bucket groups.
- ``states``: the sharded updater's ``.states`` round trips, refusals,
  the state-lost error and the eager counters of a dump.
- ``env``: ``MXNET_OPTIMIZER_SHARDING=0`` and the nadam fallback.
- ``exch``: one more step of ``fit_dist_sync_sgd`` with the exchange
  counted; the default ``rescale_grad``.
- ``norm_<head>``: one forward/backward of a 10->4 FullyConnected under
  ``SoftmaxOutput`` with ``normalization`` ``batch`` or ``valid``, or
  ``LinearRegressionOutput``, on the 16 rows of ``norm/X``; the summed
  gradients.  ``add``: ``grad_req="add"`` over two backwards.
  ``ingrad``: the gathered input gradients.
- ``bn``: a conv-BatchNorm-FC net on ``bn/X`` (8 rows, NCHW), 2 SGD
  steps from ``bn/init`` with ``dist_sync``; parameters and moving
  statistics.
- ``fault``: ``faultsim``'s ``dist.collective`` on the second
  ``update_all`` of a ``ShardedBucketUpdater``: the states gather
  whole after it, and the next update runs.
- ``divide``: a global batch of 5 rows over 2 processes raises, and so
  does ``group2ctxs`` with several contexts.
- ``bucketing``: a ``BucketingModule`` over the mesh, two buckets
  sharing the MLP's parameters, ``dist_sync``.
"""
import os
import pickle
import signal
import sys

import numpy as onp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autotune as at  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import zero  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim  # noqa: E402


def mlp(sym, head="softmax", **kw):
    d = sym.Variable("data")
    fc1 = sym.FullyConnected(d, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax", **kw)


def arrays(data, pre):
    return {k[len(pre):]: mx.nd.array(v) for k, v in data.items()
            if k.startswith(pre)}


def host(params):
    return {n: v.asnumpy() for n, v in params.items()}


def contexts(world):
    return [mx.cpu(i) for i in range(world)]


def mc_case(data, world, multi):
    it = mx.io.NDArrayIter(data["mc/X"], data["mc/y"], batch_size=32,
                           shuffle=False)
    mod = mx.mod.Module(mlp(mx.sym),
                        context=contexts(world) if multi else mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    mod.set_params(arrays(data, "mc/init/"), {})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.2),
                                         ("momentum", 0.9)))
    for _ in range(3):
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
    score = mod.score(it, mx.metric.Accuracy())[0][1]
    it.reset()
    mod.forward(next(iter(it)), is_train=False)
    out = {"score": onp.float64(score),
           "out": mod.get_outputs()[0].asnumpy()}
    out |= {f"p/{n}": v for n, v in host(mod.get_params()[0]).items()}
    return out


def fit_module(data, world, kvstore, optimizer="sgd", epochs=2,
               extra=(), mutate=None):
    it = mx.io.NDArrayIter(data["fit/X"], data["fit/y"], batch_size=8,
                           shuffle=False)
    mod = mx.mod.Module(mlp(mx.sym), context=contexts(world))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    mod.set_params(arrays(data, "fit/init/"), {})
    opt_params = [("learning_rate", 0.1)]
    if optimizer in ("sgd", "lars"):
        opt_params.append(("momentum", 0.9))
    opt_params.extend(extra)
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                       optimizer_params=tuple(opt_params))
    for epoch in range(epochs):
        if mutate is not None:
            mutate(mod, epoch)
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
    return mod, host(mod.get_params()[0])


def record(mod, params):
    upd = mod._updater
    sharded = isinstance(upd, zero.ShardedBucketUpdater)
    out = {f"p/{n}": v for n, v in params.items()}
    out["sharded"] = onp.bool_(sharded)
    out["num_update"] = onp.int64(mod._optimizer.num_update)
    out["t"] = onp.int64(upd._t if sharded else -1)
    out["groups"] = onp.int64(len({b.group for b in upd.plan})
                              if sharded else 0)
    out["pallas"] = onp.int64(-1 if not sharded else int(bool(upd._pallas)))
    return out


def lrwd(mod, epoch):
    if epoch == 2:
        mod._optimizer.set_learning_rate(0.01)
        mod._optimizer.wd = 1e-2


def momentum_off(mod, epoch):
    if epoch == 2:
        mod._optimizer.momentum = 0.0
        mod._optimizer.clip_gradient = 0.05


FIT_CASES = {"sgd": ("sgd", 2, (), None),
             "wd": ("sgd", 2, (("wd", 1e-2),), None),
             "adam": ("adam", 2, (("begin_num_update", 5),), None),
             "lrwd": ("sgd", 4, (), lrwd),
             "mom": ("sgd", 4, (), momentum_off)}


def states_case(data, world):
    """The sharded updater's checkpoint contract (reference
    ``tests/test_zero_sharding.py:373-600``); each check a flag."""
    from mxnet_tpu_torch import optimizer as opt_mod

    out = {}
    mod_s, _ = fit_module(data, world, "dist_sync")
    mod_l, _ = fit_module(data, world, "local")
    blob = mod_s._get_optimizer_states()
    legacy, opt_copy = pickle.loads(blob)
    out["dump_num_update"] = onp.int64(opt_copy.num_update)
    out["legacy_keys"] = onp.array(sorted(legacy))
    mod_l._set_optimizer_states(blob)
    mod_s._set_optimizer_states(mod_l._get_optimizer_states())
    back, _ = pickle.loads(mod_s._get_optimizer_states())
    out["roundtrip_bitwise"] = onp.bool_(all(
        onp.array_equal(x.asnumpy(), y.asnumpy())
        for k in legacy for x, y in zip(legacy[k], back[k])))
    # the resumed optimizer is the live one, and a change reaches it
    for kv, mod in (("dist_sync", mod_s), ("local", mod_l)):
        pre = mod._optimizer
        mod._set_optimizer_states(mod._get_optimizer_states())
        mod._optimizer.lr = 0.123
        if kv == "dist_sync":
            mod._updater._sync_hyper_params()
            live = all(abs(b.group[0] - 0.123) < 1e-9
                       for b in mod._updater.plan)
        else:
            live = abs(mod._updater.optimizer._get_lr("fc1_weight")
                       - 0.123) < 1e-9
        out[f"repoint_{kv}"] = onp.bool_(
            mod._optimizer is mod._updater.optimizer
            and mod._optimizer is not pre and live)
    # Adam's clock through a states round trip and a stale "__step"
    mod_a, _ = fit_module(data, world, "dist_sync", "adam")
    upd = mod_a._updater
    t0 = upd._t
    plain = upd.get_states()
    upd._t = 0
    upd.set_states(plain)
    out["step_restored"] = onp.bool_(upd._t == t0 == 16)
    states, oc = pickle.loads(upd.get_states(dump_optimizer=True))
    oc.num_update = upd._t + 8
    upd.set_states(pickle.dumps((states, oc)))
    out["stale_step_t"] = onp.int64(upd._t)
    eager = opt_mod.get_updater(opt_mod.create("adam"))
    eager.set_states(upd.get_states(dump_optimizer=True))
    w, g = mx.nd.ones((16,)), mx.nd.ones((16,))
    eager("fc1_bias", g, w)
    out["eager_seeded"] = onp.bool_(
        eager.optimizer.begin_num_update == upd._t and
        eager.optimizer._index_update_count["fc1_bias"] == upd._t + 1)
    # refusals: multi_precision, a layout mismatch (nadam)
    upd = mod_s._updater
    blob = upd.get_states(dump_optimizer=True)
    states, oc = pickle.loads(blob)
    oc.multi_precision = True
    refused = []
    for bad, match in ((pickle.dumps((states, oc)), "multi_precision"),
                       (pickle.dumps((states, opt_mod.create("nadam"))),
                        "layouts differ")):
        try:
            upd.set_states(bad)
            refused.append(False)
        except MXNetError as e:
            refused.append(match in str(e))
    out["refused"] = onp.array(refused + [
        upd.optimizer is not oc and not upd.optimizer.multi_precision])
    upd.set_states(blob)
    # the state-lost error, then the restore
    upd._states = None
    lost = []
    for fn in (upd.get_states, lambda: upd.update_all([])):
        try:
            fn()
            lost.append(False)
        except MXNetError as e:
            lost.append("last checkpoint" in str(e))
    upd.set_states(blob)
    out["state_lost"] = onp.array(lost + [upd._states is not None])
    return out


def env_case(data, world):
    os.environ["MXNET_OPTIMIZER_SHARDING"] = "0"
    try:
        mod, _ = fit_module(data, world, "dist_sync", epochs=1)
    finally:
        del os.environ["MXNET_OPTIMIZER_SHARDING"]
    nadam, _ = fit_module(data, world, "dist_sync", "nadam", epochs=1)
    os.environ["MXNET_OPTIMIZER_SHARDING"] = "ps"
    try:
        forced, _ = fit_module(data, world, "local", epochs=1)
    finally:
        del os.environ["MXNET_OPTIMIZER_SHARDING"]
    return {"sharded": onp.array([
        isinstance(m._updater, zero.ShardedBucketUpdater)
        for m in (mod, nadam, forced)])}


def exch_case(data, world):
    mod, _ = fit_module(data, world, "dist_sync")
    it = mx.io.NDArrayIter(data["fit/X"], data["fit/y"], batch_size=8,
                           shuffle=False)
    mod.exchange.reset()
    mod.forward(next(iter(it)), is_train=True)
    mod.backward()
    mod.update()
    c = mod.exchange.counts()
    out = {f"{k}/{w}": onp.int64(c[k][w]) for k in ("all-reduce",
                                                      "all-gather")
           for w in ("launches", "bytes")}
    out["grad_buckets"] = onp.int64(len(mod._grad_plan))
    out["upd_buckets"] = onp.int64(len(mod._updater.plan))
    out["upd_padded"] = onp.int64(sum(b.padded for b in mod._updater.plan))
    out["grad_size"] = onp.int64(sum(b.size for b in mod._grad_plan))
    out["rescale_grad"] = onp.float64(mod._optimizer.rescale_grad)
    # the updater's part of the checkpoint stamp is the Module's
    topo, block = mod._updater.topology(), mod._topology_block()
    out["topology_agrees"] = onp.bool_(
        all(topo[k] == block[k] for k in topo)
        and block["sharding"] == "ps" and block["global_batch"] == 8)
    return out


def head_symbol(head):
    s = mx.sym
    fc = s.FullyConnected(s.Variable("data"), num_hidden=4, name="fc")
    if head == "linear":
        return s.LinearRegressionOutput(fc, s.Variable("softmax_label"),
                                        name="lin")
    return s.SoftmaxOutput(fc, s.Variable("softmax_label"),
                           normalization=head, name="softmax")


def grads_case(data, world, head, grad_req="write", backwards=1,
               inputs_need_grad=False):
    mod = mx.mod.Module(head_symbol(head), context=contexts(world))
    y = data["norm/y"] if head != "linear" else data["norm/ylin"]
    mod.bind(data_shapes=[("data", data["norm/X"].shape)],
             label_shapes=[("softmax_label", y.shape)],
             inputs_need_grad=inputs_need_grad, grad_req=grad_req)
    mod.init_params(initializer=None, arg_params=arrays(data, "norm/init/"),
                    aux_params={})
    batch = mx.io.DataBatch([mx.nd.array(data["norm/X"])],
                            [mx.nd.array(y)])
    for _ in range(backwards):
        mod.forward(batch, is_train=True)
        mod.backward()
    out = {f"g/{n}": mod._exec.grad_dict[n].asnumpy()
           for n in ("fc_weight", "fc_bias")}
    if inputs_need_grad:
        out["dx"] = mod.get_input_grads()[0].asnumpy()
    return out


def bn_symbol():
    s = mx.sym
    x = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                      pad=(1, 1), name="conv")
    x = s.BatchNorm(x, fix_gamma=False, name="bn")
    x = s.Activation(x, act_type="relu", name="relu")
    x = s.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg",
                  name="pool")
    x = s.FullyConnected(x, num_hidden=3, name="fc")
    return s.SoftmaxOutput(x, s.Variable("softmax_label"), name="softmax")


def bn_case(data, world):
    mod = mx.mod.Module(bn_symbol(), context=contexts(world))
    mod.bind(data_shapes=[("data", data["bn/X"].shape)],
             label_shapes=[("softmax_label", data["bn/y"].shape)])
    mod.init_params(initializer=None, arg_params=arrays(data, "bn/init/"),
                    aux_params=arrays(data, "bn/aux/"))
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),
                                         ("momentum", 0.9)))
    batch = mx.io.DataBatch([mx.nd.array(data["bn/X"])],
                            [mx.nd.array(data["bn/y"])])
    mod.exchange.reset()
    for _ in range(2):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    arg, aux = mod.get_params()
    out = {f"p/{n}": v for n, v in host(arg).items()}
    out |= {f"aux/{n}": v for n, v in host(aux).items()}
    out["bn_launches"] = onp.int64(
        mod.exchange.counts()["roles"].get("bn", {}).get("launches", 0))
    return out


def fault_case():
    from mxnet_tpu_torch.parallel import get_mesh

    mesh = get_mesh()
    opt = mx.optimizer.create("sgd", learning_rate=0.1, rescale_grad=1.0)
    params = {"w": torch.ones((16, 4)), "b": torch.zeros((4,))}
    upd = zero.ShardedBucketUpdater(opt, mesh, params)
    weights = {n: mx.nd.NDArray(v.clone()) for n, v in params.items()}
    grads = {n: mx.nd.NDArray(torch.full(v.shape, 0.5))
             for n, v in params.items()}
    trip = [(n, grads[n], weights[n]) for n in params]
    faultsim.reset("dist.collective:raise@2")
    upd.update_all(trip)
    raised = False
    try:
        upd.update_all(trip)
    except faultsim.FaultInjected:
        raised = True
    keys = sorted(pickle.loads(upd.get_states()))
    faultsim.reset("")
    upd.update_all(trip)
    return {"raised": onp.bool_(raised), "keys": onp.array(keys),
            "t": onp.int64(upd._t), "w": weights["w"].asnumpy()}


def divide_case(world):
    """A global batch the mesh does not divide raises at forward."""
    mod = mx.mod.Module(mlp(mx.sym), context=contexts(world))
    mod.bind(data_shapes=[("data", (5, 10))],
             label_shapes=[("softmax_label", (5,))])
    mod.init_params(initializer=mx.init.Xavier())
    try:
        mod.forward(mx.io.DataBatch([mx.nd.zeros((5, 10))],
                                    [mx.nd.zeros((5,))]), is_train=False)
        raised = False
    except MXNetError as e:
        raised = "divide" in str(e)
    try:
        mx.mod.Module(mlp(mx.sym), context=contexts(world),
                      group2ctxs={"dev1": mx.cpu()})
        g2c = False
    except MXNetError as e:
        g2c = "cannot combine" in str(e)
    return {"raised": onp.bool_(raised), "group2ctxs": onp.bool_(g2c)}


def bucketing_case(data, world):
    def sym_gen(key):
        return mlp(mx.sym), ("data",), ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=contexts(world))
    X, y = data["fit/X"], data["fit/y"]
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(initializer=None, arg_params=arrays(data, "fit/init/"),
                    aux_params={})
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),
                                         ("momentum", 0.9)))
    for i in range(4):
        rows = 8 if i % 2 == 0 else 16
        sl = slice(i * 8, i * 8 + rows)
        mod.forward(mx.io.DataBatch(
            [mx.nd.array(X[sl])], [mx.nd.array(y[sl])], bucket_key=rows,
            provide_data=[("data", (rows, 10))],
            provide_label=[("softmax_label", (rows,))]), is_train=True)
        mod.backward()
        mod.update()
    shared = all(mod._buckets[16]._exec.arg_dict[n] is
                 mod._buckets[8]._exec.arg_dict[n]
                 for n in ("fc1_weight", "fc2_bias"))
    out = {f"p/{n}": v for n, v in host(mod.get_params()[0]).items()}
    out["shared"] = onp.bool_(shared)
    out["sharded"] = onp.bool_(isinstance(mod._buckets[16]._updater,
                                          zero.ShardedBucketUpdater))
    return out


def drill_fit(data, world, num_epoch, checkpoint=None, resume_from=None,
              killer=None):
    mx.random.seed(11)
    onp.random.seed(11)
    it = mx.io.NDArrayIter(data["fit/X"], data["fit/y"], batch_size=8,
                           shuffle=False)
    mod = mx.mod.Module(mlp(mx.sym), context=contexts(world))
    mod.fit(it, num_epoch=num_epoch, kvstore="dist_sync", optimizer="adam",
            optimizer_params=(("learning_rate", 0.05),),
            initializer=mx.init.Xavier(), checkpoint=checkpoint,
            resume_from=resume_from, batch_end_callback=killer)
    return mod


def main_mode(data, out, prefix):
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}

    def put(case, d):
        res.update({f"{case}/{k}": v for k, v in d.items()})

    put("mc", mc_case(data, world, True))
    put("mc1", mc_case(data, world, False))
    if world == 2:
        for name, (optn, epochs, extra, mutate) in FIT_CASES.items():
            for kv in ("dist_sync", "local"):
                put(f"fit_{kv}_{name}", record(*fit_module(
                    data, world, kv, optn, epochs, extra, mutate)))
        with at.force(fused_bucket_opt=True):
            put("fit_dist_sync_kernel", record(*fit_module(
                data, world, "dist_sync")))
        put("states", states_case(data, world))
        put("env", env_case(data, world))
        put("exch", exch_case(data, world))
        for head in ("batch", "valid", "linear"):
            put(f"norm_{head}", grads_case(data, world, head))
        put("add", grads_case(data, world, "null", grad_req="add",
                              backwards=2))
        put("ingrad", grads_case(data, world, "null",
                                 inputs_need_grad=True))
        put("fault", fault_case())
        put("divide", divide_case(world))
        put("bucketing", bucketing_case(data, world))
    put("bn", bn_case(data, world))
    onp.savez(f"{out}.r{rank}.npz", **res)
    # the drill: uninterrupted, then drained by SIGTERM
    mod = drill_fit(data, world, 3)
    onp.savez(f"{out}.drill.r{rank}.npz",
              **{f"p/{n}": v for n, v in host(mod.get_params()[0]).items()})

    def killer(param):
        if param.epoch == 1 and param.nbatch == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    dist.barrier()
    drill_fit(data, world, 3, checkpoint=prefix, killer=killer)
    print(f"[{rank}] COMPLETED", flush=True)  # the drain re-raises first


def resume_mode(data, out, prefixes):
    from mxnet_tpu_torch.resilience import elastic
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    rank = dist.get_rank()
    res = {}
    for i, prefix in enumerate(prefixes):
        old = CheckpointManager(prefix).load()["topology"]
        mod = drill_fit(data, dist.get_world_size(), 3, resume_from=prefix)
        v = elastic.reshard_verdict(old, mod._topology_block())
        res[f"r{i}/reshard"] = onp.bool_(v["reshard"])
        res[f"r{i}/old_world"] = onp.int64(v["old_world"])
        res[f"r{i}/sharded"] = onp.bool_(isinstance(
            mod._updater, zero.ShardedBucketUpdater))
        res |= {f"r{i}/p/{n}": a
                for n, a in host(mod.get_params()[0]).items()}
    onp.savez(f"{out}.r{rank}.npz", **res)


def main():
    mode, inp, out = sys.argv[1:4]
    data = dict(onp.load(inp))
    torch.set_num_threads(1)
    mx.kvstore.init_distributed()
    with mx.cpu():
        if mode == "main":
            main_mode(data, out, sys.argv[4])
        else:
            resume_mode(data, out, sys.argv[4:])
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
