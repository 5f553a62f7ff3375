"""Worker of ``tests/test_torch_zero.py``: the fused train step across
worker processes, run under the port's launcher on a CPU gloo group::

    python -m mxnet_tpu_torch.tools.launch -n N --cpu \\
        python tests/torch_zero_worker.py IN.npz OUT

``IN.npz`` holds the initial weights (``mlp/<i>`` in the parameter
order of the seeded 8->32->16->4 MLP, ``resnet/<name>`` of the tiny
channel-last ResNetV1) and the global batches; each rank writes what it
computed to ``OUT.r<rank>.npz``, keyed ``<case>/<what>``.  It imports
only torch, numpy and the port.

Cases (world 2 runs all; world 4 the LARS stages):

- ``<opt>_s<stage>``: the MLP, 6 steps at lr 0.1 with ``bucket_bound``
  300 on this rank's rows of X (32 rows), optimizer ``sgd`` at momentum
  0 (``sgd0``) or 0.9 (``sgd9``), ``adam`` or ``lars``, ZeRO stage 1, 2
  or 3; the final loss, the named parameters and the last step's
  counted exchange.  ``larsk_s2`` forces the bucket-kernel arm (its
  plain version on the CPU).
- ``resnet_rep`` / ``resnet_ps``: the tiny ResNet, 3 steps of SGD with
  dynamic loss scaling, replicated (global BatchNorm) and stage 2.
- ``bn``: BatchNorm's global statistics and input gradient on this
  rank's rows of a seeded batch, fp32 and bf16, the layer op and the
  fused BN-ReLU-conv1x1.
- ``guard_<arm>_<how>``: a NaN planted in rank 1's batch at step 1,
  under ``loss_scale="dynamic"`` or ``nan_guard``, replicated or stage 2.
- ``comp``: 2-bit compression at stage 2 (lr 0.05, threshold 0.05),
  4 steps; the gathered residuals.
- ``s3``: stage 3's shard sizes, ``stage3_save_params`` /
  ``stage3_load_params`` and ``DataParallelTrainer.sync_to_block``.
- ``fp8``: the replicated MLP under the pinned fp8 rung, 4 steps; the
  input's and gradients' amax histories.
- ``drop``: one replicated step of an MLP with Dropout, every rank on
  the same rows; the mask each rank drew (key 7).
- ``ops``: the registered ``reduce_scatter`` / ``all_gather``;
  ``lars_plain``: ``LARS.fused_bucket_update(axis_name="data")`` on a
  bucket whose second tensor the shard boundary cuts; ``mesh_desc``.
"""
import json
import os
import sys

import numpy as onp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autotune as at  # noqa: E402
from mxnet_tpu_torch import gluon, kvstore, parallel  # noqa: E402
from mxnet_tpu_torch.ops import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.ops.collective_ops import Exchange  # noqa: E402
from mxnet_tpu_torch.parallel import zero  # noqa: E402
from mxnet_tpu_torch.resilience.elastic import host_gather  # noqa: E402

OPTS = {"sgd0": ("sgd", 0.0), "sgd9": ("sgd", 0.9), "adam": ("adam", 0.9),
        "lars": ("lars", 0.9)}
CHANNELS = [8, 16, 32, 64, 128]
PREFIX = "resnetv10_"


def mlp(data):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu", in_units=8),
            gluon.nn.Dense(16, activation="relu", in_units=32),
            gluon.nn.Dense(4, in_units=16))
    net.initialize()
    with torch.no_grad():
        for i, p in enumerate(net.collect_params().values()):
            p._tensor().copy_(torch.from_numpy(data[f"mlp/{i}"]))
    return net


def rows(a, rank, world):
    n = a.shape[0] // world
    return torch.from_numpy(a[rank * n:(rank + 1) * n].copy())


def named(step, p):
    """Host copies of the named parameters in any stage's layout, keyed
    by their place in the parameter order."""
    if getattr(step, "zero_stage", None) == 3:
        p = zero.gather_stage3_params(
            step.zero_plan, {k: host_gather(v) for k, v in p.items()})
    return {str(i): host_gather(v) for i, v in enumerate(p.values())}


def counted(step):
    return {f"bytes/{k}": onp.int64(step.exchange[k]["bytes"])
            for k in zero.analytic_exchange_bytes([], 1, 2)} | {
        f"launches/{k}": onp.int64(step.exchange[k]["launches"])
        for k in zero.analytic_exchange_bytes([], 1, 2)}


def mlp_case(data, rank, world, opt, stage, kernel=False):
    name, momentum = OPTS[opt]
    mesh = parallel.get_mesh()
    with at.force(fused_bucket_opt="pallas" if kernel else "jnp"):
        step, p, s = parallel.make_train_step(
            mlp(data), gluon.loss.SoftmaxCrossEntropyLoss(),
            optimizer=name, learning_rate=0.1, momentum=momentum,
            mesh=mesh, donate=False, autotune=False, bucket_bound=300,
            optimizer_sharding="ps", zero_stage=stage)
        x, y = rows(data["X"], rank, world), rows(data["y"], rank, world)
        for i in range(6):
            loss, p, s = step(p, s, x, y, 0, float(i + 1))
    out = {"loss": loss.numpy()} | {f"p/{k}": v
                                    for k, v in named(step, p).items()}
    out |= counted(step)
    out["n_buckets"] = onp.int64(len(step.zero_plan))
    return out


def resnet(data):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res

    with gluon.nn.default_layout("NHWC"):
        net = t_res.ResNetV1(t_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, no_bias=True, prefix=PREFIX)
    net.initialize(device="cpu")
    parallel.load_jax_params(net, {k[len("resnet/"):]: v
                                   for k, v in data.items()
                                   if k.startswith("resnet/")})
    return net


def resnet_case(data, rank, world, sharded):
    kw = dict(learning_rate=0.1, momentum=0.9, loss_scale="dynamic",
              donate=False, bucket_bound=30000, mesh=parallel.get_mesh(),
              autotune=False)
    if sharded:
        kw["optimizer_sharding"] = "ps"
    out = {}
    with at.force(pallas_bnreluconv="pallas", fused_bucket_opt="pallas"):
        step, p, s = parallel.make_train_step(
            resnet(data), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", **kw)
        x, y = rows(data["rx"], rank, world), rows(data["ry"], rank, world)
        for i in range(3):
            loss, p, s = step(p, s, x, y, None, float(i + 1))
            out[f"loss{i}"] = loss.numpy()
    names = list(p)
    out |= {f"p/{names[int(k)]}": v for k, v in named(step, p).items()}
    out["bn_launches"] = onp.int64(
        step.exchange["roles"].get("bn", {}).get("launches", 0))
    out["ar_launches"] = onp.int64(step.exchange["all-reduce"]["launches"])
    out["n_rplan"] = onp.int64(len(zero.plan_buckets(p, 1, 30000)))
    return out


def bn_case(data, rank, world):
    ex = Exchange(parallel.get_mesh())
    out = {}
    g = data["bn_x"]
    r = data["bn_r"]
    for dt in ("float32", "bfloat16"):
        x = rows(g, rank, world).to(getattr(torch, dt)).requires_grad_()
        gamma = torch.linspace(0.5, 1.5, g.shape[-1]).requires_grad_()
        beta = torch.linspace(-0.2, 0.2, g.shape[-1]).requires_grad_()
        with t_nn.bn_group_scope(ex):
            o, mean, var = t_nn.batch_norm(
                x, gamma, beta, torch.zeros(g.shape[-1]),
                torch.ones(g.shape[-1]), eps=1e-5, fix_gamma=False,
                output_mean_var=True, axis=-1, train=True)
        (o.float() * rows(r, rank, world)).sum().backward()
        out |= {f"{dt}/mean": mean.detach().numpy(),
                f"{dt}/var": var.detach().numpy(),
                f"{dt}/dx": x.grad.float().numpy(),
                f"{dt}/dgamma": gamma.grad.numpy(),
                f"{dt}/dbeta": beta.grad.numpy()}
    from mxnet_tpu_torch.ops.pallas_conv import fused_bn_relu_conv1x1

    u = rows(g, rank, world).requires_grad_()
    w = torch.from_numpy(data["bn_w"]).requires_grad_()
    gamma = torch.linspace(0.5, 1.5, g.shape[-1]).requires_grad_()
    beta = torch.linspace(-0.2, 0.2, g.shape[-1]).requires_grad_()
    with t_nn.bn_group_scope(ex):
        y, mean, var = fused_bn_relu_conv1x1(u, gamma, beta, w, eps=1e-5)
    (y * rows(data["bn_ry"], rank, world)).sum().backward()
    out |= {"fused/mean": mean.detach().numpy(),
            "fused/var": var.detach().numpy(), "fused/du": u.grad.numpy(),
            "fused/dw": w.grad.numpy(), "fused/dgamma": gamma.grad.numpy()}
    return out


def guard_case(data, rank, world, sharded, how):
    kw = dict(learning_rate=0.1, momentum=0.9, mesh=parallel.get_mesh(),
              donate=False, autotune=False, bucket_bound=300)
    kw |= dict(loss_scale="dynamic") if how == "dyn" else \
        dict(nan_guard=True)
    if sharded:
        kw["optimizer_sharding"] = "ps"
    step, p0, s = parallel.make_train_step(
        mlp(data), gluon.loss.SoftmaxCrossEntropyLoss(), **kw)
    x, y = rows(data["X"], rank, world), rows(data["y"], rank, world)
    bad = x.clone()
    if rank == 1:
        bad[0, 0] = float("nan")
    _, p1, s = step(p0, s, bad, y, 0, 1.0)
    out = {"same": onp.bool_(all(
        onp.array_equal(a, b) for a, b in zip(named(step, p0).values(),
                                              named(step, p1).values())))}
    if how == "dyn":
        out["scale"] = s["_loss_scale"][0].numpy()
    else:
        out["bad_steps"] = s["_bad_steps"].numpy()
    _, p2, s = step(p1, s, x, y, 0, 2.0)
    out["moved"] = onp.bool_(not all(
        onp.array_equal(a, b) for a, b in zip(named(step, p1).values(),
                                              named(step, p2).values())))
    return out


def comp_case(data, rank, world):
    step, p, s = parallel.make_train_step(
        mlp(data), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        learning_rate=0.05, momentum=0.9, mesh=parallel.get_mesh(),
        donate=False, autotune=False, optimizer_sharding="ps",
        bucket_bound=300,
        gradient_compression={"type": "2bit", "threshold": 0.05})
    x, y = rows(data["X"], rank, world), rows(data["y"], rank, world)
    out = {}
    for i in range(4):
        loss, p, s = step(p, s, x, y, 0, float(i + 1))
        out[f"loss{i}"] = loss.numpy()
    rkeys = sorted(k for k in s if k.startswith("_residual"))
    out["shard_numel"] = onp.array([s[k].numel() for k in rkeys])
    out["resid_dtype_f32"] = onp.bool_(all(s[k].dtype == torch.float32
                                           for k in rkeys))
    out |= {f"r/{k}": host_gather(s[k]) for k in rkeys}
    out |= {f"p/{k}": v for k, v in named(step, p).items()}
    return out


def s3_case(data, rank, world, prefix):
    from mxnet_tpu_torch.resilience.checkpoint import (stage3_load_params,
                                                       stage3_save_params)

    mesh = parallel.get_mesh()
    net = mlp(data)
    trainer = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        learning_rate=0.1, mesh=mesh, donate=False, autotune=False,
        bucket_bound=300, optimizer_sharding="ps", zero_stage=3)
    x, y = rows(data["X"], rank, world), rows(data["y"], rank, world)
    for _ in range(3):
        trainer.fit_batch(x, y)
    step, p = trainer.step_fn, trainer.params
    plan = step.zero_plan
    out = {"stage": onp.int64(step.zero_stage),
           "numel": onp.array([v.numel() for v in p.values()]),
           "padded": onp.array([b.padded for b in plan])}
    saved = stage3_save_params(plan, p)
    back = stage3_load_params(plan, saved, mesh=mesh)
    out["roundtrip"] = onp.bool_(all(torch.equal(back[k], p[k]) for k in p))
    out |= {f"saved/{i}": saved[n]
            for i, n in enumerate(net.collect_params())}
    trainer.sync_to_block()
    out |= {f"block/{i}": prm.data().asnumpy()
            for i, prm in enumerate(net.collect_params().values())}
    if rank == 0:
        from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager
        from mxnet_tpu_torch.resilience.elastic import topology_block

        topo = topology_block(mesh=mesh, sharding="zero3", plan=plan,
                              zero_stage=3)
        CheckpointManager(prefix).save(
            1, arg_params={k: mx.nd.array(v) for k, v in saved.items()},
            topology=topo)
    return out


def fp8_case(data, rank, world):
    """The replicated MLP under the pinned fp8 rung, 4 steps: the input's
    scale must follow the global batch's largest magnitude."""
    env = {"MXNET_DTYPE_LADDER": "fp8", "MXNET_FP8_AMAX_HISTORY": "4"}
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        step, p, s = parallel.make_train_step(
            mlp(data), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            learning_rate=0.1, momentum=0.9, mesh=parallel.get_mesh(),
            donate=False, autotune=False, bucket_bound=300)
        x, y = rows(data["X"], rank, world), rows(data["y"], rank, world)
        out = {}
        for i in range(4):
            loss, p, s = step(p, s, x, y, 0, float(i + 1))
            out[f"loss{i}"] = loss.numpy()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["x_hist"] = s["_fp8"]["x"][1].numpy()
    out["g_hist"] = s["_fp8"]["g"][1].numpy()
    out["fp8_launches"] = onp.int64(
        step.exchange["roles"].get("fp8", {}).get("launches", 0))
    out |= {f"p/{k}": v for k, v in named(step, p).items()}
    return out


def dropout_case(data, rank, world):
    """One replicated step of an MLP with Dropout(0.5), every rank fed the
    same rows: the mask each rank drew."""
    from mxnet_tpu_torch import _rng

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu", in_units=8),
            gluon.nn.Dropout(0.5), gluon.nn.Dense(4, in_units=32))
    net.initialize()
    masks = []
    draw = _rng.draw_bernoulli

    def recording(keep, shape, device, gen):
        masks.append(draw(keep, shape, device, gen))
        return masks[-1]

    step, p, s = parallel.make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        learning_rate=0.1, momentum=0.0, mesh=parallel.get_mesh(),
        donate=False, autotune=False, bucket_bound=300)
    x, y = rows(data["X"], 0, world), rows(data["y"], 0, world)
    _rng.draw_bernoulli = recording
    try:
        _, p, s = step(p, s, x, y, 7, 1.0)
    finally:
        _rng.draw_bernoulli = draw
    return {"mask": torch.stack(masks).numpy()} | {
        f"p/{k}": v for k, v in named(step, p).items()}


def ops_case(data, rank, world):
    x = torch.from_numpy(data["ops_x"])
    n = x.numel() // world
    kv = mx.kv.create("dist_sync")
    mesh = parallel.get_mesh()
    same = (kv.rank, kv.num_workers) == (mesh.rank, mesh.size) \
        == (rank, world)
    return {"kv_is_mesh": onp.bool_(same),
            "rs": mx.nd.reduce_scatter(mx.nd.array(x)).asnumpy(),
            "ag": mx.nd.all_gather(mx.nd.array(
                x[rank * n:(rank + 1) * n])).asnumpy(),
            "mesh_desc": onp.array(at.mesh_desc(parallel.get_mesh()))}


def lars_plain_case(data, rank, world):
    from mxnet_tpu_torch.optimizer import LARS

    opt = LARS(learning_rate=0.1, momentum=0.9, wd=1e-4)
    w, g, m = (rows(data[k], rank, world) for k in ("lw", "lg", "lm"))
    seg = rows(data["lseg"], rank, world)
    nw, (nm,) = opt.fused_bucket_update(w, g, (m,), 1.0, seg_ids=seg.long(),
                                        num_segments=3, axis_name="data")
    return {"w": nw.numpy(), "m": nm.numpy()}


def main():
    inp, out = sys.argv[1], sys.argv[2]
    kvstore.init_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    data = dict(onp.load(inp))
    res = {}

    def put(case, vals):
        res.update({f"{case}/{k}": v for k, v in vals.items()})

    with mx.cpu():
        opts = ("lars",) if world == 4 else tuple(OPTS)
        for opt in opts:
            for stage in (1, 2, 3):
                put(f"{opt}_s{stage}", mlp_case(data, rank, world, opt,
                                                stage))
        if world == 2:
            put("larsk_s2", mlp_case(data, rank, world, "lars", 2,
                                     kernel=True))
            put("resnet_rep", resnet_case(data, rank, world, False))
            put("resnet_ps", resnet_case(data, rank, world, True))
            put("bn", bn_case(data, rank, world))
            for sharded in (False, True):
                for how in ("dyn", "guard"):
                    put(f"guard_{'ps' if sharded else 'rep'}_{how}",
                        guard_case(data, rank, world, sharded, how))
            put("comp", comp_case(data, rank, world))
            put("fp8", fp8_case(data, rank, world))
            put("drop", dropout_case(data, rank, world))
            put("s3", s3_case(data, rank, world, out + ".s3ck"))
            put("ops", ops_case(data, rank, world))
            put("lars_plain", lars_plain_case(data, rank, world))
    onp.savez(f"{out}.r{rank}.npz", **res)
    print(json.dumps({"rank": rank, "world": world, "keys": len(res)}),
          flush=True)
    # leave together: rank 0 serves the rendezvous store
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
