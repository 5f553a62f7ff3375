"""The fused train step across worker processes, held against the
reference's step on a mesh of as many CPU devices.

The port runs in N worker processes on a CPU gloo group, started by its
launcher (``mxnet_tpu_torch/tools/launch.py -n N --cpu``), one launch a
world size running every case of it (``tests/torch_zero_worker.py``);
the initial weights reach the workers through an ``.npz``.  The oracle
is the reference's ``make_train_step`` on a 2- or 4-device CPU mesh in
this process (``tests/conftest.py`` gives it 8 host devices), with the
global batch where the workers take their rows of it.  The three
launches (world 2, world 4, and ``example/train_imagenet.py --kv-store
dist_sync``) start together with the module's first test.

- ZeRO stages 1, 2 and 3 on the seeded 8->32->16->4 MLP of
  ``tests/test_zero_stages.py`` (``bucket_bound`` 300, 6 steps, lr 0.1,
  32 rows split over the ranks) for sgd at momentum 0 and 0.9, adam and
  lars: at world 2 the three stages are bit-identical to one another
  (gloo's sum of two is ``a + b`` in every collective) and within 1e-5
  of the reference's 2-device step; the replicas of stages 1 and 2 are
  equal bit for bit.  World 4, lars, against the reference's 4-device
  mesh at 1e-5 (read: within 3e-7).
- The replicated arm of a tiny channel-last ResNetV1 (3 steps, dynamic
  loss scale) with global BatchNorm against the reference's replicated
  step on 2 devices, and the ps arm against the reference's (per-shard
  statistics), to 1e-4 of each tensor's largest magnitude; BatchNorm's
  statistics and input gradients on split rows equal one process's on
  the global batch.
- Per-process state of the replicated arm: under the fp8 rung the
  input's amax history is the global batch's and the trajectory follows
  the reference's 2-device step; Dropout draws a mask of its own on
  every rank (``fold_in(key, rank)``).
- A NaN planted in rank 1's batch skips the update on both ranks under
  ``loss_scale="dynamic"`` (the scale halves on both) and ``nan_guard``.
- 2-bit compression at stage 2: residuals and parameters against the
  reference's; without ``ps`` it raises the reference's error.
- Stage 3: shard sizes, the checkpoint round trip, the stage-salted
  topology refused by a stage-2 world, ``sync_to_block``.
- The counted exchange bytes equal ``analytic_exchange_bytes``, which
  equals the reference's; the registered collective ops, ``mesh_desc``
  and LARS's plain rule across a cut segment equal the reference's.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res  # noqa: E402
from mxnet_tpu.ops import collective_ops as j_co  # noqa: E402
from mxnet_tpu.parallel import zero as j_zero  # noqa: E402
from mxnet_tpu.resilience import elastic as j_elastic  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import gluon as t_gluon  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch import recordio as t_rec  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.parallel import zero as t_zero  # noqa: E402
from mxnet_tpu_torch.resilience import elastic as t_elastic  # noqa: E402
from mxnet_tpu_torch.resilience.checkpoint import \
    CheckpointManager as TMgr  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCH = os.path.join(_REPO, "mxnet_tpu_torch", "tools", "launch.py")
_WORKER = os.path.join(_REPO, "tests", "torch_zero_worker.py")
_EXAMPLE = os.path.join(_REPO, "mxnet_tpu_torch", "example",
                        "train_imagenet.py")
_TIMEOUT = 240
OPTS = {"sgd0": ("sgd", 0.0), "sgd9": ("sgd", 0.9), "adam": ("adam", 0.9),
        "lars": ("lars", 0.9)}
CHANNELS = [8, 16, 32, 64, 128]
PREFIX = "resnetv10_"
#: the MLP's stages against the reference's mesh
MLP_TOL = 1e-5
#: under Adam, the share of a tensor's elements (at least one) that may
#: miss MLP_TOL and by how much: its normalised step turns the last-bit
#: differences of a near-zero gradient into whole steps (read: one
#: element of a tensor, at most 4.0e-5; tests/test_torch_train_lars_adam.py
#: allows the same kind)
ADAM_OUTLIERS = (0.01, 1e-4)
#: the fp8 rung's MLP against the reference's mesh (both snap to the
#: same e4m3/e5m2 grids at the same scales; read: losses within 1.2e-7,
#: parameters within 1.5e-8, the amax histories equal)
FP8_TOL = 1e-5
#: the ResNet's steps, relative to each tensor's largest magnitude (the
#: packages sum convolutions and reductions in other orders)
RESNET_TOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    for k in ("MXNET_OPTIMIZER_SHARDING", "MXNET_ZERO_STAGE"):
        env.pop(k, None)
    return env


class _Job:
    def __init__(self, cmd):
        self._p = subprocess.Popen(cmd, env=_env(), cwd=_REPO,
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
            sys.stderr.write(err[-4000:])
        return self._res


def _launch(n, *cmd):
    return _Job([sys.executable, _LAUNCH, "-n", str(n), "--cpu",
                 sys.executable, *cmd])


# ------------------------------------------------------------ inputs
def _j_mlp():
    jmx.random.seed(0)
    onp.random.seed(0)
    net = j_nn.HybridSequential()
    with net.name_scope():
        net.add(j_nn.Dense(32, activation="relu"),
                j_nn.Dense(16, activation="relu"), j_nn.Dense(4))
    net.initialize(init=jmx.init.Xavier())
    net(jmx.nd.zeros((1, 8)))
    return net


def _j_resnet():
    jmx.random.seed(0)
    onp.random.seed(0)
    with j_nn.default_layout("NHWC"):
        net = j_res.ResNetV1(j_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, no_bias=True, prefix=PREFIX)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(onp.zeros((1, 32, 32, 3), "float32")))
    rng = onp.random.RandomState(5)
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(jmx.nd.array(rng.rand(*p.shape).astype("float32")
                                    + 0.5))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("float32")
                                    * 0.1))
    return net


def _inputs():
    rng = onp.random.RandomState(0)
    d = {"X": rng.rand(32, 8).astype("float32"),
         "y": rng.randint(0, 4, (32,)).astype("float32")}
    for i, p in enumerate(_j_mlp().collect_params().values()):
        d[f"mlp/{i}"] = onp.asarray(p.data().asnumpy())
    for n, p in _j_resnet().collect_params().items():
        d[f"resnet/{n}"] = onp.asarray(p.data().asnumpy())
    r = onp.random.RandomState(11)
    d["rx"] = r.randn(8, 64, 64, 3).astype("float32")
    d["ry"] = r.randint(0, 10, 8).astype("float32")
    b = onp.random.RandomState(3)
    d["bn_x"] = (b.randn(8, 6, 5, 12) * 2 + 1).astype("float32")
    d["bn_r"] = b.randn(8, 6, 5, 12).astype("float32")
    d["bn_w"] = (b.randn(7, 1, 1, 12) * 0.3).astype("float32")
    d["bn_ry"] = b.randn(8, 6, 5, 7).astype("float32")
    d["ops_x"] = onp.arange(16, dtype="float32") * 0.5 - 3
    # a LARS bucket of 3 tensors (7, 9 and 4 elements): rank 0's shard
    # ends inside the second
    d["lw"] = b.randn(20).astype("float32")
    d["lg"] = b.randn(20).astype("float32")
    d["lm"] = (b.randn(20) * 0.1).astype("float32")
    d["lseg"] = onp.repeat(onp.arange(3), [7, 9, 4]).astype("int32")
    return d


def _corpus(path, n=16, size=40):
    rng = onp.random.RandomState(9)
    w = t_rec.MXRecordIO(path, "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 255).astype("uint8")
        w.write(t_rec.pack_img(t_rec.IRHeader(0, float(i % 10), i, 0), img,
                               quality=90))
    w.close()


@pytest.fixture(scope="module")
def jobs():
    d = tempfile.mkdtemp(prefix="torch_zero_")
    data = _inputs()
    inp = os.path.join(d, "in.npz")
    onp.savez(inp, **data)
    rec = os.path.join(d, "train.rec")
    _corpus(rec)
    out = {"dir": d, "data": data,
           2: _launch(2, _WORKER, inp, os.path.join(d, "w2")),
           4: _launch(4, _WORKER, inp, os.path.join(d, "w4")),
           "imagenet": _launch(
               2, _EXAMPLE, "--data-train", rec, "--network",
               "resnet18_v1", "--batch-size", "2", "--image-shape",
               "3,32,32", "--num-classes", "10", "--dtype", "float32",
               "--lr", "0.01", "--kv-store", "dist_sync",
               "--data-parallel-mesh", "--ctx", "cpu")}
    return out


def _ranks(jobs, world):
    rc, out, err = jobs[world].result()
    assert rc == 0, err[-3000:]
    return [dict(onp.load(os.path.join(jobs["dir"], f"w{world}.r{r}.npz")))
            for r in range(world)]


def _case(res, case):
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


# ------------------------------------------------------------ the oracle
_REF = {}


def _mesh(n):
    return jax.sharding.Mesh(onp.array(jax.devices()[:n]), ("data",))


def _ref_mlp(opt, stage, ndev, **kw):
    key = (opt, stage, ndev, repr(sorted(kw.items())))
    if key not in _REF:
        name, momentum = OPTS[opt]
        args = dict(optimizer=name, learning_rate=0.1, momentum=momentum,
                    mesh=_mesh(ndev), donate=False, autotune=False,
                    bucket_bound=300, optimizer_sharding="ps",
                    zero_stage=stage)
        args.update(kw)
        steps = args.pop("steps", 6)
        net = _j_mlp()
        order = list(net.collect_params())
        step, p, s = j_par.make_train_step(
            net, j_gluon.loss.SoftmaxCrossEntropyLoss(), **args)
        d = _inputs()
        X, y = jnp.asarray(d["X"]), jnp.asarray(d["y"])
        losses = []
        for i in range(steps):
            loss, p, s = step(p, s, X, y, jax.random.key(0), float(i + 1))
            losses.append(float(loss))
        if getattr(step, "zero_stage", None) == 3:
            p = j_zero.gather_stage3_params(
                step.zero_plan, {k: onp.asarray(v) for k, v in p.items()})
        # jit returns dicts in sorted key order: back to the net's
        _REF[key] = (losses, [onp.asarray(p[n]) for n in order], s, step)
    return _REF[key]


def _assert_close(got, want, outliers=(0.0, 0.0)):
    share, step = outliers
    for a, b in zip(got, want):
        diff = onp.abs(a - b)
        missed = diff > MLP_TOL + MLP_TOL * onp.abs(b)
        assert missed.sum() <= max(1, share * missed.size) and \
            (diff[missed] <= step).all(), (int(missed.sum()),
                                           float(diff.max()))


def _params(case_res):
    p = {k[2:]: v for k, v in case_res.items() if k.startswith("p/")}
    return [p[str(i)] for i in range(len(p))]


# ------------------------------------------------------------ ZeRO stages
@pytest.mark.parametrize("opt", list(OPTS))
def test_stages_bit_identical_and_match_the_reference(jobs, opt):
    ranks = _ranks(jobs, 2)
    ref_loss, ref_p, _, _ = _ref_mlp(opt, 2, 2)
    for r, res in enumerate(ranks):
        finals = {st: _case(res, f"{opt}_s{st}") for st in (1, 2, 3)}
        for st in (1, 3):
            assert finals[st]["loss"] == finals[2]["loss"], (r, st)
            for a, b in zip(_params(finals[st]), _params(finals[2])):
                onp.testing.assert_array_equal(a, b, err_msg=f"{r} s{st}")
        onp.testing.assert_allclose(float(finals[2]["loss"]), ref_loss[-1],
                                    rtol=MLP_TOL, atol=MLP_TOL)
        _assert_close(_params(finals[2]), ref_p,
                      ADAM_OUTLIERS if opt == "adam" else (0.0, 0.0))
    # the replicas of every stage are equal bit for bit
    for st in (1, 2, 3):
        for a, b in zip(_params(_case(ranks[0], f"{opt}_s{st}")),
                        _params(_case(ranks[1], f"{opt}_s{st}"))):
            onp.testing.assert_array_equal(a, b)


def test_lars_kernel_arm_across_shards(jobs):
    """The bucket-kernel arm (its plain version on the CPU) sums the
    LARS norms over the shards between the reduce and the trust."""
    res = _case(_ranks(jobs, 2)[0], "larsk_s2")
    ref_loss, ref_p, _, _ = _ref_mlp("lars", 2, 2)
    onp.testing.assert_allclose(float(res["loss"]), ref_loss[-1],
                                rtol=MLP_TOL, atol=MLP_TOL)
    for a, b in zip(_params(res), ref_p):
        onp.testing.assert_allclose(a, b, rtol=MLP_TOL, atol=MLP_TOL)


def test_world_four_lars_stages_match_the_reference(jobs):
    ranks = _ranks(jobs, 4)
    ref_loss, ref_p, _, _ = _ref_mlp("lars", 2, 4)
    for res in ranks:
        for st in (1, 2, 3):
            got = _case(res, f"lars_s{st}")
            onp.testing.assert_allclose(float(got["loss"]), ref_loss[-1],
                                        rtol=MLP_TOL, atol=MLP_TOL)
            for a, b in zip(_params(got), ref_p):
                onp.testing.assert_allclose(a, b, rtol=MLP_TOL,
                                            atol=MLP_TOL)
    for st in (1, 2, 3):
        first = _params(_case(ranks[0], f"lars_s{st}"))
        for res in ranks[1:]:
            for a, b in zip(first, _params(_case(res, f"lars_s{st}"))):
                onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_counted_exchange_equals_the_analytic_bytes(jobs, stage):
    res = _case(_ranks(jobs, 2)[0], f"sgd9_s{stage}")
    _, _, _, j_step = _ref_mlp("sgd9", stage, 2)
    want = j_zero.analytic_exchange_bytes(j_step.zero_plan, 2, stage)
    t_plan = t_zero.plan_buckets(
        {str(i): torch.zeros(v.shape) for i, v in enumerate(
            _params(res))}, 2, capacity=300)
    assert t_zero.analytic_exchange_bytes(t_plan, 2, stage) == want
    assert {k: int(res[f"bytes/{k}"]) for k in want} == want
    n = int(res["n_buckets"])
    assert n == len(j_step.zero_plan) >= 2
    launches = {k: int(res[f"launches/{k}"]) for k in want}
    assert launches == ({"all-reduce": n, "all-gather": n,
                         "reduce-scatter": 0} if stage == 1 else
                        {"all-reduce": 0, "all-gather": n,
                         "reduce-scatter": n})


# ------------------------------------------------------------ BatchNorm
def _ref_resnet(sharded):
    key = ("resnet", sharded)
    if key not in _REF:
        kw = dict(learning_rate=0.1, momentum=0.9, loss_scale="dynamic",
                  donate=False, bucket_bound=30000, mesh=_mesh(2),
                  autotune=False)
        if sharded:
            kw["optimizer_sharding"] = "ps"
        d = _inputs()
        losses = []
        with j_at.force(pallas_bnreluconv="pallas"):
            step, p, s = j_par.make_train_step(
                _j_resnet(), j_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                **kw)
            for i in range(3):
                loss, p, s = step(p, s, d["rx"], d["ry"],
                                  jax.random.key(0), float(i + 1))
                losses.append(float(loss))
        _REF[key] = (losses, {n: onp.asarray(v) for n, v in p.items()})
    return _REF[key]


@pytest.mark.parametrize("arm", ["rep", "ps"])
def test_resnet_step_matches_the_reference(jobs, arm):
    ranks = _ranks(jobs, 2)
    ref_losses, ref_p = _ref_resnet(arm == "ps")
    for res in ranks:
        got = _case(res, f"resnet_{arm}")
        onp.testing.assert_allclose([float(got[f"loss{i}"])
                                     for i in range(3)], ref_losses,
                                    rtol=RESNET_TOL, atol=RESNET_TOL)
        for n, want in ref_p.items():
            have = got[f"p/{n}"]
            scale = max(float(onp.abs(want).max()), 1e-6)
            assert float(onp.abs(have - want).max()) <= RESNET_TOL * scale, n
    for n in ref_p:
        onp.testing.assert_array_equal(_case(ranks[0], f"resnet_{arm}")[
            f"p/{n}"], _case(ranks[1], f"resnet_{arm}")[f"p/{n}"])
    got = _case(ranks[0], f"resnet_{arm}")
    if arm == "rep":
        # one all-reduce a gradient bucket, plus BatchNorm's own
        assert int(got["ar_launches"]) == int(got["n_rplan"]) >= 2
        assert int(got["bn_launches"]) > 0
    else:
        assert int(got["bn_launches"]) == 0


def _bn_whole(data, dt):
    """One process's BatchNorm on the global batch: the reference."""
    x = torch.from_numpy(data["bn_x"]).to(getattr(torch, dt))
    x.requires_grad_()
    c = data["bn_x"].shape[-1]
    gamma = torch.linspace(0.5, 1.5, c).requires_grad_()
    beta = torch.linspace(-0.2, 0.2, c).requires_grad_()
    o, mean, var = t_nn.batch_norm(
        x, gamma, beta, torch.zeros(c), torch.ones(c), eps=1e-5,
        fix_gamma=False, output_mean_var=True, axis=-1, train=True)
    (o.float() * torch.from_numpy(data["bn_r"])).sum().backward()
    return mean.detach(), var.detach(), x.grad.float(), gamma.grad, \
        beta.grad


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_batchnorm_takes_the_global_batch(jobs, dt):
    data = jobs["data"]
    ranks = [_case(r, "bn") for r in _ranks(jobs, 2)]
    mean, var, dx, dgamma, dbeta = _bn_whole(data, dt)
    tol = 1e-5 if dt == "float32" else 2e-2
    for r, res in enumerate(ranks):
        onp.testing.assert_allclose(res[f"{dt}/mean"], mean.numpy(),
                                    rtol=1e-5, atol=1e-6)
        onp.testing.assert_allclose(res[f"{dt}/var"], var.numpy(),
                                    rtol=1e-5, atol=1e-6)
        onp.testing.assert_allclose(res[f"{dt}/dx"],
                                    dx.numpy()[r * 4:(r + 1) * 4],
                                    rtol=tol, atol=tol)
    # the parameter gradients are each process's share of the sum
    onp.testing.assert_allclose(ranks[0][f"{dt}/dgamma"]
                                + ranks[1][f"{dt}/dgamma"],
                                dgamma.numpy(), rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(ranks[0][f"{dt}/dbeta"]
                                + ranks[1][f"{dt}/dbeta"],
                                dbeta.numpy(), rtol=1e-4, atol=1e-4)


def test_fused_bn_relu_conv_takes_the_global_batch(jobs):
    from mxnet_tpu_torch.ops.pallas_conv import fused_bn_relu_conv1x1

    data = jobs["data"]
    ranks = [_case(r, "bn") for r in _ranks(jobs, 2)]
    u = torch.from_numpy(data["bn_x"]).requires_grad_()
    w = torch.from_numpy(data["bn_w"]).requires_grad_()
    c = data["bn_x"].shape[-1]
    gamma = torch.linspace(0.5, 1.5, c).requires_grad_()
    beta = torch.linspace(-0.2, 0.2, c).requires_grad_()
    y, mean, var = fused_bn_relu_conv1x1(u, gamma, beta, w, eps=1e-5)
    (y * torch.from_numpy(data["bn_ry"])).sum().backward()
    for r, res in enumerate(ranks):
        onp.testing.assert_allclose(res["fused/mean"], mean.detach().numpy(),
                                    rtol=1e-5, atol=1e-6)
        onp.testing.assert_allclose(res["fused/var"], var.detach().numpy(),
                                    rtol=1e-5, atol=1e-6)
        onp.testing.assert_allclose(res["fused/du"],
                                    u.grad.numpy()[r * 4:(r + 1) * 4],
                                    rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(ranks[0]["fused/dw"] + ranks[1]["fused/dw"],
                                w.grad.numpy(), rtol=1e-4, atol=1e-4)
    onp.testing.assert_allclose(ranks[0]["fused/dgamma"]
                                + ranks[1]["fused/dgamma"],
                                gamma.grad.numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ verdicts
@pytest.mark.parametrize("arm", ["rep", "ps"])
@pytest.mark.parametrize("how", ["dyn", "guard"])
def test_a_nan_on_one_rank_skips_the_step_on_every_rank(jobs, arm, how):
    for res in _ranks(jobs, 2):
        got = _case(res, f"guard_{arm}_{how}")
        assert bool(got["same"]) and bool(got["moved"])
        if how == "dyn":
            assert float(got["scale"]) == 2.0 ** 15
        else:
            assert int(got["bad_steps"]) == 1


# ------------------------------------------------------------ compression
def test_compression_residuals_match_the_reference(jobs):
    ranks = [_case(r, "comp") for r in _ranks(jobs, 2)]
    comp = {"type": "2bit", "threshold": 0.05}
    losses, ref_p, ref_s, _ = _ref_mlp(
        "sgd9", None, 2, learning_rate=0.05, gradient_compression=comp,
        steps=4, zero_stage=None)
    for res in ranks:
        assert bool(res["resid_dtype_f32"])
        rkeys = sorted(k for k in ref_s if k.startswith("_residual"))
        assert len(rkeys) == 3
        for i, k in enumerate(rkeys):
            assert int(res["shard_numel"][i]) * 2 == ref_s[k].shape[0]
            onp.testing.assert_allclose(res[f"r/{k}"],
                                        onp.asarray(ref_s[k]),
                                        rtol=MLP_TOL, atol=MLP_TOL)
        onp.testing.assert_allclose([float(res[f"loss{i}"])
                                     for i in range(4)], losses,
                                    rtol=MLP_TOL, atol=MLP_TOL)
        for a, b in zip(_params(res), ref_p):
            onp.testing.assert_allclose(a, b, rtol=MLP_TOL, atol=MLP_TOL)
    with pytest.raises(MXNetError, match="requires optimizer_sharding"):
        t_par.make_train_step(
            t_gluon.nn.Dense(4, in_units=8), t_gluon.loss.L2Loss(),
            mesh=t_par.get_mesh(devices=["cpu"]),
            gradient_compression=comp)


# ---------------------------------------------------- per-process state
def test_fp8_rung_scales_by_the_global_batch(jobs, monkeypatch):
    """The replicated arm's fp8 rung at world 2 against the reference's on
    a 2-device mesh: each process sees half the rows, yet the input's
    amax history is the global batch's, bit for bit, so the scales, the
    losses and the parameters follow the reference's."""
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp8")
    monkeypatch.setenv("MXNET_FP8_AMAX_HISTORY", "4")
    ranks = [_case(r, "fp8") for r in _ranks(jobs, 2)]
    losses, ref_p, ref_s, _ = _ref_mlp(
        "sgd9", None, 2, optimizer_sharding=None, zero_stage=None, steps=4)
    for res in ranks:
        # one max all-reduce of the input's amax a step (the last's)
        assert int(res["fp8_launches"]) == 1
        onp.testing.assert_array_equal(res["x_hist"],
                                       onp.asarray(ref_s["_fp8"]["x"][1]))
        onp.testing.assert_allclose(res["g_hist"],
                                    onp.asarray(ref_s["_fp8"]["g"][1]),
                                    rtol=FP8_TOL, atol=FP8_TOL)
        onp.testing.assert_allclose([float(res[f"loss{i}"])
                                     for i in range(4)], losses,
                                    rtol=FP8_TOL, atol=FP8_TOL)
        for a, b in zip(_params(res), ref_p):
            onp.testing.assert_allclose(a, b, rtol=FP8_TOL, atol=FP8_TOL)
    for a, b in zip(_params(ranks[0]), _params(ranks[1])):
        onp.testing.assert_array_equal(a, b)


def test_dropout_masks_differ_across_ranks(jobs):
    """Every rank fed the same rows draws its own Dropout mask, from
    ``fold_in(key, rank)``, so the processes' rows never share a mask
    (the reference draws one mask over the global batch; the packages'
    generators differ, so masks are compared with the port's own
    derivation), and the replicas stay equal."""
    from mxnet_tpu_torch import _rng as t_rng

    ranks = [_case(r, "drop") for r in _ranks(jobs, 2)]
    masks = [res["mask"] for res in ranks]
    assert masks[0].shape == (1, 16, 32)
    assert not onp.array_equal(masks[0], masks[1])
    for r, m in enumerate(masks):
        with t_rng.key_scope(t_rng.fold_in(7, r)):
            gen = t_rng.take_key("cpu")
            want = t_rng.draw_bernoulli(0.5, (16, 32), torch.device("cpu"),
                                        gen)
        onp.testing.assert_array_equal(m[0], want.numpy())
    for a, b in zip(_params(ranks[0]), _params(ranks[1])):
        onp.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ stage 3
def test_stage3_shards_checkpoint_and_sync(jobs):
    ranks = [_case(r, "s3") for r in _ranks(jobs, 2)]
    ref_loss, ref_p, _, _ = _ref_mlp("adam", 3, 2, steps=3)
    for res in ranks:
        assert int(res["stage"]) == 3
        onp.testing.assert_array_equal(res["numel"] * 2, res["padded"])
        assert bool(res["roundtrip"])
        _assert_close([res[f"saved/{i}"] for i in range(len(ref_p))],
                      ref_p, ADAM_OUTLIERS)
        for i in range(len(ref_p)):
            onp.testing.assert_array_equal(res[f"block/{i}"],
                                           res[f"saved/{i}"])
    for i in range(len(ref_p)):
        onp.testing.assert_array_equal(ranks[0][f"saved/{i}"],
                                       ranks[1][f"saved/{i}"])
    # the stage-3 checkpoint rank 0 wrote: a stage-2 world refuses it
    st = TMgr(os.path.join(jobs["dir"], "w2.s3ck")).load()
    topo3 = st["topology"]
    assert topo3["sharding"] == "zero3" and topo3["zero_stage"] == 3
    assert topo3["world_size"] == 2 and topo3["mesh_shape"] == [2]
    plan = t_zero.plan_buckets(
        {str(i): torch.zeros(v.shape) for i, v in enumerate(ref_p)}, 2,
        capacity=300)
    topo2 = t_elastic.topology_block(world_size=2, num_processes=2,
                                     sharding="ps", plan=plan)
    verdict = t_elastic.reshard_verdict(topo3, topo2)
    assert verdict["reshard"]
    assert verdict == j_elastic.reshard_verdict(topo3, topo2)
    assert not t_elastic.reshard_verdict(topo3, dict(topo3))["reshard"]


# ------------------------------------------------------------ small pieces
def test_collective_ops_and_mesh_desc_match_the_reference(jobs,
                                                          monkeypatch):
    ranks = [_case(r, "ops") for r in _ranks(jobs, 2)]
    x = jobs["data"]["ops_x"]
    for n in (1, 2):
        monkeypatch.setattr(j_co, "_data_mesh", lambda n=n: _mesh(n))
        rs = onp.asarray(j_co.reduce_scatter(jnp.asarray(x)))
        ag = onp.asarray(j_co.all_gather(jnp.asarray(x)))
        if n == 1:
            got_rs = tmx.nd.reduce_scatter(tmx.nd.array(x)).asnumpy()
            got_ag = tmx.nd.all_gather(tmx.nd.array(x)).asnumpy()
        else:
            got_rs = onp.concatenate([r["rs"] for r in ranks])
            got_ag = ranks[0]["ag"]
            onp.testing.assert_array_equal(ranks[1]["ag"], got_ag)
        onp.testing.assert_array_equal(got_rs, rs)
        onp.testing.assert_array_equal(got_ag, ag)
    assert str(ranks[0]["mesh_desc"]) == j_at.mesh_desc(_mesh(2)) == \
        "data=2"
    # mx.kv.create("dist_sync") and get_mesh() are the one job's group
    assert all(bool(r["kv_is_mesh"]) for r in ranks)
    assert t_at.mesh_desc(t_par.get_mesh(devices=["cpu"])) == \
        j_at.mesh_desc(_mesh(1))


def test_lars_plain_rule_sums_a_cut_segment_over_shards(jobs):
    from jax.sharding import PartitionSpec as P

    from mxnet_tpu.optimizer import LARS as JLARS

    d = jobs["data"]
    ranks = [_case(r, "lars_plain") for r in _ranks(jobs, 2)]
    opt = JLARS(learning_rate=0.1, momentum=0.9, wd=1e-4)

    def local(w, g, m, seg):
        nw, (nm,) = opt.fused_bucket_update(w, g, (m,), 1.0, seg_ids=seg,
                                            num_segments=3,
                                            axis_name="data")
        return nw, nm

    fn = j_par.compat_shard_map(local, _mesh(2), in_specs=(P("data"),) * 4,
                                out_specs=(P("data"), P("data")))
    nw, nm = fn(*(jnp.asarray(d[k]) for k in ("lw", "lg", "lm", "lseg")))
    onp.testing.assert_allclose(onp.concatenate([r["w"] for r in ranks]),
                                onp.asarray(nw), rtol=1e-6, atol=1e-7)
    onp.testing.assert_allclose(onp.concatenate([r["m"] for r in ranks]),
                                onp.asarray(nm), rtol=1e-6, atol=1e-7)


def test_train_imagenet_dist_sync_two_workers(jobs):
    rc, out, err = jobs["imagenet"].result()
    assert rc == 0, err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{") and "params_sha256" in ln]
    assert sorted(r["rank"] for r in lines) == [0, 1]
    assert all(onp.isfinite(r["final_loss"]) and r["steps"] == 4
               for r in lines)
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
