"""ResNet v1 training with LARS and with Adam held against the JAX
package on the CPU.

A tiny channel-last ResNetV1 (BottleneckV1, one block per stage,
widths 8..128, 10 classes, no_bias) is built in both packages with the
same parameter names and weights.  Both ``make_train_step``s run three
fp32 steps with dynamic loss scaling on one fixed batch (numpy seed),
through the sharded-bucket arm on a one-device mesh with the fused
BN-ReLU-conv tail forced and the bucket update on each of its arms
(``MXNET_PALLAS_OPT=1``: the kernels — the JAX Pallas kernels in
interpret mode, the port's plain versions on the CPU; ``0``: the
rule's ``fused_bucket_update``).  The port's replicated arm (each
rule per tensor) is held against the reference's plain bucket arm: the
same update, per tensor or per segment.

Tolerance: losses and parameters to 1e-4 relative to each tensor's
largest magnitude (the packages sum convolutions in other orders;
measured under LARS: 2.1e-6).  Adam's update of an element is nearly
``lr·sign(g)`` however small g is, and about ``lr·g/eps`` where
``|g|`` is near ``eps/sqrt(1 - beta2)``: an element whose gradient is
that close to zero takes a step decided by summation noise.  So under
Adam at most ``ADAM_OUTLIERS`` of a tensor's elements may miss 1e-4,
each by at most one step (``lr``).  Measured after three steps on both
arms: 10 of 36,178 elements, at most 5 of one tensor's 4,096 (0.12%),
the largest miss 3.3e-4.  The bucket plan and the loss-scale state
must be identical.  Running
statistics have no gradient, and under LARS (trust 1, ``wd > 0``) and
Adam (``wd > 0``) they decay by the weight-decay term alone, in both
packages (ROADMAP §C).
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import initializer as j_init  # noqa: E402
from mxnet_tpu import nd  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res  # noqa: E402

from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch.gluon import loss as t_loss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res  # noqa: E402

CHANNELS = [8, 16, 32, 64, 128]
PREFIX = "resnetv10_"
#: small enough that the tiny net spans several buckets
BUCKET_BOUND = 30000
STEPS = 3
TOL = 1e-4
#: under Adam: the share of a tensor's elements that may miss TOL, and
#: by how much (module docstring)
ADAM_OUTLIERS = (0.002, 1e-3)
OPTIMIZERS = {
    "lars": dict(learning_rate=2.0, momentum=0.9, wd=5e-5, lars_eta=0.01),
    "adam": dict(learning_rate=1e-3, wd=1e-4),
}


def _port_net():
    with t_nn.default_layout("NHWC"):
        return t_res.ResNetV1(t_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                              classes=10, no_bias=True, prefix=PREFIX)


@pytest.fixture(scope="module")
def jax_net():
    mx.random.seed(0)
    onp.random.seed(0)
    with j_nn.default_layout("NHWC"):
        net = j_res.ResNetV1(j_res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, no_bias=True, prefix=PREFIX)
    net.initialize(j_init.Xavier())
    net(nd.array(onp.zeros((1, 32, 32, 3), "float32")))  # deferred shapes
    rng = onp.random.RandomState(5)
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(nd.array(rng.rand(*p.shape).astype("float32") + 0.5))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(nd.array(rng.randn(*p.shape).astype("float32") * 0.1))
    return net


@pytest.fixture(scope="module")
def weights(jax_net):
    return {n: onp.asarray(p.data().asnumpy())
            for n, p in jax_net.collect_params().items()}


def _batch():
    rng = onp.random.RandomState(11)
    x = rng.randn(8, 64, 64, 3).astype("float32")
    y = rng.randint(0, 10, 8).astype("float32")
    return x, y


def _kwargs(opt, sharded=True):
    kw = dict(OPTIMIZERS[opt], loss_scale="dynamic", donate=False,
              bucket_bound=BUCKET_BOUND)
    if sharded:
        kw["optimizer_sharding"] = "ps"
    return kw


def _run_jax(net, opt, kernel, monkeypatch):
    x, y = _batch()
    monkeypatch.setenv("MXNET_PALLAS_OPT", "1" if kernel else "0")
    mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
    losses = []
    with j_at.force(pallas_bnreluconv="pallas"):
        step, p, s = j_par.make_train_step(
            net, j_gluon.loss.SoftmaxCrossEntropyLoss(), opt, mesh=mesh,
            **_kwargs(opt))
        for i in range(STEPS):
            loss, p, s = step(p, s, x, y, jax.random.key(0), float(i + 1))
            losses.append(float(loss))
    plan = [b.names for b in step.zero_plan]
    return losses, {n: onp.asarray(v) for n, v in p.items()}, s, plan


def _port_net_loaded(weights):
    net = _port_net()
    net.initialize(device="cpu")
    t_par.load_jax_params(net, weights)
    return net


def _run_port(weights, opt, kernel, monkeypatch, sharded=True):
    x, y = _batch()
    monkeypatch.setenv("MXNET_PALLAS_OPT", "1" if kernel else "0")
    kw = _kwargs(opt, sharded)
    if sharded:
        kw["mesh"] = t_par.get_mesh(devices=["cpu"])
    else:
        kw["device"] = "cpu"
    losses = []
    with t_at.force(pallas_bnreluconv="pallas"):
        step, p, s = t_par.make_train_step(
            _port_net_loaded(weights), t_loss.SoftmaxCrossEntropyLoss(), opt,
            **kw)
        for i in range(STEPS):
            loss, p, s = step(p, s, torch.from_numpy(x), torch.from_numpy(y),
                              None, float(i + 1))
            losses.append(float(loss))
    plan = [b.names for b in getattr(step, "zero_plan", [])]
    return losses, {n: v.numpy() for n, v in p.items()}, s, plan


@pytest.fixture(scope="module")
def jax_runs(jax_net):
    done = {}

    def get(opt, kernel):
        if (opt, kernel) not in done:
            with pytest.MonkeyPatch.context() as mp:
                done[opt, kernel] = _run_jax(jax_net, opt, kernel, mp)
        return done[opt, kernel]

    return get


def _assert_close(t_run, j_run, weights, outliers=(0.0, 0.0)):
    t_losses, t_params, t_state, t_plan = t_run
    j_losses, j_params, j_state, j_plan = j_run
    assert not t_plan or t_plan == j_plan
    assert onp.allclose(t_losses, j_losses, rtol=TOL, atol=0), \
        (t_losses, j_losses)
    assert t_losses[-1] < t_losses[0]
    assert sorted(t_params) == sorted(j_params)
    share, step = outliers
    for n, want in j_params.items():
        diff = onp.abs(t_params[n] - want)
        missed = diff > TOL * onp.abs(want).max()
        assert missed.mean() <= share and (diff[missed] <= step).all(), \
            (n, int(missed.sum()), float(diff.max()))
        if n.endswith(("running_mean", "running_var")):
            # no gradient: weight decay alone moves them, in both
            assert not onp.array_equal(want, weights[n]), n
    assert [float(v) for v in t_state["_loss_scale"]] == \
        [float(v) for v in j_state["_loss_scale"]] == [2.0 ** 16, STEPS]


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_ps_train_steps_match_reference(jax_runs, weights, opt, kernel,
                                        monkeypatch):
    t_run = _run_port(weights, opt, kernel, monkeypatch)
    assert len(t_run[3]) > 1
    _assert_close(t_run, jax_runs(opt, kernel), weights,
                  ADAM_OUTLIERS if opt == "adam" else (0.0, 0.0))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_replicated_train_steps_match_reference(jax_runs, weights, opt,
                                                monkeypatch):
    t_run = _run_port(weights, opt, False, monkeypatch, sharded=False)
    _assert_close(t_run, jax_runs(opt, False), weights,
                  ADAM_OUTLIERS if opt == "adam" else (0.0, 0.0))


def test_data_parallel_trainer_equals_the_direct_step(weights, monkeypatch):
    """fit_batch numbers the steps from 1 and runs the step of
    make_train_step; sync_to_block writes the trained tensors back."""
    monkeypatch.setenv("MXNET_PALLAS_OPT", "1")
    x, y = _batch()
    want = _run_port(weights, "lars", True, monkeypatch)
    net = _port_net_loaded(weights)
    with t_at.force(pallas_bnreluconv="pallas"):
        trainer = t_par.DataParallelTrainer(
            net, t_loss.SoftmaxCrossEntropyLoss(), "lars",
            mesh=t_par.get_mesh(devices=["cpu"]), **_kwargs("lars"))
        losses = [float(trainer.fit_batch(torch.from_numpy(x),
                                          torch.from_numpy(y)))
                  for _ in range(STEPS)]
    assert losses == want[0]
    assert trainer.step_fn.zero_plan and \
        [b.names for b in trainer.step_fn.zero_plan] == want[3]
    for n, v in trainer.params.items():
        assert onp.array_equal(v.numpy(), want[1][n]), n
    trainer.sync_to_block()
    for n, p in net.collect_params().items():
        assert onp.array_equal(p.data().asnumpy(), want[1][n]), n
    # stage 3 is ported: its bucket shards gather back into the block
    stage3 = t_par.DataParallelTrainer(
        net, t_loss.SoftmaxCrossEntropyLoss(), "lars",
        mesh=t_par.get_mesh(devices=["cpu"]), zero_stage=3)
    assert stage3.step_fn.zero_stage == 3
    assert set(stage3.params) == set(
        t_par.zero.stage3_param_keys(stage3.step_fn.zero_plan))
    stage3.sync_to_block()
    for n, p in net.collect_params().items():
        assert onp.array_equal(p.data().asnumpy(), want[1][n]), n
