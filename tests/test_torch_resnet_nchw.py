"""The reference's default ResNet (channel-first, v1 and v2) held against
the JAX package on the CPU.

Ops: channel-first convolution (NCW, NCHW, NCDHW: stride, padding,
dilation, groups, bias, the RGB stem), pooling (max, avg, sum, lp;
global; the "full" convention; ``count_include_pad``), BatchNorm on
axis 1 in training (the custom backward) and inference, and the
activations, each on the same seeded numpy inputs in both packages,
forward and gradients (a seeded cotangent through ``jax.vjp`` and
``torch.autograd``), to 1e-5 of the largest magnitude (the packages
sum in other orders).

Nets: a tiny ResNetV1 (BottleneckV1, the zoo's biases on the two 1x1
body convs) and a tiny ResNetV2 (BottleneckV2), one block per stage,
widths 8..128, 10 classes, 32x32 inputs, built NCHW in both packages
with the same parameter names; the JAX package's initialized weights
(BatchNorm affine, statistics and the conv biases made non-trivial)
carry across with ``load_jax_params``.  Both ``make_train_step``s run
three steps on one fixed batch: fp32 through the sharded-bucket arm
(the bucket kernel forced: the JAX Pallas kernel in interpret mode, the
port's plain version on the CPU) and the replicated arm, to 1e-4 of
each tensor's largest magnitude; bf16 compute held against the
reference compiled to round every op to bf16, by update cosines that
the port's own fp32 step is checked to fail, as
``tests/test_torch_resnet_train.py`` states it.  A ``.params`` file
that the JAX package writes loads into the port and gives the same
logits to 1e-5, and the full-width ``resnet50_v1``/``resnet50_v2`` have
the reference's parameter names and shapes.
"""
import math

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import initializer as j_init  # noqa: E402
from mxnet_tpu import nd  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as j_vision  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res  # noqa: E402
from mxnet_tpu.ops import conv as j_conv  # noqa: E402
from mxnet_tpu.ops import nn as j_ops_nn  # noqa: E402

from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon import loss as t_loss  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as t_vision  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res  # noqa: E402
from mxnet_tpu_torch.ops import conv as t_conv  # noqa: E402
from mxnet_tpu_torch.ops import nn as t_ops_nn  # noqa: E402

OP_TOL = 1e-5


def _close(got, want, tol=OP_TOL):
    got = onp.asarray(got, dtype=onp.float64)
    want = onp.asarray(want, dtype=onp.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(onp.abs(want).max())) if want.size else 1.0
    err = float(onp.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def _vjp_both(j_fn, t_fn, inputs, seed):
    """(outputs, gradients) of ``j_fn`` and ``t_fn`` on the numpy
    ``inputs`` under one seeded cotangent; ``*_fn`` take and return
    arrays of their framework (one output)."""
    j_out, j_pull = jax.vjp(j_fn, *(jnp.asarray(a) for a in inputs))
    ct = onp.random.RandomState(seed).randn(*j_out.shape).astype("float32")
    j_grads = j_pull(jnp.asarray(ct))
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    t_out = t_fn(*leaves)
    t_grads = torch.autograd.grad(t_out, leaves, torch.from_numpy(ct))
    return ((onp.asarray(j_out), t_out.detach().numpy()),
            [(onp.asarray(a), b.numpy()) for a, b in zip(j_grads, t_grads)])


# ------------------------------------------------------------ convolution
# (layout, data shape, kernel, stride, pad, dilate, groups, num_filter,
# bias)
_CONV_CASES = {
    "nchw_3x3": ("NCHW", (2, 4, 9, 11), (3, 3), (1, 1), (1, 1), (1, 1), 1,
                 6, True),
    "nchw_stride_pad": ("NCHW", (2, 4, 10, 9), (3, 2), (2, 3), (1, 2),
                        (1, 1), 1, 5, False),
    "nchw_dilate": ("NCHW", (1, 3, 12, 12), (3, 3), (1, 1), (2, 2), (2, 2),
                    1, 4, True),
    "nchw_groups": ("NCHW", (2, 6, 8, 8), (3, 3), (1, 1), (1, 1), (1, 1), 3,
                    9, True),
    "nchw_depthwise": ("NCHW", (2, 4, 7, 7), (3, 3), (2, 2), (1, 1), (1, 1),
                       4, 4, False),
    # the RGB stem (the reference's space-to-depth arm)
    "nchw_stem": ("NCHW", (2, 3, 16, 16), (7, 7), (2, 2), (3, 3), (1, 1), 1,
                  8, False),
    "nchw_1x1_stride": ("NCHW", (2, 8, 9, 9), (1, 1), (2, 2), (0, 0), (1, 1),
                        1, 16, True),
    "ncw": ("NCW", (2, 4, 13), (3,), (2,), (1,), (2,), 2, 6, True),
    "ncdhw": ("NCDHW", (1, 2, 5, 6, 7), (3, 3, 2), (1, 2, 1), (1, 1, 0),
              (1, 1, 1), 1, 3, True),
    "default_layout": (None, (1, 3, 6, 6), (3, 3), (1, 1), (0, 0), (1, 1), 1,
                       2, True),
    "nhwc_groups": ("NHWC", (2, 8, 8, 6), (3, 3), (1, 1), (1, 1), (1, 1), 3,
                    9, True),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_convolution_matches_reference(case):
    layout, shape, kernel, stride, pad, dilate, groups, nf, bias = \
        _CONV_CASES[case]
    rng = onp.random.RandomState(len(case))
    nd_ = len(kernel)
    cl = layout is not None and layout[-1] == "C"
    cin = shape[-1] if cl else shape[1]
    wshape = ((nf,) + kernel + (cin // groups,) if cl
              else (nf, cin // groups) + kernel)
    inputs = [rng.randn(*shape).astype("float32"),
              (rng.randn(*wshape) * 0.3).astype("float32")]
    if bias:
        inputs.append(rng.randn(nf).astype("float32"))
    kw = dict(kernel=kernel, num_filter=nf, stride=stride, pad=pad,
              dilate=dilate, num_group=groups, no_bias=not bias,
              layout=layout)
    outs, grads = _vjp_both(
        lambda *a: j_conv.convolution(*a, **kw),
        lambda *a: t_conv.convolution(*a, **kw), inputs, seed=nd_)
    _close(outs[1], outs[0])
    for want, got in grads:
        _close(got, want)


def test_convolution_refuses_bad_layouts():
    x = torch.zeros(1, 3, 8, 8)
    w = torch.zeros(4, 3, 3, 3)
    with pytest.raises(MXNetError, match="layout"):
        t_conv.convolution(x, w, kernel=(3, 3), num_filter=4,
                           layout="NCDHW")
    with pytest.raises(MXNetError, match="layout"):
        t_conv.convolution(x, w, kernel=(3, 3), num_filter=4, layout="HWCN")
    with pytest.raises(MXNetError, match="num_filter"):
        t_conv.convolution(x, w, kernel=(3, 3), num_filter=5)


# ---------------------------------------------------------------- pooling
# (layout, data shape, kwargs)
_POOL_CASES = {
    "max_3x3_s2_p1": ("NCHW", (2, 3, 11, 11),
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "avg_2x2": ("NCHW", (2, 3, 8, 10), dict(kernel=(2, 2), stride=(2, 2),
                                            pool_type="avg")),
    "avg_pad": ("NCHW", (2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                           pad=(1, 1), pool_type="avg")),
    "avg_pad_exclude": ("NCHW", (2, 3, 9, 9), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "max_full": ("NCHW", (2, 3, 10, 12), dict(
        kernel=(3, 3), stride=(2, 2), pooling_convention="full")),
    "avg_full": ("NCHW", (2, 3, 10, 12), dict(
        kernel=(3, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full")),
    "avg_full_exclude": ("NCHW", (1, 2, 10, 7), dict(
        kernel=(3, 2), stride=(2, 2), pad=(1, 0), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "max_wide_pad": ("NCHW", (1, 2, 6, 6), dict(kernel=(2, 2),
                                                stride=(1, 1), pad=(1, 1))),
    "sum": ("NCHW", (2, 3, 8, 8), dict(kernel=(3, 3), stride=(1, 1),
                                       pool_type="sum")),
    "lp": ("NCHW", (2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2),
                                      pool_type="lp", p_value=2)),
    "global_avg": ("NCHW", (2, 5, 7, 7), dict(global_pool=True,
                                              pool_type="avg")),
    "global_max": ("NCHW", (2, 5, 7, 6), dict(global_pool=True)),
    "global_sum": ("NCHW", (2, 5, 4, 4), dict(global_pool=True,
                                              pool_type="sum")),
    "ncw_max": ("NCW", (2, 3, 15), dict(kernel=(3,), stride=(2,),
                                        pad=(1,))),
    "ncdhw_avg_full": ("NCDHW", (1, 2, 5, 6, 7), dict(
        kernel=(2, 2, 2), stride=(2, 2, 2), pool_type="avg",
        pooling_convention="full")),
    "default_layout_max": (None, (1, 2, 7, 7), dict(kernel=(3, 3),
                                                    stride=(2, 2))),
    "nhwc_max_full": ("NHWC", (2, 10, 12, 3), dict(
        kernel=(3, 3), stride=(2, 2), pooling_convention="full")),
    "nhwc_global_avg": ("NHWC", (2, 7, 7, 5), dict(global_pool=True,
                                                   pool_type="avg")),
}


@pytest.mark.parametrize("case", sorted(_POOL_CASES))
def test_pooling_matches_reference(case):
    layout, shape, kw = _POOL_CASES[case]
    kw = dict(kw, layout=layout)
    rng = onp.random.RandomState(len(case) + 1)
    # distinct values, so that every max is one element
    x = rng.permutation(math.prod(shape)).reshape(shape).astype("float32")
    x = (x / x.size - 0.5).astype("float32")
    outs, grads = _vjp_both(lambda a: j_conv.pooling(a, **kw),
                            lambda a: t_conv.pooling(a, **kw), [x], seed=2)
    _close(outs[1], outs[0])
    _close(grads[0][1], grads[0][0])


def test_pooling_refuses_unknown_settings():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(MXNetError, match="pool_type"):
        t_conv.pooling(x, kernel=(2, 2), pool_type="median")
    with pytest.raises(MXNetError, match="pooling_convention"):
        t_conv.pooling(x, kernel=(2, 2), pooling_convention="same")


# -------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (6, 4), (2, 3, 4, 2, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_axis1_train_matches_reference(shape, fix_gamma):
    """Training BatchNorm on axis 1: the output and the batch statistics,
    and the custom backward's gradients of data, gamma and beta."""
    rng = onp.random.RandomState(len(shape))
    c = shape[1]
    x = (rng.randn(*shape) * 2 + 0.5).astype("float32")
    gamma = (rng.rand(c) + 0.5).astype("float32")
    beta = rng.randn(c).astype("float32")
    stats = (onp.zeros(c, "float32"), onp.ones(c, "float32"))
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, axis=1, train=True,
              output_mean_var=True)

    def j_fn(a, g, b):
        return j_ops_nn.batch_norm(a, g, b, *map(jnp.asarray, stats),
                                   **kw)[0]

    def t_fn(a, g, b):
        return t_ops_nn.batch_norm(a, g, b, *map(torch.from_numpy, stats),
                                   **kw)[0]

    outs, grads = _vjp_both(j_fn, t_fn, [x, gamma, beta], seed=c)
    _close(outs[1], outs[0])
    for want, got in grads:
        _close(got, want)
    j_all = j_ops_nn.batch_norm(*map(jnp.asarray, (x, gamma, beta) + stats),
                                **kw)
    t_all = t_ops_nn.batch_norm(*map(torch.from_numpy,
                                     (x, gamma, beta) + stats), **kw)
    for want, got in zip(j_all[1:], t_all[1:]):
        _close(got.numpy(), onp.asarray(want))


def test_batchnorm_axis1_inference_matches_reference():
    rng = onp.random.RandomState(3)
    x = rng.randn(3, 4, 5, 5).astype("float32")
    args = [x, (rng.rand(4) + 0.5).astype("float32"),
            rng.randn(4).astype("float32"), rng.randn(4).astype("float32"),
            (rng.rand(4) + 0.5).astype("float32")]
    kw = dict(eps=1e-3, fix_gamma=False, axis=1)
    want = j_ops_nn.batch_norm(*map(jnp.asarray, args), **kw)
    got = t_ops_nn.batch_norm(*map(torch.from_numpy, args), **kw)
    _close(got.numpy(), onp.asarray(want))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_reference(act):
    x = onp.random.RandomState(4).randn(3, 4, 5).astype("float32") * 3
    outs, grads = _vjp_both(
        lambda a: j_ops_nn.activation(a, act_type=act),
        lambda a: t_ops_nn.activation(a, act_type=act), [x], seed=5)
    _close(outs[1], outs[0])
    _close(grads[0][1], grads[0][0])


def test_nchw_layers_default_to_channel_first():
    """Under the default layout a layer is channel-first: OIHW weights,
    BatchNorm on axis 1, and Flatten then Dense over (N, C)."""
    conv = t_nn.Conv2D(6, 3, in_channels=4)
    bn = t_nn.BatchNorm(in_channels=6)
    assert conv.weight.shape == (6, 4, 3, 3)
    assert bn._kwargs["axis"] == 1
    with t_nn.default_layout("NHWC"):
        assert t_nn.Conv2D(6, 3, in_channels=4).weight.shape == (6, 3, 3, 4)
        assert t_nn.BatchNorm(in_channels=6)._kwargs["axis"] == -1
    seq = t_nn.HybridSequential()
    seq.add(conv, bn, t_nn.Activation("relu"), t_nn.GlobalAvgPool2D(),
            t_nn.Flatten(), t_nn.Dense(3, in_units=6))
    seq.initialize(device="cpu")
    assert seq(torch.zeros(2, 4, 7, 7)).shape == (2, 3)


# ------------------------------------------------------------ tiny nets
CHANNELS = [8, 16, 32, 64, 128]
NETS = {
    "v1": (j_res.ResNetV1, t_res.ResNetV1, "BottleneckV1", "resnetv10_"),
    "v2": (j_res.ResNetV2, t_res.ResNetV2, "BottleneckV2", "resnetv20_"),
}
#: small enough that the tiny net spans several buckets
BUCKET_BOUND = 30000


def _port_net(version):
    _, t_cls, block, prefix = NETS[version]
    return t_cls(getattr(t_res, block), [1, 1, 1, 1], CHANNELS, classes=10,
                 prefix=prefix)


def _jax_net(version):
    j_cls, _, block, prefix = NETS[version]
    mx.random.seed(0)
    onp.random.seed(0)
    net = j_cls(getattr(j_res, block), [1, 1, 1, 1], CHANNELS, classes=10,
                prefix=prefix)
    net.initialize(j_init.Xavier())
    net(nd.array(onp.zeros((1, 3, 32, 32), "float32")))  # deferred shapes
    rng = onp.random.RandomState(5)
    for name, p in net.collect_params().items():
        # non-trivial BN affine and statistics and conv biases, so every
        # term matters
        if name.endswith(("gamma", "running_var")):
            p.set_data(nd.array(rng.rand(*p.shape).astype("float32") + 0.5))
        elif name.endswith(("beta", "running_mean", "bias")):
            p.set_data(nd.array(rng.randn(*p.shape).astype("float32") * 0.1))
    return net


@pytest.fixture(scope="module")
def jax_nets():
    return {v: _jax_net(v) for v in NETS}


@pytest.fixture(scope="module")
def weights(jax_nets):
    return {v: {n: onp.asarray(p.data().asnumpy())
                for n, p in net.collect_params().items()}
            for v, net in jax_nets.items()}


def _loaded_port_net(version, weights):
    net = _port_net(version)
    net.initialize(device="cpu")
    t_par.load_jax_params(net, weights[version])
    return net


@pytest.mark.parametrize("version", sorted(NETS))
def test_tiny_net_names_shapes_and_logits(jax_nets, weights, version):
    """The same names, shapes and order as the reference; the carried
    weights give the reference's logits in inference and in training
    mode (batch statistics)."""
    net = _loaded_port_net(version, weights)
    got = {n: p.shape for n, p in net.collect_params().items()}
    assert list(got) == list(weights[version])
    assert got == {n: a.shape for n, a in weights[version].items()}
    if version == "v1":  # the zoo's biases on the two 1x1 body convs
        assert sum(n.endswith("_bias") for n in got) == 2 * 4 + 1
    x = onp.random.RandomState(1).randn(2, 3, 32, 32).astype("float32")
    want = onp.asarray(jax_nets[version](nd.array(x)).asnumpy())
    _close(net(torch.from_numpy(x)).detach().numpy(), want)
    # a training-mode forward folds the batch statistics into the
    # running averages: a fresh copy keeps the shared net as it is
    with mx.autograd.record(train_mode=True):
        want_train = _jax_net(version)(nd.array(x)).asnumpy()
    net.train()
    try:
        got_train = net(torch.from_numpy(x)).detach().numpy()
    finally:
        net.train(False)
    _close(got_train, want_train, tol=1e-4)


CASES = {
    "ps_fp32": dict(sharded=True, compute_dtype=None),
    "ps_bf16": dict(sharded=True, compute_dtype="bfloat16"),
    "replicated_fp32": dict(sharded=False, compute_dtype=None),
}
STEPS = 3
FP32_TOL = 1e-4
BF16_XLA_OPTIONS = {"xla_allow_excess_precision": False}


def _batch():
    rng = onp.random.RandomState(11)
    x = rng.randn(8, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, 8).astype("float32")
    return x, y


def _kwargs(case):
    kw = dict(learning_rate=0.1, momentum=0.9, loss_scale="dynamic",
              compute_dtype=case["compute_dtype"], donate=False,
              bucket_bound=BUCKET_BOUND)
    if case["sharded"]:
        kw["optimizer_sharding"] = "ps"
    return kw


def _run_jax(net, case):
    """(losses, params after the last step, opt_state, bucket names,
    params after the first step)."""
    x, y = _batch()
    kw = _kwargs(case)
    if case["sharded"]:
        kw["mesh"] = jax.sharding.Mesh(onp.array(jax.devices()[:1]),
                                       ("data",))
    losses, first = [], None
    with j_at.force(pallas_bnreluconv="pallas", fused_bucket_opt="pallas"):
        step, p, s = j_par.make_train_step(
            net, j_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", **kw)
        run = step
        for i in range(STEPS):
            args = (p, s, x, y, jax.random.key(0), float(i + 1))
            if case["compute_dtype"] is not None and i == 0:
                run = step.lower(*args).compile(BF16_XLA_OPTIONS)
            loss, p, s = run(*args)
            losses.append(float(loss))
            if i == 0:
                first = {n: onp.asarray(v) for n, v in p.items()}
    plan = [b.names for b in getattr(step, "zero_plan", [])]
    return (losses, {n: onp.asarray(v) for n, v in p.items()}, s, plan,
            first)


def _run_port(version, weights, case):
    x, y = _batch()
    net = _loaded_port_net(version, weights)
    kw = _kwargs(case)
    if case["sharded"]:
        kw["mesh"] = t_par.get_mesh(devices=["cpu"])
    else:
        kw["device"] = "cpu"
    losses, first = [], None
    with t_at.force(pallas_bnreluconv="pallas", fused_bucket_opt="pallas"):
        step, p, s = t_par.make_train_step(
            net, t_loss.SoftmaxCrossEntropyLoss(), "sgd", **kw)
        for i in range(STEPS):
            loss, p, s = step(p, s, torch.from_numpy(x),
                              torch.from_numpy(y), None, float(i + 1))
            losses.append(float(loss))
            if i == 0:
                first = {n: v.numpy().copy() for n, v in p.items()}
    plan = [b.names for b in getattr(step, "zero_plan", [])]
    return (losses, {n: v.numpy() for n, v in p.items()}, s, plan,
            first)


@pytest.fixture(scope="module")
def runs(jax_nets, weights):
    """``runs(package, version, case)``, each computed once."""
    done = {}

    def get(pkg, version, case):
        key = (pkg, version, case)
        if key not in done:
            if pkg == "jax":
                done[key] = _run_jax(jax_nets[version], CASES[case])
            else:
                done[key] = _run_port(version, weights, CASES[case])
        return done[key]

    return get


def _is_stat(name):
    return name.endswith(("running_mean", "running_var"))


def _check_state(t_run, j_run, weights, sharded):
    t_losses, t_params, t_state, t_plan, _ = t_run
    j_losses, j_params, j_state, j_plan, _ = j_run
    assert t_plan == j_plan
    if sharded:
        assert len(t_plan) > 1
    assert sorted(t_params) == sorted(j_params)
    for n in j_params:
        if _is_stat(n):
            # a step leaves running statistics unchanged, in both
            assert onp.array_equal(j_params[n], weights[n]), n
            assert onp.array_equal(t_params[n], weights[n]), n
    j_scale, j_good = j_state["_loss_scale"]
    t_scale, t_good = t_state["_loss_scale"]
    assert float(t_scale) == float(j_scale) == 2.0 ** 16
    assert int(t_good) == int(j_good) == STEPS
    assert t_losses[-1] < t_losses[0]


@pytest.mark.parametrize("case", ["ps_fp32", "replicated_fp32"])
@pytest.mark.parametrize("version", sorted(NETS))
def test_fp32_train_steps_match_reference(runs, weights, version, case):
    t_run, j_run = runs("port", version, case), runs("jax", version, case)
    _check_state(t_run, j_run, weights[version], CASES[case]["sharded"])
    assert onp.allclose(t_run[0], j_run[0], rtol=FP32_TOL, atol=0), \
        (t_run[0], j_run[0])
    for n, want in j_run[1].items():
        err = onp.abs(t_run[1][n] - want).max() / (onp.abs(want).max()
                                                   + 1e-12)
        assert err <= FP32_TOL, (n, err)


def _update(params, weights, names):
    return onp.concatenate([(params[n].astype(onp.float64) - weights[n])
                            .ravel() for n in names])


def _cos(a, b):
    return float(a @ b / (onp.linalg.norm(a) * onp.linalg.norm(b)))


#: limits of the bf16 comparison, per net; readings of the port's bf16
#: step against the reference's, then of the port's fp32 step (the
#: control), in brackets.  The reference's own bf16 update has a cosine
#: of 0.934 (v1) and 0.915 (v2) with its fp32 update after one step,
#: 0.801 and 0.887 after three: the port's bf16 update must be closer to
#: the reference's than that, and closer to it than to the reference's
#: fp32 update.  v2 starts with a BatchNorm of the bf16 image, whose
#: statistics sum 8,192 values a channel in another order in each
#: package, so its bf16 runs part sooner (first loss 0.26 % apart; v1's
#: are equal)
BF16_LIMITS = {
    # leaf_cos_1: the worst parameter's step-1 update cosine (0.99999;
    # 0.763); cos_1: all parameters' (0.99999; 0.934); margin_1: less
    # that with the reference's fp32 update (0.066; -0.066); cos_3 and
    # margin_3 after three steps (0.988 and 0.179; 0.801 and -0.199)
    "v1": dict(leaf_cos_1=0.99, cos_1=0.99, margin_1=0.03, cos_3=0.95,
               margin_3=0.1),
    # (0.880; 0.776), (0.951; 0.915), (0.054; -0.085), (0.925 and 0.060;
    # 0.887 and -0.113)
    "v2": dict(leaf_cos_1=0.85, cos_1=0.93, margin_1=0.02, cos_3=0.905,
               margin_3=0.02),
}


#: a parameter whose fp32 step-1 update is below this share of the whole
#: update's norm is left out of the per-parameter cosine: rounding
#: decides its direction.  The conv biases that a BatchNorm follows
#: (v1's zoo biases: a gradient of exactly 0, updates 1e-10 to 3e-8 of
#: the whole from summation noise), the gamma of v2's input BatchNorm
#: (no scale: gradient 0) and that of its stem BatchNorm (7.6e-5)
LEAF_MIN_SHARE = 1e-3


def _bf16_readings(run, j_bf16, j_fp32, weights):
    names = [n for n in sorted(weights) if not _is_stat(n)]
    got = {}
    for step, k in ((1, 4), (3, 1)):
        u = _update(run[k], weights, names)
        u_b = _update(j_bf16[k], weights, names)
        u_f = _update(j_fp32[k], weights, names)
        got[f"cos_{step}"] = _cos(u, u_b)
        got[f"margin_{step}"] = _cos(u, u_b) - _cos(u, u_f)
    whole = onp.linalg.norm(_update(j_fp32[4], weights, names))
    leaves = [n for n in names if onp.linalg.norm(
        _update(j_fp32[4], weights, [n])) >= LEAF_MIN_SHARE * whole]
    got["leaf_cos_1"] = min(
        _cos(_update(run[4], weights, [n]), _update(j_bf16[4], weights, [n]))
        for n in leaves)
    return got


@pytest.mark.parametrize("version", sorted(NETS))
def test_bf16_train_steps_track_reference(runs, weights, version):
    """bf16 compute cannot match element by element (other summation
    orders, one bf16 rounding apart flips later ones): the port's update
    must point with the reference's bf16 update (compiled to round every
    op to bf16, ``BF16_XLA_OPTIONS``), per parameter (``LEAF_MIN_SHARE``)
    and as a whole, and closer to it than to the reference's fp32
    update, within ``BF16_LIMITS``; the port's fp32 step misses every
    limit.  The first loss is held within 0.5%."""
    t_run = runs("port", version, "ps_bf16")
    j_run = runs("jax", version, "ps_bf16")
    j_fp32 = runs("jax", version, "ps_fp32")
    w = weights[version]
    limits = BF16_LIMITS[version]
    _check_state(t_run, j_run, w, True)
    assert abs(t_run[0][0] - j_run[0][0]) <= 0.005 * j_run[0][0], \
        (t_run[0], j_run[0])
    got = _bf16_readings(t_run, j_run, j_fp32, w)
    assert {k: v for k, v in got.items() if v < limits[k]} == {}, got
    control = _bf16_readings(runs("port", version, "ps_fp32"), j_run,
                             j_fp32, w)
    assert sorted(k for k in limits if control[k] < limits[k]) == \
        sorted(limits), control


# ----------------------------------------------------- .params both ways
@pytest.mark.parametrize("keys", ["structural", "full_names"])
def test_params_file_from_reference_loads_into_port(jax_nets, tmp_path,
                                                    keys):
    """A ``.params`` file the JAX package writes (``save_parameters``:
    structural keys; ``collect_params().save``: full names) loads into
    the port's v2 net by ``load_parameters`` and gives the same logits
    to 1e-5; a wrong file raises."""
    j_net = jax_nets["v2"]
    path = str(tmp_path / "v2.params")
    if keys == "structural":
        j_net.save_parameters(path)
    else:
        j_net.collect_params().save(path)
    net = _port_net("v2")
    net.initialize(device="cpu")
    net.load_parameters(path)
    x = onp.random.RandomState(2).randn(2, 3, 32, 32).astype("float32")
    want = onp.asarray(j_net(nd.array(x)).asnumpy())
    _close(net(torch.from_numpy(x)).detach().numpy(), want)
    with pytest.raises(MXNetError, match="missing|not present"):
        _port_net("v1").load_parameters(path)


# --------------------------------------------------- full width, by name
@pytest.mark.parametrize("name", ["resnet50_v1", "resnet50_v2"])
def test_full_width_names_and_shapes_match_reference(name):
    """``get_model`` at the zoo's default (NCHW, the zoo's biases): the
    reference's parameter names, order and shapes."""
    j_net = j_vision.get_model(name)
    j_net.initialize(j_init.Xavier())
    j_net(nd.array(onp.zeros((1, 3, 32, 32), "float32")))
    want = [(n, tuple(p.shape)) for n, p in j_net.collect_params().items()]
    t_net = t_vision.get_model(name)
    got = [(n, tuple(p.shape)) for n, p in t_net.collect_params().items()]
    assert got == want
    t_net.initialize(device="cpu")
    out = t_net(torch.zeros(1, 3, 32, 32))
    assert out.shape == (1, 1000)


def test_get_model_names():
    for v in (1, 2):
        for n in (18, 34, 50, 101, 152):
            net = t_vision.get_model(f"ResNet{n}_v{v}")
            assert type(net).__name__ == f"ResNetV{v}"
    # the detection ops are ported: the SSD names build
    assert type(t_vision.get_model("ssd_300_vgg16_reduced")).__name__ == \
        "SSD"
    with pytest.raises(MXNetError, match="not supported"):
        t_vision.get_model("ssd_300_vgg16_unknown")
    with pytest.raises(MXNetError, match="version"):
        t_res.get_resnet(3, 50)
