"""The port's ``contrib.amp`` held against the JAX package on the CPU
(``with mx.cpu():`` for the port), modelled on
``tests/test_amp_fused.py:121-183``:

- the eager cast policy of each op list (the output dtype of an op of
  each list, and of the Gluon layers, which call the ops directly);
- ``convert_hybrid_block``'s parameter dtypes and ``convert_model``'s
  argument and auxiliary dtypes;
- the Trainer's dynamic loss scaler: the scale's trajectory, a planted
  overflow skipped (parameters unchanged, scale halved) and the
  parameters after 3 steps, to 1e-6 of each tensor's largest value
  (the port and the reference take the same fp32 steps; the loss
  scale is a power of two, so scaling and unscaling are exact);
- a symbolic trace under AMP carries the casts as ``amp_cast`` nodes,
  so an exported bf16 net serves the eager AMP forward bit for bit.

``amp.init`` is process-wide: a fixture turns AMP off again after each
test, in both packages.
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.contrib import amp as j_amp  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.contrib import amp as t_amp  # noqa: E402

AMP = {jmx: j_amp, tmx: t_amp}
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _host_and_amp_off():
    with tmx.cpu():
        try:
            yield
        finally:
            j_amp._off()
            t_amp._off()


def _dtype(a):
    """The dtype name of an NDArray of either package."""
    d = a._data.dtype
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _on(*pkgs):
    for pkg in pkgs:
        AMP[pkg].init("bfloat16")


POLICY_CASES = {
    # a target-list op: floating inputs to bf16
    "dot": lambda nd: nd.dot(nd.ones((4, 5)), nd.ones((5, 3))),
    "FullyConnected": lambda nd: nd.FullyConnected(
        nd.ones((2, 5)), nd.ones((3, 5)), nd.ones((3,)), num_hidden=3),
    # an fp32-list op: a bf16 input back to fp32
    "softmax": lambda nd: nd.softmax(nd.ones((2, 3)).astype("bfloat16")),
    "sum": lambda nd: nd.sum(nd.ones((2, 3)).astype("bfloat16")),
    # widest cast: bf16 beside fp32 gives fp32
    "broadcast_add": lambda nd: nd.broadcast_add(
        nd.ones((2, 3)).astype("bfloat16"), nd.ones((2, 3))),
    # not in a list: the input's dtype
    "relu": lambda nd: nd.relu(nd.ones((2, 3)).astype("bfloat16")),
    # integers are not cast
    "dot_int": lambda nd: nd.dot(nd.ones((2, 2), dtype="int32"),
                                 nd.ones((2, 2), dtype="int32")),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_eager_cast_policy_matches_the_reference(case):
    _on(jmx, tmx)
    got, want = (_dtype(POLICY_CASES[case](p.nd)) for p in (tmx, jmx))
    assert got == want


def test_gluon_layers_take_the_policy_and_amp_off_restores_fp32():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(4, in_units=8),
            tmx.gluon.nn.BatchNorm(in_channels=4))
    net.initialize()
    x = tmx.nd.ones((2, 8))
    assert _dtype(net[0](x)) == "float32"
    _on(tmx)
    assert t_amp.is_active()
    assert _dtype(net[0](x)) == "bfloat16"  # FullyConnected: the target
    assert _dtype(net(x)) == "float32"  # BatchNorm: back to fp32
    with pytest.raises(MXNetError, match="different dtype"):
        t_amp.init("float16")
    t_amp._off()
    assert _dtype(net[0](x)) == "float32"
    with pytest.raises(MXNetError, match="bfloat16 or float16"):
        t_amp.init("float8")


def _block(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="amp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(4, in_units=8),
                pkg.gluon.nn.BatchNorm(in_channels=4))
    net.initialize()
    net(pkg.nd.zeros((2, 8)))
    return net


def test_convert_hybrid_block_dtypes_match_the_reference():
    got, want = ({n: _dtype(p.data()) for n, p in AMP[pkg]
                  .convert_hybrid_block(_block(pkg), "bfloat16")
                  .collect_params().items()} for pkg in (tmx, jmx))
    assert got == want
    assert got["amp_dense0_weight"] == "bfloat16"
    assert got["amp_batchnorm0_gamma"] == "float32"


def test_convert_model_dtypes_match_the_reference():
    rs = onp.random.RandomState(0)
    arg = {"fc_weight": rs.randn(3, 4), "fc_bias": rs.randn(3),
           "bn_gamma": rs.randn(3), "bn_beta": rs.randn(3)}
    aux = {"bn_moving_mean": rs.randn(3), "bn_moving_var": rs.rand(3)}
    res = {}
    for pkg in (tmx, jmx):
        sym = pkg.sym.var("data")
        a = {k: pkg.nd.array(v.astype("float32")) for k, v in arg.items()}
        x = {k: pkg.nd.array(v.astype("float32")) for k, v in aux.items()}
        s, a2, x2 = AMP[pkg].convert_model(sym, a, x, "bfloat16")
        assert s is sym
        res[pkg] = ({k: _dtype(v) for k, v in a2.items()},
                    {k: _dtype(v) for k, v in x2.items()})
    assert res[tmx] == res[jmx]
    assert res[tmx][0]["fc_weight"] == "bfloat16"
    assert res[tmx][0]["bn_gamma"] == "float32"


def _param(net, suffix):
    return next(p for n, p in net.collect_params().items()
                if n.endswith(suffix))


def _plant_inf(pkg, param):
    g = param.data()._grad
    if pkg is jmx:
        g._adopt(g._data.at[0, 0].set(onp.inf))
    else:
        g._data[0, 0] = float("inf")


def _loss_scaled_steps(pkg, steps=4, plant_at=1):
    """``tests/test_amp_fused.py``'s Dense under the loss scaler:
    ``steps`` steps, an overflow planted at ``plant_at``; the scale
    after each step, the weights before and after the planted one, and
    the parameters at the end."""
    nn = pkg.gluon.nn
    onp.random.seed(0)
    net = nn.Dense(3, in_units=6, prefix="d_")
    net.initialize(pkg.init.Xavier())
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    amp = AMP[pkg]
    amp.init_trainer(trainer)
    rs = onp.random.RandomState(1)
    x = pkg.nd.array(rs.rand(4, 6).astype("float32"))
    y = pkg.nd.array(rs.rand(4, 3).astype("float32"))
    loss_fn = pkg.gluon.loss.L2Loss()
    w = _param(net, "weight")
    scales, skipped = [], None
    for step in range(steps):
        with pkg.autograd.record():
            with amp.scale_loss(loss_fn(net(x), y), trainer) as scaled:
                scaled.backward()
        if step == plant_at:
            _plant_inf(pkg, w)
            before = w.data().asnumpy().copy()
        trainer.step(4)
        if step == plant_at:
            skipped = (before, w.data().asnumpy().copy())
        scales.append(trainer._amp_loss_scaler.loss_scale)
    return scales, skipped, {n: p.data().asnumpy()
                             for n, p in net.collect_params().items()}


def test_trainer_loss_scaling_matches_the_reference():
    (t_scales, t_skip, t_params), (j_scales, j_skip, j_params) = (
        _loss_scaled_steps(pkg) for pkg in (tmx, jmx))
    assert t_scales == j_scales == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15,
                                    2.0 ** 15]
    onp.testing.assert_array_equal(*t_skip)  # the overflow was skipped
    onp.testing.assert_array_equal(*j_skip)
    assert sorted(t_params) == sorted(j_params)
    for n in j_params:
        scale = onp.abs(j_params[n]).max()
        assert onp.abs(t_params[n] - j_params[n]).max() <= PARAM_TOL * scale


def test_scale_window_doubles_and_unscale_divides():
    scaler = t_amp.LossScaler(init_scale=8.0, scale_window=2)
    for overflow, want in ((False, 8.0), (False, 16.0), (True, 8.0),
                           (True, 4.0), (True, 2.0), (True, 1.0),
                           (True, 1.0)):
        scaler.update_scale(overflow)
        assert scaler.loss_scale == want
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(MXNetError, match="init_trainer"):
        t_amp.unscale(trainer)
    t_amp.init_trainer(trainer)
    with tmx.autograd.record():
        with t_amp.scale_loss(net(tmx.nd.ones((1, 3))).sum(),
                              trainer) as scaled:
            scaled.backward()
    w = _param(net, "weight")
    g = w.data()._grad.asnumpy().copy()
    t_amp.unscale(trainer)
    onp.testing.assert_array_equal(w.data()._grad.asnumpy(), g / 2 ** 16)
    assert trainer._scale == trainer._amp_original_scale


def test_traced_graph_carries_the_casts_and_serves_the_eager_forward(
        tmp_path):
    net = tmx.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(tmx.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3),
                tmx.gluon.nn.BatchNorm(in_channels=4),
                tmx.gluon.nn.Activation("relu"), tmx.gluon.nn.Flatten(),
                tmx.gluon.nn.Dense(5, in_units=4 * 6 * 6))
    net.initialize(tmx.init.Xavier())
    x = onp.random.RandomState(2).randn(2, 3, 6, 6).astype("float32")
    net(tmx.nd.array(x))
    t_amp.convert_hybrid_block(net, "bfloat16")
    path = str(tmp_path / "bf16.mxje")
    _on(tmx)
    want = net(tmx.nd.array(x))._data.float().numpy()
    tmx.deploy.export_model(net, x, path)
    sym = net(tmx.sym.var("data"))
    t_amp._off()
    ops = [n.op for n in sym._topo() if n.op is not None]
    # the convolution's and the dense's three inputs, BatchNorm's data,
    # gamma and beta (its moving statistics stay as they are)
    assert ops.count("amp_cast") == 3 + 3 + 3
    meta = tmx.deploy.read_artifact_meta(path)
    assert meta["param_dtypes"] == {"bfloat16": 4, "float32": 4}
    assert meta["quantized"] is False
    got = tmx.deploy.load_exported(path, ctx=tmx.cpu()).call(x)
    assert got.dtype == torch.bfloat16
    onp.testing.assert_array_equal(got.float().numpy(), want)
