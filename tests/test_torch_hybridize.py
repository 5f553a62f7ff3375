"""``HybridBlock.hybridize`` of the port on the CPU: the cache (one
entry per signature), what clears it, deferred shapes, hooks, and the
hybridized results held against the JAX package's hybridized ones.

The weights cross from the reference with ``.params`` files; inputs are
numpy, from a seed.  Tolerances: the reference's own hybridize tests'
(``tests/test_gluon.py:69-100``), outputs rtol 1e-5 / atol 1e-6 and
gradients rtol 1e-4 / atol 1e-5; the port's hybridized call against its
eager one bit for bit (off the card every entry runs op by op, the
static flags included); the ResNet-18 step as ``tests/test_torch_zoo.py``
holds the zoo's steps (1e-5 forward, 1e-4 of each parameter's largest
magnitude after the step).  The CUDA-graph capture runs only on a card
(``tests/test_torch_cuda.py``).
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autograd as j_ag  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as t_ag  # noqa: E402
from mxnet_tpu_torch import gluon as t_gluon  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FWD_TOL = 1e-5
STEP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    """The port's default context is the card: these tests run on the
    host."""
    with tmx.cpu():
        yield


def _mlp(pkg, act, prefix):
    nn = j_nn if pkg is jmx else t_nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation=act), nn.Dense(4 if act == "relu"
                                                       else 1))
    return net


def _twin(act, x, tmp_path, prefix="mlp_"):
    """The reference's MLP (deferred widths, its initializer) and the
    port's, the reference's weights loaded into it."""
    jnet = _mlp(jmx, act, prefix)
    jnet.initialize(init=jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    f = str(tmp_path / "w.params")
    jnet.save_parameters(f)
    tnet = _mlp(tmx, act, prefix)
    tnet.initialize()
    tnet.load_parameters(f)
    return jnet, tnet


def _grads(pkg, net, x, hybridize):
    ag = j_ag if pkg is jmx else t_ag
    gl = j_gluon if pkg is jmx else t_gluon
    if hybridize:
        net.hybridize()
    xs = pkg.nd.array(x)
    with ag.record():
        loss = gl.loss.L2Loss()(net(xs), pkg.nd.zeros((x.shape[0], 1)))
    loss.backward()
    return [p.grad().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("case", ["outputs", "gradients"])
def test_hybridize_parity(case, tmp_path):
    """The reference's ``test_hybridize_parity`` and
    ``test_hybridize_grad_parity``: eager and hybridized agree in each
    package, and the port's hybridized net agrees with the reference's
    hybridized one."""
    rng = onp.random.RandomState(7)
    if case == "outputs":
        x = rng.rand(5, 10).astype("float32")
        jnet, tnet = _twin("relu", x, tmp_path)
        want = [jnet(jmx.nd.array(x)).asnumpy()]
        jnet.hybridize()
        want.append(jnet(jmx.nd.array(x)).asnumpy())
        got = [tnet(tmx.nd.array(x)).asnumpy()]
        tnet.hybridize()
        got.append(tnet(tmx.nd.array(x)).asnumpy())
        onp.testing.assert_array_equal(got[1], got[0])
        for a, b in ((want[0], want[1]), (got[1], want[1])):
            onp.testing.assert_allclose(a, b, rtol=OUT_RTOL, atol=OUT_ATOL)
        return
    x = rng.rand(6, 5).astype("float32")
    jnet, tnet = _twin("tanh", x, tmp_path)
    t_eager = _grads(tmx, tnet, x, False)
    j_eager = _grads(jmx, jnet, x, False)
    t_hyb = _grads(tmx, tnet, x, True)
    j_hyb = _grads(jmx, jnet, x, True)
    for a, b in zip(t_hyb, t_eager):
        onp.testing.assert_array_equal(a, b)
    for pairs in (zip(j_eager, j_hyb), zip(t_hyb, j_hyb)):
        for a, b in pairs:
            onp.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                        atol=GRAD_ATOL)


def _net(prefix="n_"):
    onp.random.seed(0)  # the initializer's draws
    net = t_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(t_nn.Dense(8, in_units=6, activation="relu"),
                t_nn.BatchNorm(in_channels=8), t_nn.Dense(3, in_units=8))
    net.initialize(tmx.init.Xavier())
    return net


def _x(n=4, seed=0, dtype="float32"):
    return tmx.nd.array(onp.random.RandomState(seed).randn(n, 6)
                        .astype("float32"), dtype=dtype)


@pytest.mark.parametrize("flags", [{}, {"static_alloc": True,
                                        "static_shape": True}])
def test_hybridized_equals_eager_bit_for_bit(flags):
    """Predicting, training and the gradients of a hybridized net equal
    the eager net's bit for bit; on the host the static flags run the
    cached program op by op."""
    res = {}
    for hyb in (False, True):
        net = _net()
        if hyb:
            net.hybridize(**flags)
        x = _x()
        pred = net(x)._data.clone()
        with t_ag.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        res[hyb] = [pred, out._data.detach().clone()] + [
            p.data()._data.clone() for p in net.collect_params().values()
        ] + [p.grad()._data.clone() for p in net.collect_params().values()
             if p.grad_req != "null"]
        if hyb:
            assert all(not e.graphed for e in net._cached_op.values())
    for a, b in zip(res[True], res[False]):
        assert torch.equal(a, b)


def test_one_entry_per_signature():
    """A new shape, a new dtype, the other training mode or a recording
    call each make an entry; a repeated signature reuses its entry."""
    net = _net()
    net.hybridize()
    net(_x())
    net(_x(seed=1))
    assert len(net._cached_op) == 1
    assert list(net._cached_op.values())[0].calls == 2
    net(_x(n=5))
    assert len(net._cached_op) == 2
    net.cast("float64")
    net(_x(dtype="float64"))
    assert len(net._cached_op) == 1
    net(_x(dtype="float32").astype("float64"))
    with t_ag.train_mode():
        net(_x(dtype="float64"))
    assert len(net._cached_op) == 2
    with t_ag.record():
        net(_x(dtype="float64"))
    assert len(net._cached_op) == 3
    sigs = list(net._cached_op)
    assert [s[2:] for s in sigs] == [(False, False), (True, False),
                                     (True, True)]


@pytest.mark.parametrize("how", ["cast", "setattr", "load_parameters",
                                 "hybridize", "force_reinit"])
def test_cache_is_cleared(how, tmp_path):
    """``cast``, a child's ``__setattr__``, ``load_parameters``,
    ``hybridize`` and ``initialize(force_reinit=True)`` clear the
    cache."""
    net = _net()
    net.hybridize()
    net(_x())
    assert len(net._cached_op) == 1
    if how == "cast":
        net.cast("float64")
    elif how == "setattr":
        net.extra = t_nn.Dense(2, in_units=3)
    elif how == "load_parameters":
        f = str(tmp_path / "n.params")
        net.save_parameters(f)
        net.load_parameters(f)
    elif how == "hybridize":
        net.hybridize()
    else:
        net.initialize(tmx.init.Xavier(), force_reinit=True)
    assert len(net._cached_op) == 0


def test_set_data_writes_in_place_and_keeps_the_entry():
    """``set_data`` (another dtype included: the value is cast to the
    parameter's) writes the tensor in place: the entry stays, and its
    next call reads the new value."""
    net = _net()
    net.hybridize()
    net(_x())
    entry = list(net._cached_op.values())[0]
    w = net[2]._reg_params["weight"]
    t = w._tensor()
    w.set_data(tmx.nd.zeros((3, 8), dtype="float64"))
    assert w._tensor() is t and w.dtype == "float32"
    out = net(_x())
    assert list(net._cached_op.values()) == [entry] and entry.calls == 2
    assert torch.equal(out._data, net[2].bias.expand(4, 3))


def test_replaced_tensor_drops_the_entry_of_an_ancestor():
    """A parameter tensor replaced under a child clears the child's
    cache; an ancestor's captured entry, which reads tensors by address,
    is no longer valid and is dropped at its next call (a new tensor
    registered, as ``cast`` or a move to another device registers one,
    and a new ``.data``, as ``.to()`` sets)."""
    from mxnet_tpu_torch.gluon import block as blk

    net = _net()
    net.hybridize()
    net(_x())
    net[2].hybridize()
    net[2](tmx.nd.zeros((2, 8)))
    assert len(net[2]._cached_op) == 1
    sig = list(net._cached_op)[0]
    for replace in ("register", "data"):
        planted = blk._GraphEntry(net, False)  # captures on first call
        assert planted.valid(net)
        w = net[2]._reg_params["weight"]
        if replace == "register":
            w._register(torch.zeros(3, 8))
            assert len(net[2]._cached_op) == 0
        else:
            w._tensor().data = w._tensor().data.clone()
        assert not planted.valid(net)
        net._cached_op[sig] = planted
        out = net(_x())
        assert net._cached_op[sig] is not planted
        assert not net._cached_op[sig].graphed
        assert torch.equal(out._data, net[2].bias.expand(4, 3))


_LEAVES = {"dense": (lambda nn: nn.Dense(5, prefix="leaf_"), (2, 6)),
           "conv2d": (lambda nn: nn.Conv2D(4, 3, prefix="leaf_"),
                      (2, 3, 8, 8)),
           "batchnorm": (lambda nn: nn.BatchNorm(prefix="leaf_"),
                         (2, 3, 8, 8))}


@pytest.mark.parametrize("flags", [{}, {"static_alloc": True,
                                        "static_shape": True}],
                         ids=["plain", "static"])
@pytest.mark.parametrize("leaf", sorted(_LEAVES))
def test_hybridized_deferred_leaf_matches_reference(leaf, flags):
    """A leaf with a deferred width of its own, hybridized and called
    directly, resolves it at its first call and predicts and trains as
    the reference's hybridized leaf from the same initializer draws: the
    prediction, the recorded output, every parameter after the recorded
    call (BatchNorm's running statistics move) and the gradients."""
    make, shape = _LEAVES[leaf]
    x = onp.random.RandomState(11).randn(*shape).astype("float32")
    res = {}
    for pkg, nn, ag in ((jmx, j_nn, j_ag), (tmx, t_nn, t_ag)):
        net = make(nn)
        net.initialize(pkg.init.Xavier())
        net.hybridize(**flags)
        onp.random.seed(0)  # the deferred draws, at the first call
        pred = net(pkg.nd.array(x)).asnumpy()
        with ag.record():
            out = net(pkg.nd.array(x))
            loss = (out * out).sum()
        loss.backward()
        params = list(net.collect_params().values())
        res[pkg] = ([pred, out.asnumpy()] + [p.data().asnumpy()
                                             for p in params],
                    [p.grad().asnumpy() for p in params
                     if p.grad_req != "null"])
    assert len(res[tmx][1]) == len(res[jmx][1]) > 0
    for a, b in zip(res[tmx][0], res[jmx][0]):
        onp.testing.assert_allclose(a, b, rtol=OUT_RTOL, atol=OUT_ATOL)
    for a, b in zip(res[tmx][1], res[jmx][1]):
        onp.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _plain_parent():
    onp.random.seed(0)
    net = t_nn.Sequential(prefix="p_")
    with net.name_scope():
        net.add(t_nn.Dense(8, in_units=6, activation="relu"),
                t_nn.BatchNorm(in_channels=8), t_nn.Dense(3, in_units=8))
    net.initialize(tmx.init.Xavier())
    return net


def test_static_child_of_a_plain_block_runs_its_cache():
    """A plain Block hands its children tensors: each child hybridized
    with both static flags runs its own cache all the same (upstream
    gives such a child a CachedOp of its own), on NDArray calls of the
    parent and on tensor calls, bit for bit as the eager net."""
    res = {}
    for hyb in (False, True):
        net = _plain_parent()
        if hyb:
            net.hybridize(static_alloc=True, static_shape=True)
        x = _x()
        got = [net(x)._data.clone(), net(x._data)]
        with t_ag.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        got += [out._data.detach().clone()] + [
            p.grad()._data.clone() for p in net.collect_params().values()
            if p.grad_req != "null"]
        res[hyb] = got
        if hyb:
            # predicting, the tensor call (torch's grad mode is on: it
            # records) and recording
            assert [len(c._cached_op) for c in net] == [3, 3, 3]
    for a, b in zip(res[True], res[False]):
        assert torch.equal(a, b)


def test_static_child_inside_another_program_runs_its_ops():
    """Inside a hybridized parent's entry, or a functionalized step, a
    child hybridized with both static flags runs as that program's ops:
    it makes no entry of its own."""
    from mxnet_tpu_torch import parallel

    net = _net()
    for child in net:
        child.hybridize(static_alloc=True, static_shape=True)
    net.hybridize()
    net(_x())
    assert len(net._cached_op) == 1
    assert all(len(c._cached_op) == 0 for c in net)
    flat = _plain_parent()
    flat.hybridize(static_alloc=True, static_shape=True)
    params, apply_fn = parallel.functionalize(flat)
    want = apply_fn(params, _x()._data)
    assert all(len(c._cached_op) == 0 for c in flat)
    assert torch.equal(flat(_x()._data), want)


def test_deferred_shapes_resolve_without_hooks():
    """A hybridized net with deferred widths resolves them in one
    internal pass before its first entry: its hooks see only the user's
    call, and every parameter is initialized after it."""
    net = t_nn.HybridSequential(prefix="d_")
    with net.name_scope():
        net.add(t_nn.Dense(8, activation="relu"), t_nn.Dense(3))
    net.initialize(tmx.init.Xavier())
    net.hybridize()
    seen, pre = [], []
    net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
    net[0].register_forward_pre_hook(lambda b, a: pre.append(a[0].shape))
    net(_x())
    assert seen == [(4, 3)] and pre == [(4, 6)]
    assert net[0].weight.shape == (8, 6)
    assert len(net._cached_op) == 1


def test_hooks_and_summary_match_reference(capsys):
    """``register_forward_hook``/``register_forward_pre_hook`` (with
    ``detach``), ``apply`` and ``summary`` as the reference's."""
    lines = {}
    for pkg, nn in ((jmx, j_nn), (tmx, t_nn)):
        net = nn.HybridSequential(prefix="s_")
        with net.name_scope():
            net.add(nn.Dense(8, in_units=6, activation="relu"),
                    nn.Dense(3, in_units=8))
        net.initialize()
        calls = []
        h = net.register_forward_hook(lambda b, a, o: calls.append(b.name))
        x = pkg.nd.array(onp.ones((2, 6), "float32"))
        net(x)
        h.detach()
        net(x)
        assert calls == ["s"]
        names = []
        assert net.apply(lambda b: names.append(b.name)) is net
        assert names[-1] == "s" and len(names) == 4
        net.summary(x)
        lines[pkg] = capsys.readouterr().out
    assert lines[tmx] == lines[jmx]


def test_constant_matches_reference():
    """``ParameterDict.get_constant`` and ``Constant``: the value, no
    gradient, in the block's parameters."""
    value = onp.arange(6, dtype="float32").reshape(2, 3)
    for pkg in (jmx, tmx):
        d = (j_gluon if pkg is jmx else t_gluon).ParameterDict("c_")
        c = d.get_constant("k", value)
        assert c.name == "c_k" and c.grad_req == "null"
        assert d.get_constant("k") is c
        c.initialize()
        onp.testing.assert_array_equal(c.data().asnumpy(), value)
    with pytest.raises(MXNetError):
        t_gluon.ParameterDict("c_").get_constant("missing")


def test_resnet18_hybridized_step_matches_reference(tmp_path):
    """One SGD step of the zoo's ResNet-18 v1 (classes 10, 32 x 32,
    batch 8, as ``tests/test_torch_resnet_nchw.py`` steps its ResNets), hybridized in both packages from the same weights: the
    predictions before it to 1e-5, the step's loss to 1e-4 relative and
    every parameter after it to 1e-4 of its largest magnitude (floor
    1e-3)."""
    rng = onp.random.RandomState(3)
    x = rng.rand(8, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, 8).astype("float32")
    jnet = j_gluon.model_zoo.vision.resnet18_v1(classes=10)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    f = str(tmp_path / "r.params")
    jnet.save_parameters(f)
    tnet = t_gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                prefix=jnet.prefix)
    tnet.initialize()
    tnet.load_parameters(f)
    outs = {}
    for pkg, net, ag, gl in ((jmx, jnet, j_ag, j_gluon),
                             (tmx, tnet, t_ag, t_gluon)):
        net.hybridize()
        pred = net(pkg.nd.array(x)).asnumpy()
        trainer = gl.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
        with ag.record():
            loss = gl.loss.SoftmaxCrossEntropyLoss()(net(pkg.nd.array(x)),
                                                     pkg.nd.array(y))
        loss.backward()
        trainer.step(8)
        outs[pkg] = (pred, loss.asnumpy(), {
            n: p.data().asnumpy() for n, p in net.collect_params().items()})
    (tpred, tloss, tw), (jpred, jloss, jw) = outs[tmx], outs[jmx]
    onp.testing.assert_allclose(tpred, jpred, rtol=FWD_TOL,
                                atol=FWD_TOL * float(onp.abs(jpred).max()))
    onp.testing.assert_allclose(tloss, jloss, rtol=STEP_TOL)
    assert list(tw) == list(jw)
    for n in jw:
        scale = max(float(onp.abs(jw[n]).max()), 1e-3)
        onp.testing.assert_allclose(tw[n], jw[n], rtol=STEP_TOL,
                                    atol=STEP_TOL * scale, err_msg=n)
    assert len(tnet._cached_op) == 2


def test_static_flags_on_the_host_run_op_by_op():
    """``hybridize(static_alloc=True, static_shape=True)`` off the card
    makes an entry that runs op by op (no capture) and equals eager."""
    from mxnet_tpu_torch.gluon import _graph

    before = _graph.captures
    net = _net()
    want = net(_x())._data.clone()
    net.hybridize(static_alloc=True, static_shape=True)
    got = net(_x())._data
    assert torch.equal(got, want) and _graph.captures == before
    assert [e.graphed for e in net._cached_op.values()] == [False]
