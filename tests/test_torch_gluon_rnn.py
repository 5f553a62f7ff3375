"""The port's recurrent Gluon (``gluon.rnn`` layers and cells,
``nn.Embedding``, ``nn.Sequential``, ``nn.Lambda``/``HybridLambda``,
``params=`` sharing) and its word language model held against the JAX
package on the CPU.

Blocks are built in both packages with the same prefixes; the
reference's weights cross by its ``save_parameters`` file, which the
port's ``load_parameters`` reads.  Inputs, states and head gradients are
numpy from a seed.  Tolerance (fp32): outputs, states and the gradients
of inputs and parameters to 1e-5 of each tensor's largest magnitude
(the packages sum the products in other orders; measured below 1e-6).
The word LM's three SGD steps (``clip_gradient`` 0.25): every loss and
every parameter to 1e-5.  Dropout and zoneout are held with the same
masks fed to both packages (the reference's ``jax.random.bernoulli``
and the port's ``_rng.draw_bernoulli`` patched), and the port's own
draws by their keep share.
"""
import importlib.util
import os

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _rng  # noqa: E402
from mxnet_tpu_torch.example import word_lm as t_word_lm  # noqa: E402
from mxnet_tpu_torch.ops import rnn as t_rnn  # noqa: E402

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


def _np(x, rs, scale=1.0):
    return (rs.randn(*x) * scale).astype("float32")


def _flat(out):
    """The arrays of a (nested) output, in order."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


class _Fed:
    """One bool mask per (keep, shape) from a seeded numpy stream, fed to
    both packages."""

    def __init__(self, seed):
        self.seed, self.masks = seed, {}

    def mask(self, keep, shape):
        key = (round(float(keep), 6), tuple(shape))
        if key not in self.masks:
            rs = onp.random.RandomState(self.seed + len(self.masks))
            self.masks[key] = rs.rand(*shape) < keep
        return self.masks[key]

    def install(self, monkeypatch):
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(
                                self.mask(p, shape)))
        monkeypatch.setattr(_rng, "draw_bernoulli",
                            lambda keep, shape, device, gen: torch.as_tensor(
                                self.mask(keep, shape), device=device))


def _run(pkg, block, call, inputs, seed=1, train=True):
    """``call(block, *arrays)`` under ``record()`` on the numpy ``inputs``
    (each with a gradient buffer); the outputs' inner product with
    seeded head gradients goes backward.  Returns the outputs, the
    inputs' gradients and ``{name: grad}`` of the parameters."""
    arrays = [pkg.nd.array(x) for x in inputs]
    for a in arrays:
        a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = _flat(call(block, *arrays))
        rs = onp.random.RandomState(seed)
        loss = None
        for o in out:
            term = (o * pkg.nd.array(_np(o.shape, rs))).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {n: p.grad().asnumpy()
             for n, p in block.collect_params().items()
             if p.grad_req != "null"}
    return ([o.asnumpy() for o in out], [a.grad.asnumpy() for a in arrays],
            grads)


def _side_by_side(build, call, inputs, tmp_path, resolve=None, seed=1,
                  train=True):
    """Build in both packages, resolve the reference's deferred shapes
    (``resolve``, default: one ``call``), carry its weights across by
    its ``save_parameters`` file, and hold the port's outputs and
    gradients against the reference's."""
    jb, tb = build(jmx.gluon), build(tmx.gluon)
    assert list(tb.collect_params()) == list(jb.collect_params())
    jb.initialize(jmx.init.Xavier())
    (resolve or call)(jb, *[jmx.nd.array(x) for x in inputs])
    f = str(tmp_path / "ref.params")
    jb.save_parameters(f)
    tb.initialize()
    tb.load_parameters(f)
    want = _run(jmx, jb, call, inputs, seed, train)
    got = _run(tmx, tb, call, inputs, seed, train)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.shape == w.shape and _rel(g, w) <= TOL, _rel(g, w)
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        assert _rel(got[2][n], want[2][n]) <= TOL, n
    return jb, tb


# -------------------------------------------------------------- layers
LAYERS = {
    "lstm_2l": (lambda g: g.rnn.LSTM(20, num_layers=2, prefix="l_"),
                (3, 4, 10), 2),
    "gru": (lambda g: g.rnn.GRU(20, prefix="g_"), (3, 4, 10), 1),
    "rnn_tanh": (lambda g: g.rnn.RNN(20, activation="tanh", prefix="r_"),
                 (3, 4, 10), 1),
    "rnn_relu_2l": (lambda g: g.rnn.RNN(8, num_layers=2, prefix="r_"),
                    (3, 4, 5), 1),
    "lstm_bi": (lambda g: g.rnn.LSTM(16, num_layers=2, bidirectional=True,
                                     prefix="l_"), (7, 2, 8), 2),
    "gru_bi_ntc": (lambda g: g.rnn.GRU(12, layout="NTC", bidirectional=True,
                                       prefix="g_"), (2, 6, 5), 1),
    "lstmp": (lambda g: g.rnn.LSTM(12, num_layers=2, projection_size=5,
                                   prefix="l_"), (4, 3, 6), 2),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_rnn_layer_matches_reference(name, tmp_path):
    """The layer cases of ``tests/test_gluon.py`` side by side: called
    without states (outputs only) and with seeded states (outputs and
    the new states), gradients of input, states and parameters."""
    build, shape, nstate = LAYERS[name]
    rs = onp.random.RandomState(2)
    x = _np(shape, rs)
    jl = build(jmx.gluon)
    batch = shape[0] if "ntc" in name else shape[1]
    states = [_np(s["shape"], rs) for s in jl.state_info(batch)]
    assert len(states) == nstate

    def with_states(layer, x, *st):
        out, new = layer(x, list(st))
        assert isinstance(new, list) and len(new) == nstate
        return out, new

    _side_by_side(build, lambda layer, x: layer(x), [x], tmp_path)
    _side_by_side(build, with_states, [x] + states, tmp_path)


def test_rnn_layer_begin_state_and_repr_match_reference():
    for build in (LAYERS["lstmp"][0], LAYERS["gru_bi_ntc"][0]):
        j, t = build(jmx.gluon), build(tmx.gluon)
        assert t.state_info(3) == j.state_info(3)
        assert [s.shape for s in t.begin_state(batch_size=3)] == \
            [s.shape for s in j.begin_state(batch_size=3)]
        assert repr(t) == repr(j)


def test_rnn_layer_drives_the_op_once_per_layer():
    layer = tmx.gluon.rnn.LSTM(6, num_layers=3)
    layer.initialize()
    t_rnn.loop_layer.launches = 0
    layer(tmx.nd.array(_np((4, 2, 3), onp.random.RandomState(0))))
    assert t_rnn.loop_layer.launches == 3


# --------------------------------------------------------------- cells
def _unroll(length, layout="NTC", merge=True, valid=None):
    def call(cell, x, *rest):
        vl = rest[0] if valid is not None else None
        return cell.unroll(length, x, layout=layout, merge_outputs=merge,
                           valid_length=vl)
    return call


CELLS = {
    "rnn_merge_valid": (lambda g: g.rnn.RNNCell(12, prefix="c_"),
                        (2, 5, 6), True, [3.0, 5.0]),
    "lstm_merge_valid": (lambda g: g.rnn.LSTMCell(12, prefix="c_"),
                         (3, 5, 6), True, [1.0, 5.0, 2.0]),
    "gru_merge_valid": (lambda g: g.rnn.GRUCell(12, prefix="c_"),
                        (2, 5, 6), True, [4.0, 2.0]),
    "rnn_list": (lambda g: g.rnn.RNNCell(7, activation="relu",
                                         prefix="c_"), (2, 4, 3), False,
                 None),
    "lstm_list": (lambda g: g.rnn.LSTMCell(7, prefix="c_"), (2, 4, 3),
                  False, None),
    "gru_default_merge": (lambda g: g.rnn.GRUCell(7, prefix="c_"),
                          (2, 4, 3), None, None),
    "sequential": (lambda g: _stack(g, g.rnn.SequentialRNNCell),
                   (2, 4, 6), True, [2.0, 4.0]),
    "hybrid_sequential": (lambda g: _stack(g, g.rnn.HybridSequentialRNNCell),
                          (2, 4, 6), False, None),
    "bidirectional": (lambda g: g.rnn.BidirectionalCell(
        g.rnn.LSTMCell(5, prefix="l_"), g.rnn.GRUCell(5, prefix="r_")),
        (2, 4, 6), True, [2.0, 4.0]),
    "bidirectional_list": (lambda g: g.rnn.BidirectionalCell(
        g.rnn.RNNCell(5, prefix="l_"), g.rnn.RNNCell(5, prefix="r_")),
        (2, 4, 6), False, None),
    "residual": (lambda g: g.rnn.ResidualCell(g.rnn.GRUCell(6,
                                                            prefix="c_")),
                 (2, 4, 6), False, None),
    "residual_merge_valid": (lambda g: g.rnn.ResidualCell(
        g.rnn.LSTMCell(6, prefix="c_")), (2, 4, 6), True, [1.0, 3.0]),
}


def _stack(g, kind):
    stack = kind(prefix="s_")
    with stack.name_scope():
        stack.add(g.rnn.LSTMCell(8))
        stack.add(g.rnn.DropoutCell(0.2))
        stack.add(g.rnn.GRUCell(8))
    return stack


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_unroll_matches_reference(name, tmp_path):
    """``unroll`` (NTC, merged or as a list of steps, with and without
    ``valid_length``) in predict mode: outputs, final states and
    gradients."""
    build, shape, merge, valid = CELLS[name]
    rs = onp.random.RandomState(3)
    inputs = [_np(shape, rs)]
    if valid is not None:
        inputs.append(onp.asarray(valid, "float32"))
    _side_by_side(build, _unroll(shape[1], merge=merge, valid=valid),
                  inputs, tmp_path, train=False)


def test_cell_unroll_tnc_and_begin_state_match_reference(tmp_path):
    rs = onp.random.RandomState(4)
    x = _np((5, 2, 6), rs)
    h, c = _np((2, 9), rs), _np((2, 9), rs)

    def call(cell, x, h, c):
        return cell.unroll(5, x, begin_state=[h, c], layout="TNC",
                           merge_outputs=True)

    _side_by_side(lambda g: g.rnn.LSTMCell(9, prefix="c_"), call,
                  [x, h, c], tmp_path)


def test_cell_step_matches_reference(tmp_path):
    """One step called directly, ``cell(x_t, states)``, through a
    hybrid stack."""
    rs = onp.random.RandomState(5)
    x, h1, c1, h2 = (_np(s, rs) for s in ((3, 4), (3, 6), (3, 6), (3, 6)))

    def build(g):
        s = g.rnn.HybridSequentialRNNCell(prefix="s_")
        with s.name_scope():
            s.add(g.rnn.LSTMCell(6))
            s.add(g.rnn.RNNCell(6))
        return s

    _side_by_side(build, lambda cell, x, *st: cell(x, list(st)),
                  [x, h1, c1, h2], tmp_path)


@pytest.mark.parametrize("kind", ["dropout", "zoneout"])
def test_masked_cells_match_reference_with_fed_masks(kind, monkeypatch,
                                                     tmp_path):
    """``DropoutCell`` and ``ZoneoutCell`` training, with the same masks
    fed to both packages."""
    _Fed(13).install(monkeypatch)

    def build(g):
        if kind == "zoneout":
            return g.rnn.ZoneoutCell(g.rnn.LSTMCell(6, prefix="c_"),
                                     zoneout_outputs=0.3,
                                     zoneout_states=0.4)
        return _stack(g, g.rnn.SequentialRNNCell)

    x = _np((2, 4, 5), onp.random.RandomState(6))
    _side_by_side(build, _unroll(4), [x], tmp_path)


def test_masked_cells_are_the_identity_when_predicting():
    x = tmx.nd.array(_np((2, 4, 5), onp.random.RandomState(7)))
    base = tmx.gluon.rnn.LSTMCell(6)
    z = tmx.gluon.rnn.ZoneoutCell(base, 0.5, 0.5)
    z.initialize()
    got, _ = z.unroll(4, x, merge_outputs=True)
    base._modified = False
    want, _ = base.unroll(4, x, merge_outputs=True)
    assert onp.array_equal(got.asnumpy(), want.asnumpy())


def test_bidirectional_cell_refuses_a_step():
    cell = tmx.gluon.rnn.BidirectionalCell(tmx.gluon.rnn.RNNCell(3),
                                           tmx.gluon.rnn.RNNCell(3))
    with pytest.raises(tmx.base.MXNetError, match="unroll"):
        cell(tmx.nd.zeros((2, 3)), [])


# ---------------------------------------------------- parameter sharing
def test_params_sharing_matches_reference(tmp_path):
    """Two cells on one parameter set (``params=``): the names are the
    first cell's, one tensor, and its gradient sums both uses."""
    def build(g):
        net = g.nn.Sequential(prefix="net_")
        with net.name_scope():
            a = g.rnn.LSTMCell(7, prefix="a_")
            net.add(a, g.rnn.LSTMCell(7, prefix="b_",
                                      params=a.collect_params()))
        return net

    def call(net, x, y):
        a, b = net[0], net[1]
        oa, _ = a.unroll(3, x, merge_outputs=True)
        ob, _ = b.unroll(3, y, merge_outputs=True)
        return oa, ob

    def resolve(net, x, y):
        return call(net, x, y)

    rs = onp.random.RandomState(8)
    jb, tb = _side_by_side(build, call, [_np((2, 3, 5), rs),
                                         _np((2, 3, 5), rs)],
                           tmp_path, resolve=resolve)
    for net in (jb, tb):
        a, b = net[0], net[1]
        assert list(b.collect_params()) == list(a.collect_params()) == [
            "net_a_i2h_weight", "net_a_h2h_weight", "net_a_i2h_bias",
            "net_a_h2h_bias"]
        assert b.collect_params()["net_a_i2h_weight"] is \
            a.collect_params()["net_a_i2h_weight"]
    pa = tb[0].collect_params()["net_a_i2h_weight"]
    assert tb[1].i2h_weight is tb[0].i2h_weight is pa.data()._data


def test_params_sharing_reaches_the_children():
    """A block built with ``params=`` gives its children the shared
    dict, as the reference's ``_BlockScope`` does."""
    names = {}
    for pkg in (jmx, tmx):
        nets = []
        for i in range(2):
            net = pkg.gluon.nn.HybridSequential(
                prefix="m_", params=nets[0].collect_params() if i else None)
            with net.name_scope():
                net.add(pkg.gluon.nn.Dense(4, in_units=3),
                        pkg.gluon.nn.Dense(2, in_units=4))
            nets.append(net)
        one, two = (list(n.collect_params().values()) for n in nets)
        assert all(p is q for p, q in zip(one, two))
        names[pkg] = list(nets[1].collect_params())
    assert names[tmx] == names[jmx]


# ---------------------------------------- Embedding, Sequential, Lambda
def test_embedding_sequential_lambda_match_reference(tmp_path):
    def build(g):
        net = g.nn.Sequential(prefix="s_")
        with net.name_scope():
            net.add(g.nn.Embedding(10, 4, sparse_grad=True),
                    g.nn.Lambda("tanh"),
                    g.nn.HybridLambda(lambda F, x: F.relu(x) * 2),
                    g.nn.Lambda(lambda x: x + 1),
                    g.nn.Dense(3, flatten=False))
        return net

    ids = onp.asarray([[1, 2, 9], [0, 3, 3]], "float32")
    jb, tb = _side_by_side(build, lambda net, x: net(x), [ids], tmp_path)
    assert len(tb) == len(jb) == 5
    assert [repr(b) for b in tb][:4] == [repr(b) for b in jb][:4]
    assert type(tb[1:3]).__name__ == "Sequential" and len(tb[1:3]) == 2
    assert list(tb[1:3].collect_params()) == list(jb[1:3].collect_params())


def test_hybrid_lambda_and_lambda_names_follow_the_reference():
    for pkg in (jmx, tmx):
        with pytest.raises(pkg.base.MXNetError, match="not found"):
            pkg.gluon.nn.Lambda("no_such_op")
        with pytest.raises(pkg.base.MXNetError, match="Unrecognized"):
            pkg.gluon.nn.HybridLambda(3)
    assert list(tmx.gluon.nn.HybridLambda("relu", prefix="h_")
                .collect_params()) == []


# ------------------------------------------------------ the word LM
def _ref_word_lm():
    spec = importlib.util.spec_from_file_location(
        "ref_word_lm", os.path.join(ROOT, "example", "rnn", "word_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORD_LM = dict(vocab=50, embed=16, hidden=16, layers=2, batch_size=4,
               bptt=5, lr=1.0, clip=0.25)


def _ref_word_lm_steps(steps, dropout, params_file):
    """The reference example's loop (``example/rnn/word_lm.py:main``),
    ``steps`` steps, hybridized, its initial weights saved to
    ``params_file``.  Returns the per-token losses and the weights."""
    ref = _ref_word_lm()
    cfg = WORD_LM
    data = t_word_lm.batchify(t_word_lm.synthetic_corpus(cfg["vocab"]),
                              cfg["batch_size"])
    ctx = jmx.cpu()
    model = ref.RNNModel(cfg["vocab"], cfg["embed"], cfg["hidden"],
                         cfg["layers"], dropout)
    model.initialize(init=jmx.init.Xavier(), ctx=ctx)
    model.hybridize()
    model(jmx.nd.array(data[:cfg["bptt"]]),
          *model.begin_state(cfg["batch_size"], ctx=ctx))
    model.save_parameters(params_file)
    trainer = jmx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": cfg["lr"],
                                 "clip_gradient": cfg["clip"]})
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    states = model.begin_state(cfg["batch_size"], ctx=ctx)
    losses = []
    bptt = cfg["bptt"]
    for i in range(0, steps * bptt, bptt):
        x = jmx.nd.array(data[i:i + bptt], ctx=ctx)
        y = jmx.nd.array(data[i + 1:i + 1 + bptt], ctx=ctx)
        states = ref.detach(states)
        with jmx.autograd.record():
            out = model(x, *states)
            logits, states = out[0], list(out[1:])
            loss = loss_fn(logits.reshape((-1, cfg["vocab"])),
                           y.reshape((-1,)))
        loss.backward()
        trainer.step(cfg["batch_size"] * bptt)
        losses.append(float(loss.sum().asnumpy()) / (cfg["batch_size"]
                                                     * bptt))
    return losses, {n: p.data().asnumpy()
                    for n, p in model.collect_params().items()}


def _port_word_lm_steps(steps, dropout, params_file):
    cfg = WORD_LM
    res = t_word_lm.train(cfg["vocab"], cfg["embed"], cfg["hidden"],
                          cfg["layers"], dropout, cfg["batch_size"],
                          cfg["bptt"], 1, cfg["lr"], cfg["clip"],
                          ctx=tmx.cpu(), params_file=params_file,
                          max_steps=steps, log=lambda *a: None)
    return res["losses"], {n: p.data().asnumpy() for n, p in
                           res["model"].collect_params().items()}


def _assert_word_lm_match(got, want):
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert abs(g - w) <= TOL * abs(w), (got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for n in want[1]:
        assert _rel(got[1][n], want[1][n]) <= TOL, n


def test_word_lm_three_steps_match_reference(tmp_path):
    """Vocabulary 50, width 16, 2 layers, bptt 5, batch 4, p = 0, SGD lr
    1 with ``clip_gradient`` 0.25, from the reference's weights."""
    f = str(tmp_path / "ref.params")
    want = _ref_word_lm_steps(3, 0.0, f)
    got = _port_word_lm_steps(3, 0.0, f)
    _assert_word_lm_match(got, want)
    assert got[0][-1] < got[0][0]


def test_word_lm_dropout_matches_reference_with_fed_masks(monkeypatch,
                                                          tmp_path):
    """p = 0.5: the Embedding's and the decoder's Dropout and the LSTM's
    mask between layers, the same masks in both packages."""
    _Fed(17).install(monkeypatch)
    f = str(tmp_path / "ref.params")
    want = _ref_word_lm_steps(2, 0.5, f)
    got = _port_word_lm_steps(2, 0.5, f)
    _assert_word_lm_match(got, want)


def test_word_lm_masks_keep_half():
    """The port's own draws at p = 0.5: three masks a step (Embedding,
    between the LSTM layers, decoder), each keeping half its elements
    within 5 standard errors, none equal to another."""
    seen = []
    orig = _rng.draw_bernoulli

    def rec(*a):
        m = orig(*a)
        seen.append(m)
        return m

    _rng.draw_bernoulli = rec
    try:
        model, trainer, loss_fn = t_word_lm.build(
            50, 64, 64, 2, 0.5, ctx=tmx.cpu())
        x = tmx.nd.array(onp.random.RandomState(0).randint(0, 50, (35, 32)))
        states = model.begin_state(32, ctx=tmx.cpu())
        t_word_lm.step(model, trainer, loss_fn, x, x, states)
    finally:
        _rng.draw_bernoulli = orig
    assert [tuple(m.shape) for m in seen] == [(35, 32, 64)] * 3
    for m in seen:
        assert abs(float(m.float().mean()) - 0.5) < 5 * 0.5 / m.numel() ** 0.5
    assert not torch.equal(seen[0], seen[1])


def test_word_lm_detach_cuts_the_graph():
    model, trainer, loss_fn = t_word_lm.build(20, 8, 8, 2, 0.0,
                                              ctx=tmx.cpu())
    x = tmx.nd.array(onp.random.RandomState(1).randint(0, 20, (5, 3)))
    states = model.begin_state(3, ctx=tmx.cpu())
    for _ in range(3):
        _, states = t_word_lm.step(model, trainer, loss_fn, x, x, states)
        assert all(s._data.grad_fn is not None for s in states)
        assert all(s._data.grad_fn is None
                   for s in t_word_lm.detach(states))


def test_word_lm_example_runs_on_the_host(tmp_path, capsys):
    data = tmp_path / "tokens.txt"
    data.write_text(" ".join(str(t) for t in
                             t_word_lm.synthetic_corpus(30, n=400)))
    res = t_word_lm.main(["--ctx", "cpu", "--data", str(data), "--epochs",
                          "2", "--batch-size", "4", "--bptt", "5",
                          "--embed", "8", "--hidden", "8", "--layers", "1"])
    assert "final_perplexity=" in capsys.readouterr().out
    assert res["steps"] > 0 and all(onp.isfinite(res["losses"]))
    assert res["epochs"][-1]["perplexity"] < res["epochs"][0]["perplexity"]
