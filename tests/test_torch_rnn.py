"""The port's RNN op (``ops/rnn.py``), the sequence ops
(``ops/sequence_ops.py``), ``sym.RNN`` and the ``lstm_bucketing``
example held against the JAX package on the CPU.

Inputs are numpy from a seed.  Tolerances (fp32): the op's outputs,
final states and the gradients of data, parameters and states to 1e-5
of each tensor's largest magnitude (the packages sum the gate products
in other orders; measured below 1e-6), both of the port's arms: the
loop (the op's host path) and the ``torch._VF`` arm, whose weight
packing is the card's (on the host it runs torch's own fused loop).
The sequence ops exactly, NaN fills included.  Symbol JSON byte for
byte.  Five ``BucketingModule`` steps: perplexities and parameters to
1e-5.  The dropout between layers is held with the same masks fed to
both packages (the reference's ``jax.random.bernoulli`` and the port's
``_rng.draw_bernoulli`` patched), and by its keep share.
"""
import importlib.util
import inspect
import os

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import registry as j_reg  # noqa: E402
from mxnet_tpu.ops import rnn as j_rnn  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _rng  # noqa: E402
from mxnet_tpu_torch.example import lstm_bucketing as t_bucketing  # noqa: E402
from mxnet_tpu_torch.ops import registry as t_reg  # noqa: E402
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


def _ref_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ registry
def test_rnn_op_registration_is_the_reference_ones():
    for name in ("RNN", "SequenceMask", "SequenceLast", "SequenceReverse"):
        j, t = j_reg.get_op(name), t_reg.get_op(name)
        assert t.param_names == j.param_names, name
        j_kw = {p.name: p.default for p in
                inspect.signature(j.fn).parameters.values()}
        t_kw = {p.name: p.default for p in
                inspect.signature(t.fn).parameters.values()}
        assert t_kw == j_kw, name
        assert (t.key_param, t.train_param) == (j.key_param, j.train_param)
        for p in ({}, {"state_outputs": True},
                  {"state_outputs": True, "mode": "gru"}):
            assert t.out_count(p) == j.out_count(p), (name, p)
        assert hasattr(tmx.nd, name) and hasattr(tmx.sym, name)


# ------------------------------------------------------- packing layout
LAYOUTS = [(mode, layers, bi, proj)
           for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
           for layers in (1, 3) for bi in (False, True)
           for proj in ((None, 3) if mode == "lstm" else (None,))]


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_param_size_and_offsets_match_reference(layout):
    mode, layers, bi, proj = layout
    args = (mode, layers, 5, 6, bi, proj)
    n = j_rnn.rnn_param_size(*args)
    assert t_rnn.rnn_param_size(*args) == n
    flat = onp.arange(n, dtype="float32")
    jw, jb = j_rnn.unpack_rnn_params(jnp.asarray(flat), *args)
    tw, tb = t_rnn.unpack_rnn_params(torch.from_numpy(flat), *args)
    for jt, tt in zip(jw + jb, tw + tb):
        assert len(jt) == len(tt)
        for j, t in zip(jt, tt):
            if j is None:
                assert t is None
            else:
                onp.testing.assert_array_equal(t.numpy(), onp.asarray(j))


# ------------------------------------------------------------- the op
def _case(mode="lstm", layers=1, bi=False, proj=None, clip=None,
          state_outputs=True, state_cell=True, T=5, N=3, I=4, H=6, seed=0):
    rs = onp.random.RandomState(seed)
    d = 2 if bi else 1
    r = proj or H
    n = j_rnn.rnn_param_size(mode, layers, I, H, bi, proj)
    inputs = [rs.randn(T, N, I).astype("float32"),
              (rs.randn(n) * 0.3).astype("float32"),
              rs.randn(layers * d, N, r).astype("float32")]
    if mode == "lstm" and state_cell:
        inputs.append(rs.randn(layers * d, N, H).astype("float32"))
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi,
              state_outputs=state_outputs, projection_size=proj)
    if clip is not None:
        kw.update(lstm_state_clip_min=-clip, lstm_state_clip_max=clip)
    cots = [rs.randn(T, N, d * r).astype("float32")]
    if state_outputs:
        cots.append(rs.randn(layers * d, N, r).astype("float32"))
        if mode == "lstm":
            cots.append(rs.randn(layers * d, N, H).astype("float32"))
    return inputs, kw, cots


def _ref_outputs_and_grads(inputs, kw, cots, **extra):
    def f(*xs):
        out = j_rnn.rnn(*xs, **kw, **extra)
        return tuple(out) if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(f, *[jnp.asarray(x) for x in inputs])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return [onp.asarray(o) for o in outs], [onp.asarray(g) for g in grads]


def _port_outputs_and_grads(arm, inputs, cots, kw, **extra):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = t_rnn.rnn_arm(arm, *ts, **kw, **extra)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


OP_CASES = {
    **{f"{m}_{n}l_{'bi' if b else 'uni'}": dict(mode=m, layers=n, bi=b)
       for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
       for n in (1, 2) for b in (False, True)},
    "lstmp": dict(proj=3, layers=2),
    "lstmp_bi": dict(proj=4, bi=True),
    "lstm_clip": dict(clip=0.3, layers=2, bi=True),
    "lstm_no_state_outputs": dict(state_outputs=False, layers=2),
    "lstm_state_cell_none": dict(state_cell=False, layers=2),
    "gru_no_state_outputs": dict(mode="gru", state_outputs=False),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_rnn_op_matches_reference(case):
    """Outputs, final states and every input gradient, the loop and the
    ``torch._VF`` arm against the reference's scan."""
    inputs, kw, cots = _case(**OP_CASES[case])
    want_o, want_g = _ref_outputs_and_grads(inputs, kw, cots)
    for arm in (t_rnn.loop_layer, t_rnn.cudnn_layer):
        got_o, got_g = _port_outputs_and_grads(arm, inputs, cots, kw)
        assert len(got_o) == len(want_o)
        for g, w in zip(got_o + got_g, want_o + want_g):
            assert g.shape == w.shape
            assert _rel(g, w) <= TOL, (arm.__name__, _rel(g, w))


def test_state_clip_takes_the_final_cell_states_only():
    """The reference clips the final cell states after the layers, not
    each step's (``mxnet_tpu/ops/rnn.py:161-163``): the outputs equal the
    unclipped op's."""
    inputs, kw, _ = _case(layers=2, seed=4)
    inputs[2] *= 4
    inputs[3] *= 4
    ts = [torch.from_numpy(x) for x in inputs]
    free = t_rnn.rnn(*ts, **kw)
    clipped = t_rnn.rnn(*ts, **kw, lstm_state_clip_min=-0.05,
                        lstm_state_clip_max=0.05)
    assert torch.equal(free[0], clipped[0]) and torch.equal(free[1],
                                                            clipped[1])
    assert float(free[2].abs().max()) > 0.05
    assert torch.equal(clipped[2], free[2].clamp(-0.05, 0.05))


def test_nd_rnn_runs_the_loop_on_the_host():
    inputs, kw, _ = _case(layers=2, bi=True)
    t_rnn.loop_layer.launches = 0
    t_rnn.cudnn_layer.launches = 0
    got = tmx.nd.RNN(*[tmx.nd.array(x) for x in inputs], **kw)
    want = jmx.nd.RNN(*[jmx.nd.array(x) for x in inputs], **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _rel(g.asnumpy(), w.asnumpy()) <= TOL
    assert (t_rnn.loop_layer.launches, t_rnn.cudnn_layer.launches) == (2, 0)


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


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_relu", False)])
def test_dropout_between_layers_matches_reference_with_fed_masks(
        monkeypatch, mode, bi):
    """p = 0.4 over 3 layers: a mask after layers 1 and 2, none after the
    last; outputs and gradients as the reference's."""
    _Fed(11).install(monkeypatch)
    inputs, kw, cots = _case(mode=mode, layers=3, bi=bi, seed=5)
    extra = dict(p=0.4, train=True)
    want_o, want_g = _ref_outputs_and_grads(
        inputs, kw, cots, key=jax.random.PRNGKey(0), **extra)
    for arm in (t_rnn.loop_layer, t_rnn.cudnn_layer):
        got_o, got_g = _port_outputs_and_grads(
            arm, inputs, cots, kw, key=torch.Generator(), **extra)
        for g, w in zip(got_o + got_g, want_o + want_g):
            assert _rel(g, w) <= TOL


@pytest.mark.parametrize("extra", [
    dict(p=0.4, train=False), dict(p=0.0, train=True),
    dict(p=0.4, train=True, key=None)], ids=["predict", "p0", "no_key"])
def test_no_dropout_without_train_p_and_key(extra):
    inputs, kw, _ = _case(layers=2, seed=6)
    ts = [torch.from_numpy(x) for x in inputs]
    extra = {"key": torch.Generator(), **extra}
    for g, w in zip(t_rnn.rnn(*ts, **kw, **extra), t_rnn.rnn(*ts, **kw)):
        assert torch.equal(g, w)


def test_dropout_between_layers_keeps_one_minus_p():
    """The port's own draw (its stream differs from the reference's):
    the inter-layer mask keeps 1 - p of the elements."""
    seen = []
    orig = _rng.draw_bernoulli

    def rec(*a):
        m = orig(*a)
        seen.append(m)
        return m

    _rng.draw_bernoulli = rec
    try:
        inputs, kw, _ = _case(layers=3, T=40, N=50, H=50, seed=7)
        t_rnn.rnn(*[torch.from_numpy(x) for x in inputs], **kw, p=0.3,
                  train=True, key=torch.Generator().manual_seed(1))
    finally:
        _rng.draw_bernoulli = orig
    assert len(seen) == 2 and seen[0].shape == (40, 50, 50)
    n = seen[0].numel()
    for m in seen:
        share = float(m.float().mean())
        assert abs(share - 0.7) < 5 * (0.7 * 0.3 / n) ** 0.5
    assert not torch.equal(seen[0], seen[1])


# ------------------------------------------------------- sequence ops
def _seq_inputs(dtype="float32"):
    rs = onp.random.RandomState(9)
    x = rs.randn(4, 3, 2).astype("float32")
    if dtype == "int32":
        x = (x * 10).astype("int32")
    return x


SEQ_CASES = {
    "mask_no_lengths": ("SequenceMask", {}, None),
    "mask": ("SequenceMask", dict(value=-1.0), [0.0, 2.7, 6.0]),
    "mask_axis1": ("SequenceMask", dict(axis=1), [1.0, 2.0, 3.0, 0.0]),
    "last_no_lengths": ("SequenceLast", {}, None),
    "last_zero_and_truncated": ("SequenceLast", {}, [0.0, 2.7, 4.0]),
    "last_out_of_range": ("SequenceLast", {}, [5.0, -1.0, -4.0]),
    "last_axis1": ("SequenceLast", dict(axis=1), [1.0, 3.0, 2.0, 0.0]),
    "reverse_no_lengths": ("SequenceReverse", {}, None),
    "reverse": ("SequenceReverse", {}, [0.0, 2.7, 4.0]),
    "reverse_out_of_range": ("SequenceReverse", {}, [6.0, -1.0, 1.0]),
    "reverse_ignores_axis": ("SequenceReverse", dict(axis=1),
                             [1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_op_matches_reference(case, dtype):
    name, kw, lengths = SEQ_CASES[case]
    x = _seq_inputs(dtype)
    args_j, args_t = [jnp.asarray(x)], [torch.from_numpy(x)]
    if lengths is not None:
        ln = onp.asarray(lengths, "float32")
        args_j.append(jnp.asarray(ln))
        args_t.append(torch.from_numpy(ln))
        kw = dict(kw, use_sequence_length=True)
    want = onp.asarray(j_reg.get_op(name).fn(*args_j, **kw))
    got = t_reg.get_op(name).fn(*args_t, **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("SequenceMask", dict(axis=1)), ("SequenceLast", {}),
    ("SequenceReverse", {})])
def test_sequence_op_gradient_matches_reference(name, kw):
    x = onp.random.RandomState(3).randn(4, 4, 2).astype("float32")
    ln = onp.asarray([1.0, 4.0, 0.0, 2.0], "float32")
    cot = onp.random.RandomState(4).randn(
        *onp.asarray(j_reg.get_op(name).fn(
            jnp.asarray(x), jnp.asarray(ln), use_sequence_length=True,
            **kw)).shape).astype("float32")
    _, vjp = jax.vjp(lambda a: j_reg.get_op(name).fn(
        a, jnp.asarray(ln), use_sequence_length=True, **kw), jnp.asarray(x))
    want = onp.asarray(vjp(jnp.asarray(cot))[0])
    xt = torch.tensor(x, requires_grad=True)
    t_reg.get_op(name).fn(xt, torch.from_numpy(ln), use_sequence_length=True,
                          **kw).backward(torch.from_numpy(cot))
    onp.testing.assert_array_equal(xt.grad.numpy(), want)


# ------------------------------------------------------------- symbols
SYM_CASES = {
    "lstm_2l_bi": dict(state_size=6, num_layers=2, mode="lstm",
                       bidirectional=True, state_outputs=True),
    "gru": dict(state_size=5, num_layers=1, mode="gru"),
    "lstmp": dict(state_size=6, num_layers=2, mode="lstm",
                  projection_size=3, state_outputs=True),
}


@pytest.mark.parametrize("case", list(SYM_CASES))
def test_sym_rnn_matches_reference(case):
    kw = SYM_CASES[case]
    syms = {}
    for pkg in (jmx, tmx):
        data = pkg.sym.Variable("data")
        syms[pkg] = pkg.sym.RNN(data, name="rnn", **kw)
    j, t = syms[jmx], syms[tmx]
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.tojson() == j.tojson()
    assert tmx.sym.load_json(j.tojson()).tojson() == j.tojson()
    assert t.infer_shape(data=(7, 3, 4)) == j.infer_shape(data=(7, 3, 4))


def _bucketing_refs():
    return _ref_module("ref_lstm_bucketing", os.path.join(
        ROOT, "example", "rnn", "bucketing", "lstm_bucketing.py"))


@pytest.mark.parametrize("bucket", [8, 16])
def test_lstm_bucketing_graph_matches_reference(bucket):
    ref = _bucketing_refs()
    j, _, _ = ref.sym_gen_factory(32, 16, 32)(bucket)
    t, _, _ = t_bucketing.sym_gen_factory(32, 16, 32)(bucket)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    shapes = dict(data=(16, bucket), softmax_label=(16, bucket))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)


def test_lstm_bucketing_five_steps_match_reference():
    """Five ``BucketingModule`` steps over both buckets from the same
    ``arg_params``: each step's perplexity and every parameter after
    them to 1e-5."""
    ref = _bucketing_refs()
    rs = onp.random.RandomState(21)
    shapes = {"embed_weight": (32, 16), "lstm_parameters": (
        j_rnn.rnn_param_size("lstm", 1, 16, 32),), "decoder_weight": (32, 32),
        "decoder_bias": (32,), "lstm_state": (1, 16, 32),
        "lstm_state_cell": (1, 16, 32)}
    init = {k: (rs.uniform(-0.1, 0.1, s)).astype("float32")
            for k, s in shapes.items()}

    mod = jmx.mod.BucketingModule(ref.sym_gen_factory(32, 16, 32),
                                  default_bucket_key=16, context=jmx.cpu())
    rng = onp.random.RandomState(0)
    warm = next(ref.synthetic_batches(rng, 1, 16, 32))
    mod.bind(data_shapes=warm.provide_data, label_shapes=warm.provide_label)
    mod.init_params(initializer=jmx.init.Uniform(0.1), arg_params={
        k: jmx.nd.array(v) for k, v in init.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.5), ("momentum", 0.9)))
    metric = jmx.metric.Perplexity(ignore_label=None)
    want_ppl, buckets = [], []
    for batch in ref.synthetic_batches(rng, 5, 16, 32):
        mod.forward(batch, is_train=True)
        metric.reset()
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
        want_ppl.append(metric.get()[1])
        buckets.append(batch.bucket_key)
    assert set(buckets) == {8, 16}
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    res = t_bucketing.train(16, 5, 32, 16, 32, 0.5, ctx=tmx.cpu(),
                            arg_params={k: tmx.nd.array(v)
                                        for k, v in init.items()},
                            log=lambda *a: None)
    assert res["buckets"] == buckets
    for g, w in zip(res["perplexity"], want_ppl):
        assert abs(g - w) <= TOL * abs(w)
    got = {k: v.asnumpy() for k, v in res["module"].get_params()[0].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL, k


def test_lstm_bucketing_example_runs_on_the_host(capsys):
    res = t_bucketing.main(["--ctx", "cpu"])
    assert "lstm_bucketing OK" in capsys.readouterr().out
    assert res["perplexity"][-1] < 0.8 * res["perplexity"][0]
