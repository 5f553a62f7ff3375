"""Faults of the port against the reference, repaired (ROADMAP §C 1–8):
both packages on the CPU, on the same numpy inputs (``with mx.cpu():``
for the port).

- §C 1: indices out of range give the reference's values (NaN or the
  integer fill of jnp's "fill" gather; a clamped row for
  ``gather_nd``), never an error, and the same gradients;
- §C 2: values and gradients at ±0 of every unary function, and of
  ``_power`` at (0, 0), are the reference's, signs of zero included;
- §C 3: a backward from a head cast to an integer type gives its input
  a zero gradient;
- §C 4 and §C 8: integer and bool inputs that the reference takes;
- §C 5: ``np.random.seed(s)`` then ``initialize()`` gives the
  reference's fp32 weights bit for bit;
- §C 6: the multi-card refusals cite ROADMAP §A 11, and ``fit``'s
  ``resume_from=`` and ``MXNET_SNAPSHOT_EVERY``, which cited §A 7 with
  §A 11's asynchronous checkpoint, now work;
- §C 7: ``LeakyReLU(act_type="rrelu")`` takes the midpoint slope in
  training and inference.

Values are held exactly where both packages compute one correctly
rounded operation on special values; the few transcendental results at
ordinary points (the gradients of the unary functions at ±0, a softmax)
to 4 fp32 ulps.  That the card's process survives the same
out-of-range indices is a card test (``tests/test_torch_cuda.py``,
which runs without JAX on the card's host).
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import elemwise as j_elemwise  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

ULPS = 4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _same(got, want, ulps=0):
    """``got`` equals ``want``: NaN where it is NaN, infinities and the
    signs of zeros equal, finite values within ``ulps`` fp32 ulps."""
    g, w = onp.asarray(got), onp.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype,
                                                      g.shape, w.shape)
    if not onp.issubdtype(w.dtype, onp.floating):
        onp.testing.assert_array_equal(g, w)
        return
    nan = onp.isnan(w)
    assert (onp.isnan(g) == nan).all(), (g, w)
    g, w = g[~nan], w[~nan]
    assert (onp.signbit(g) == onp.signbit(w)).all(), (g, w)
    fin = onp.isfinite(w)
    assert (g[~fin] == w[~fin]).all(), (g, w)
    tol = ulps * onp.spacing(onp.abs(w[fin]).astype(w.dtype))
    assert (onp.abs(g[fin] - w[fin]) <= tol).all(), (g, w)


def _run(pkg, name, arrays, params, grad_of=(), head=None):
    """``name`` on ``arrays`` under ``record()``; (output, gradients of
    the inputs in ``grad_of``) as numpy."""
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    for i in grad_of:
        xs[i].attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.invoke(name, xs, **params)
    if grad_of:
        y.backward(None if head is None else pkg.nd.array(head))
    return y.asnumpy(), [xs[i].grad.asnumpy() for i in grad_of]


def _both(name, arrays, params=None, grad_of=(), head=None, ulps=0):
    want = _run(jmx, name, arrays, params or {}, grad_of, head)
    got = _run(tmx, name, arrays, params or {}, grad_of, head)
    _same(got[0], want[0], ulps)
    for g, w in zip(got[1], want[1]):
        _same(g, w, ulps)
    return got


# ------------------------------------------------- §C 1: out of range
def _span(n):
    """Every index from -n-1 to n+2 (float, as the reference's labels)."""
    return onp.arange(-n - 1, n + 3, dtype=onp.float32)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_pick_out_of_range_is_nan_as_the_reference(axis, mode):
    x = onp.arange(12, dtype=onp.float32).reshape(3, 4) + 1
    n = x.shape[axis]
    idx = _span(n)
    other = x.shape[1 - axis % 2]
    # one pick per index: tile the other axis to the indices' count
    reps = (1, len(idx) // other + 1) if axis % 2 == 0 \
        else (len(idx) // other + 1, 1)
    xt = onp.tile(x, reps)
    xt = xt[:, :len(idx)] if axis % 2 == 0 else xt[:len(idx)]
    out, _ = _both("pick", [xt, idx], dict(axis=axis, mode=mode),
                   grad_of=(0,))
    assert onp.isnan(out).sum() == 4  # -n-1, n, n+1 and n+2


def test_pick_integer_data_takes_the_type_minimum():
    x = onp.arange(6, dtype=onp.int32).reshape(2, 3)
    out, _ = _both("pick", [x, onp.array([0, 5], onp.float32)], {})
    assert out[1] == onp.iinfo(onp.int32).min


def test_embedding_out_of_range_rows_are_nan_negative_wrap():
    w = onp.arange(8, dtype=onp.float32).reshape(4, 2) - 3
    idx = _span(4)
    out, (gw,) = _both("Embedding", [idx, w],
                       dict(input_dim=4, output_dim=2), grad_of=(1,))
    assert onp.isnan(out).all(axis=1).sum() == 4
    onp.testing.assert_array_equal(out[idx == -1], w[3:4])
    assert gw.sum() == 2 * 8  # the 8 rows in range, each a row of ones


def test_batch_take_out_of_range_is_nan():
    x = onp.arange(20, dtype=onp.float32).reshape(10, 2)
    idx = onp.array([-3, -2, -1, 0, 1, 2, 3, 0, 1, 5], onp.float32)
    _both("batch_take", [x, idx.astype(onp.int32)], {})


def test_gather_nd_clamps_as_the_reference():
    x = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    rows, cols = onp.meshgrid(_span(3), _span(4), indexing="ij")
    idx = onp.stack([rows.reshape(-1), cols.reshape(-1)])
    out, (gx,) = _both("gather_nd", [x, idx], grad_of=(0,))
    assert not onp.isnan(out).any()
    # the gradient drops the indices out of range, as the reference's
    assert gx.sum() == 6 * 8


def test_softmax_cross_entropy_label_out_of_range_is_nan():
    pred = onp.linspace(-2, 2, 8 * 3, dtype=onp.float32).reshape(8, 3)
    label = onp.array([0, 1, 2, 3, 7, -1, -3, -4], onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        p = pkg.nd.array(pred)
        p.attach_grad()
        with pkg.autograd.record():
            loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
                p, pkg.nd.array(label))
        loss.backward()
        res[pkg] = loss.asnumpy(), p.grad.asnumpy()
    _same(res[tmx][0], res[jmx][0], ULPS)
    _same(res[tmx][1], res[jmx][1], ULPS)
    assert onp.isnan(res[tmx][0]).sum() == 3  # labels 3, 7 and -4


# --------------------------------------------------------- §C 2: ±0
_UNARY = sorted(j_elemwise._UNARY)
_ZEROS = onp.array([0.0, -0.0], onp.float32)


@pytest.mark.parametrize("name", _UNARY)
def test_unary_at_signed_zero_matches_reference(name):
    """Value and gradient at +0 and -0 (``logical_not`` has no
    gradient)."""
    grad_of = () if name == "logical_not" else (0,)
    _both(name, [_ZEROS], grad_of=grad_of, ulps=ULPS)


@pytest.mark.parametrize("name", ["_power", "broadcast_power"])
def test_power_gradients_at_zero_match_reference(name):
    base = onp.array([0.0, -0.0, 0.0, 2.0, 0.5, 3.0], onp.float32)
    expo = onp.array([0.0, 0.0, 2.0, 0.0, -1.0, 1.5], onp.float32)
    _, (gb, ge) = _both(name, [base, expo], grad_of=(0, 1), ulps=ULPS)
    assert onp.isnan(gb[:2]).all()  # 0 · 0^-1 in the base


def test_abs_gradient_is_one_at_zero_l1_term():
    """An L1 term with exact zero residuals: d|r|/dr = 1 at ±0."""
    r = onp.array([0.0, -0.0, 1.5, -2.0], onp.float32)
    _, (g,) = _both("abs", [r], grad_of=(0,))
    onp.testing.assert_array_equal(g, [1, 1, 1, -1])


# ------------------------------------------- §C 3: integer heads
@pytest.mark.parametrize("dtype", ["int32", "uint8", "int8"])
def test_backward_from_an_integer_head_gives_zero_gradient(dtype):
    x0 = onp.array([1.5, -2.5, 3.0], onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Cast(x * 2 + 1, dtype=dtype)
        y.backward()
        res[pkg] = y.asnumpy(), x.grad.asnumpy()
    for g, w in zip(res[tmx], res[jmx]):
        _same(g, w)
    onp.testing.assert_array_equal(res[tmx][1], 0.0)


def test_integer_head_beside_a_float_head():
    x0 = onp.array([1.5, -2.5], onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            a = pkg.nd.Cast(x, dtype="int32")
            b = x * 3
        pkg.autograd.backward([a, b])
        res[pkg] = x.grad.asnumpy()
    _same(res[tmx], res[jmx])


# --------------------------------------- §C 4: integer and bool inputs
_B = onp.array([[True, False, True], [False, False, True]])
_I = onp.array([[1, -2, 3], [0, 4, -1]])
_F = onp.array([[0.5, -1.0, 2.0], [3.0, 0.0, -0.5]], onp.float32)
_X6 = (onp.arange(36).reshape(1, 1, 6, 6) - 10).astype("int32")
_I2 = onp.array([[1, -2, 3], [0, 2, 1]], "int32")
_DTYPE_CASES = [
    *[("softmax", [_I.astype(d)], {}, ULPS)
      for d in ("int8", "uint8", "int32", "int64")],
    ("log_softmax", [_I.astype("int32")], {}, ULPS),
    ("softmin", [_I.astype("int32")], {}, ULPS),
    ("broadcast_sub", [_F, _B], {}, 0),
    ("broadcast_sub", [_B, _F], {}, 0),
    ("broadcast_sub", [_I.astype("int32"), _B], {}, 0),
    ("broadcast_power", [_B, _B], {}, 0),
    ("broadcast_mod", [_B, _B], {}, 0),
    ("broadcast_mod", [_I.astype("int32"), _I.astype("int32") * 0], {}, 0),
    ("relu", [_B], {}, 0),
    ("abs", [_B], {}, 0),
    ("square", [_B], {}, 0),
    ("argmax", [_B], {}, 0),
    ("argmax", [_B], dict(axis=1), 0),
    ("argmin", [_B], dict(axis=0), 0),
    # §C 8: windowed avg in float32 and sum in int32, a global sum in
    # int32; the softmax layers give float32; bool unary ops float32
    *[("Pooling", [_X6], p, 0) for p in (
        dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="sum"),
        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
             count_include_pad=False),
        dict(global_pool=True, pool_type="sum"),
        dict(global_pool=True, pool_type="avg"),
        dict(kernel=(2, 2), stride=(2, 2), pool_type="max"))],
    ("SoftmaxActivation", [_I2], {}, ULPS),
    ("SoftmaxActivation", [_I2], dict(mode="channel"), ULPS),
    ("SoftmaxOutput", [_I2, onp.array([0, 1], onp.float32)], {}, ULPS),
    ("softsign", [_B], {}, 0),
    ("smooth_l1", [_B], {}, 0),
    ("argmax_channel", [_B], {}, 0),
]


@pytest.mark.parametrize("case", range(len(_DTYPE_CASES)))
def test_integer_and_bool_inputs_match_reference(case):
    name, arrays, params, ulps = _DTYPE_CASES[case]
    _both(name, arrays, params, ulps=ulps)


# ------------------------------------------------- §C 5: initializers
def _init_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, in_channels=2,
                          weight_initializer=pkg.init.Xavier(
                              rnd_type="gaussian", factor_type="out",
                              magnitude=2)))
        net.add(nn.Conv2D(3, 1, in_channels=4,
                          weight_initializer=pkg.init.MSRAPrelu()))
        net.add(nn.Dense(5, in_units=3 * 4 * 4,
                         weight_initializer="normal"))
        net.add(nn.Dense(6, in_units=5,
                         weight_initializer=pkg.init.Orthogonal()))
        net.add(nn.Dense(2))  # deferred: drawn at the first forward
    return net


@pytest.mark.parametrize("init", [None, "xavier"])
def test_numpy_seed_gives_the_reference_weights_bit_for_bit(init):
    x = onp.random.RandomState(0).rand(2, 2, 6, 6).astype(onp.float32)
    weights = {}
    for pkg in (jmx, tmx):
        net = _init_net(pkg)
        onp.random.seed(42)
        net.initialize(None if init is None else pkg.init.Xavier())
        net(pkg.nd.array(x))
        weights[pkg] = {n: p.data().asnumpy()
                        for n, p in net.collect_params().items()}
    assert list(weights[tmx]) == list(weights[jmx])
    for n, w in weights[jmx].items():
        assert weights[tmx][n].dtype == w.dtype == onp.float32
        assert weights[tmx][n].tobytes() == w.tobytes(), n


def test_a_callers_generator_still_draws_the_weights():
    state = onp.random.get_state()[1].copy()
    nets = []
    for _ in range(2):
        net = _init_net(tmx)
        net.initialize(generator=torch.Generator().manual_seed(3))
        net(tmx.nd.ones((1, 2, 6, 6)))
        nets.append({n: p.data().asnumpy()
                     for n, p in net.collect_params().items()})
    for n in nets[0]:
        onp.testing.assert_array_equal(nets[0][n], nets[1][n])
    # numpy's global stream is not touched
    onp.testing.assert_array_equal(onp.random.get_state()[1], state)


# ----------------------------------------------------- §C 6: labels
def test_multi_card_refusals_cite_the_multi_card_item():
    """What still refuses several devices cites where it waits: a
    parameter over several devices the distributed Module (§A 11 item
    4), a mesh over several devices within one process the process
    mesh's §C entry.  The shard-spanning pieces are ported: a stage-1
    request without a mesh stays replicated, an axis name over a world
    of one sums nothing, a bucket cut into shards updates its own."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.parameter import _device_of
    from mxnet_tpu_torch.parallel import zero

    with pytest.raises(MXNetError, match=r"ROADMAP §C, the process mesh"):
        parallel.get_mesh(devices=["cpu", "cpu"])
    with pytest.warns(UserWarning, match="needs a mesh"):
        assert parallel._resolve_ps_mode("ps", 1, None) is False
    with pytest.raises(MXNetError, match=r"ROADMAP §A 11 item 4\)"):
        _device_of([tmx.cpu(), tmx.cpu()])
    sgd = optimizer.SGD(learning_rate=0.1)
    w = torch.ones(4)
    new_w, _ = sgd.fused_bucket_update(w, w, sgd.fused_state(w), 1.0,
                                       axis_name="data")
    assert torch.allclose(new_w, w * 0.9)
    plan = zero.plan_buckets({"a_weight": w}, 2)
    _, uw, _ = zero.bucket_shard_update(
        plan[0], sgd, {"a_weight": w}, w[:2], sgd.fused_state(w[:2]), 1.0,
        n_shards=2, idx=1, pallas=False)
    assert torch.allclose(uw, w[2:] * 0.9)
    assert "§C" in parallel.get_mesh.__doc__


@pytest.mark.parametrize("what", ["resume_from", "snapshot"])
def test_fit_resume_refusals_cite_a7_with_a11(what, monkeypatch, tmp_path):
    """The refusals that cited ROADMAP §A 7 with §A 11's asynchronous
    checkpoint are gone with it: ``resume_from=`` restores a fit from
    its checkpoint (and raises only when there is none to restore), and
    ``MXNET_SNAPSHOT_EVERY`` takes snapshots mid-epoch; the knob's doc
    cites no open item."""
    from mxnet_tpu_torch.config import _ENV
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    x = onp.zeros((8, 4), "float32")
    y = onp.zeros((8,), "float32")
    it = tmx.io.NDArrayIter(x, y, batch_size=4)
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(data, num_hidden=2, name="fc"),
        tmx.sym.Variable("softmax_label"), name="softmax")
    prefix = str(tmp_path / "ck")
    with tmx.cpu():
        if what == "resume_from":
            with pytest.raises(MXNetError, match="no verifiable checkpoint"):
                tmx.mod.Module(net).fit(it, num_epoch=1,
                                        resume_from=str(tmp_path))
            tmx.mod.Module(net).fit(it, num_epoch=1, checkpoint=prefix)
            mod = tmx.mod.Module(net)
            mod.fit(it, num_epoch=2, resume_from=prefix)
            assert mod.params_initialized
        else:
            monkeypatch.setenv("MXNET_SNAPSHOT_EVERY", "1")
            tmx.mod.Module(net).fit(it, num_epoch=1, checkpoint=prefix)
            mgr = CheckpointManager(prefix)
            assert [mgr.load(e)["batch_cursor"] for e in mgr.epochs()] \
                == [1, 2, 0]
    assert "§A" not in _ENV["MXNET_SNAPSHOT_EVERY"].doc


# ----------------------------------------------------- §C 7: rrelu
@pytest.mark.parametrize("train", [True, False])
def test_rrelu_takes_the_midpoint_slope(train):
    x = onp.linspace(-3, 3, 13, dtype=onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record(train_mode=train):
            y = pkg.nd.LeakyReLU(a, act_type="rrelu", lower_bound=0.1,
                                 upper_bound=0.3)
        y.backward()
        res[pkg] = y.asnumpy(), a.grad.asnumpy()
    for g, w in zip(res[tmx], res[jmx]):
        _same(g, w)
    onp.testing.assert_allclose(res[tmx][0][x < 0], 0.2 * x[x < 0],
                                rtol=1e-6)

