"""The port's autograd (``mxnet_tpu_torch/autograd.py``, on
``torch.autograd``) held against the JAX package's tape on the CPU.

Every differentiable op of ``ops/{elemwise,reduce,shape_ops}.py`` gives
the reference's input gradients for ``sum(op(inputs) * w)`` (w fixed
random weights), to rtol 1e-5 / atol 1e-6: the two packages' gradient
formulas round differently (XLA's lgamma-based ones up to 2e-5
relative, see ``_LOOSE``).  The grad_req modes, ``pause`` and the
training flag, ``grad(create_graph=True)`` second derivatives and the
non-differentiable ops behave as the reference's.
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import autograd as jag  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402
from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

from test_torch_ndarray import _ALL, _case, _host  # noqa: E402

BOTH = ((jnd, jag), (tnd, tag))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _float(a):
    return onp.issubdtype(onp.asarray(a).dtype, onp.floating)


_DIFF = [n for n in _ALL if jreg.get_op(n).differentiable
         and jreg.get_op(n).name not in ("Cast", "shape_array",
                                         "size_array")]
#: gradients through lgamma/digamma: XLA's are within 2e-5 relative
_LOOSE = {"gamma", "gammaln"}


def _grads(nd, ag, name, arrays, params, seed=0):
    xs = [nd.array(a, dtype=a.dtype) for a in arrays]
    for x in xs:
        if _float(x.asnumpy()):
            x.attach_grad()
    with ag.record():
        out = nd.invoke(name, xs, **params)
        outs = out if isinstance(out, (list, tuple)) else [out]
        r = onp.random.RandomState(seed)
        loss = None
        for o in outs:
            w = nd.array(onp.asarray(r.randn(*o.shape), dtype="float32"))
            term = (o.astype("float32") * w).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [x.grad for x in xs if x.grad is not None]


@pytest.mark.parametrize("name", _DIFF)
def test_op_gradients_match_reference(name):
    arrays, params = _case(name)
    want = _grads(jnd, jag, name, arrays, params)
    got = _grads(tnd, tag, name, arrays, params)
    assert len(got) == len(want) > 0
    tol = 2e-5 if jreg.get_op(name).name in _LOOSE else 1e-5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        onp.testing.assert_allclose(_host(g), _host(w), rtol=tol,
                                    atol=tol / 10)


_X = onp.array([[0.5, -1.5, 2.0], [1.0, 3.0, -0.25]], dtype="float32")


def _net(nd, x):
    return (nd.tanh(x) * x + nd.exp(x * 0.5)).sum()


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_reference(req):
    res = []
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad(grad_req=req)
        seen = []
        for _ in range(2):
            with ag.record():
                y = _net(nd, x)
            y.backward()
            seen.append(None if x.grad is None else x.grad.asnumpy())
        res.append(seen)
    for got, want in zip(res[1], res[0]):
        if want is None:
            assert got is None
        else:
            onp.testing.assert_allclose(got, want, rtol=1e-6)
    if req == "add":
        onp.testing.assert_allclose(res[1][1], 2 * res[1][0], rtol=1e-6)


def test_head_grads_and_several_heads():
    res = []
    for nd, ag in BOTH:
        x, y = nd.array(_X), nd.array(_X[::-1].copy())
        x.attach_grad()
        y.attach_grad()
        with ag.record():
            a = x * y
            b = nd.sin(x) + y
        ag.backward([a, b], [nd.ones_like(a) * 2, nd.array(_X)])
        res.append((x.grad.asnumpy(), y.grad.asnumpy()))
    for g, w in zip(res[1], res[0]):
        onp.testing.assert_allclose(g, w, rtol=1e-6)


def test_pause_and_training_flags():
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad()
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            y = x * 2
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
                z = y * 3  # a constant to the tape
            with ag.pause(train_mode=True):
                assert ag.is_training()
            w = (y + z).sum()
        w.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), onp.full((2, 3), 2.))
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True

        @ag.record()
        def taped():
            return ag.is_recording()

        assert taped() and not ag.is_recording()


def test_second_derivative_matches_reference():
    res = []
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad()
        with ag.record():
            y = x * x * x + nd.sin(x)
            g = ag.grad(y, x, create_graph=True)  # 3x^2 + cos x
            z = (g * g).sum()
        z.backward()  # 2 g (6x - sin x)
        res.append((g.asnumpy(), x.grad.asnumpy()))
    xn = _X.astype("float64")
    g = 3 * xn ** 2 + onp.cos(xn)
    onp.testing.assert_allclose(res[1][0], g, rtol=1e-6)
    onp.testing.assert_allclose(res[1][1], 2 * g * (6 * xn - onp.sin(xn)),
                                rtol=1e-5)
    for got, want in zip(res[1], res[0]):
        onp.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_of_several_variables_and_unused():
    res = []
    for nd, ag in BOTH:
        x, y, u = nd.array(_X), nd.array(_X + 1), nd.array(_X)
        for v in (x, y, u):
            v.attach_grad()
        with ag.record():
            z = (x * y).sum()
        gx, gy, gu = ag.grad(z, [x, y, u])
        res.append([g.asnumpy() for g in (gx, gy, gu)])
        assert x.grad.asnumpy().sum() == 0  # grad() leaves .grad alone
    for got, want in zip(res[1], res[0]):
        onp.testing.assert_array_equal(got, want)


def test_non_differentiable_ops_are_constants():
    res = []
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad()
        with ag.record():
            i = nd.argmax(x, axis=1)  # float32 indices, no gradient
            m = x > 0
            y = (x * m).sum() + (i * x[:, 0]).sum()
            c = nd.one_hot(i, depth=3)
        y.backward()
        res.append(x.grad.asnumpy())
        with pytest.raises((MXNetError, JMXNetError)):
            c.backward()  # not recorded: nothing to differentiate
    onp.testing.assert_array_equal(res[1], res[0])


def test_blocked_and_constant_outputs_get_zero_gradients():
    res = []
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad()
        with ag.record():
            y = (x * 3).sum()
        y.backward()
        with ag.record():
            z = (nd.BlockGrad(x) * x + nd.zeros_like(x)).sum()
            c = nd.stop_gradient(x * 2)
        z.backward()
        first = x.grad.asnumpy().copy()
        c.backward()  # a recorded constant: the gradient is written as 0
        res.append((first, x.grad.asnumpy()))
    for got, want in zip(res[1], res[0]):
        onp.testing.assert_array_equal(got, want)
    onp.testing.assert_array_equal(res[1][1], onp.zeros((2, 3)))


def test_second_backward_needs_retain_graph():
    for nd, ag in BOTH:
        x = nd.array(_X)
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), 2 * _X)
        with pytest.raises((MXNetError, JMXNetError)):
            y.backward()
    with pytest.raises(MXNetError, match="not computed under"):
        tnd.array(_X).backward()


def test_mark_variables_and_variable_heads():
    res = []
    for nd, ag in BOTH:
        x = nd.array(_X)
        gbuf = nd.zeros((2, 3))
        ag.mark_variables([x], [gbuf])
        with ag.record():
            y = nd.square(x)
        y.backward(nd.array(_X))
        res.append(x.grad.asnumpy())
        assert x.grad is gbuf
        v = nd.array(_X)
        v.attach_grad()
        v.backward()  # a variable as its own head: head grad ones
        onp.testing.assert_array_equal(v.grad.asnumpy(), onp.ones((2, 3)))
    onp.testing.assert_allclose(res[1], res[0], rtol=1e-6)


def test_outside_record_nothing_is_taped():
    x = tnd.array(_X)
    x.attach_grad()
    y = x * 2
    assert y._data.grad_fn is None and not y._data.requires_grad
    with tag.record():
        z = tnd.make_loss(x)  # hands back its input: still recorded
    assert z._data.grad_fn is not None
    with pytest.raises(MXNetError, match="get_symbol"):
        tag.get_symbol(z)


def test_integer_variables_get_no_gradient():
    for nd, ag in BOTH:
        i = nd.array([1, 2, 3], dtype="int32")
        x = nd.array([1.0, 2.0, 3.0])
        i.attach_grad()
        x.attach_grad()
        with ag.record():
            y = (x * i).sum()
        y.backward()
        onp.testing.assert_array_equal(x.grad.asnumpy(), [1.0, 2.0, 3.0])
        onp.testing.assert_array_equal(i.grad.asnumpy(), [0, 0, 0])


def test_bf16_gradients_stay_bf16():
    x = tnd.array(_X, dtype="bfloat16")
    x.attach_grad()
    with tag.record():
        y = (x * x).sum()
    y.backward()
    assert x.grad.dtype == torch.bfloat16
    onp.testing.assert_array_equal(x.grad.asnumpy(),
                                   tnd.array(2 * _X, dtype="bfloat16")
                                   .asnumpy())
