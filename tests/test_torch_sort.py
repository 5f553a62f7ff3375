"""The port's ordering ops (``ops/sort_ops.py``: ``sort``, ``argsort``,
``topk`` and their NDArray methods) held against the JAX package on the
CPU.

Inputs are numpy from a seed, with ties (small integers), signed zeros
and NaNs of both signs.  Tolerance: none.  Indices equal, values equal
bit for bit (the sign of a zero or a NaN included), every ``ret_typ``,
both directions, ``axis=None``; the gradient of ``sort`` exactly.  One
divergence is pinned: ``topk``'s mask along an axis that is not the
last (the reference's has another shape; the port's is upstream's).
"""
import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.ops import sort_ops  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _inputs(kind, shape, seed):
    rs = onp.random.RandomState(seed)
    if kind == "random":
        return rs.randn(*shape).astype("float32")
    if kind == "ties":
        return rs.randint(0, 3, shape).astype("float32")
    if kind == "int32":
        return rs.randint(-4, 4, shape).astype("int32")
    # signed zeros, NaNs of both signs, infinities and ties
    pool = onp.array([0.0, -0.0, 1.0, -1.0, onp.nan, -onp.float32(onp.nan),
                      onp.inf, -onp.inf, 2.0], "float32")
    return pool[rs.randint(0, len(pool), shape)]


def _same_bits(got, want):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        onp.testing.assert_array_equal(onp.signbit(got), onp.signbit(want))
        onp.testing.assert_array_equal(onp.isnan(got), onp.isnan(want))
    onp.testing.assert_array_equal(got, want)


def _both(name, x, **params):
    j = getattr(jmx.nd, name)(jmx.nd.array(x, dtype=x.dtype), **params)
    t = getattr(tmx.nd, name)(tmx.nd.array(x, dtype=x.dtype), **params)
    j = j if isinstance(j, list) else [j]
    t = t if isinstance(t, list) else [t]
    return [a.asnumpy() for a in j], [a.asnumpy() for a in t]


KINDS = ["random", "ties", "special", "int32"]
AXES = [(-1, (3, 17)), (0, (11, 4)), (1, (2, 9, 5)), (None, (4, 6))]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axis,shape", AXES)
@pytest.mark.parametrize("is_ascend", [True, False])
def test_sort_and_argsort_match_reference(kind, axis, shape, is_ascend):
    x = _inputs(kind, shape, seed=len(shape) + 3)
    for name, kw in (("sort", {}), ("argsort", {}),
                     ("argsort", {"dtype": "int32"})):
        j, t = _both(name, x, axis=axis, is_ascend=is_ascend, **kw)
        _same_bits(t[0], j[0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axis,shape", AXES)
@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("ret_typ", ["indices", "value", "mask", "both"])
def test_topk_matches_reference(kind, axis, shape, is_ascend, ret_typ):
    x = _inputs(kind, shape, seed=len(shape) + 5)
    k = 3
    j, t = _both("topk", x, axis=axis, k=k, ret_typ=ret_typ,
                 is_ascend=is_ascend)
    assert len(t) == len(j)
    if ret_typ == "mask" and axis not in (-1, None):
        # a divergence, pinned: along an axis that is not the last, the
        # reference sums its one-hot over the wrong axis (its mask has
        # another shape); the port's is upstream's, 1 at the top k
        assert j[0].shape != x.shape
        idx = _both("topk", x, axis=axis, k=k, is_ascend=is_ascend)[0][0]
        want = onp.zeros_like(x)
        onp.put_along_axis(want, idx.astype("int64"), 1, axis)
        j = [want]
    for a, b in zip(t, j):
        _same_bits(a, b)


@pytest.mark.parametrize("dtype", ["uint8", "bool"])
def test_topk_mask_keeps_the_input_dtype_where_the_reference_promotes(
        dtype):
    """A divergence, pinned (ROADMAP §C 9): the port's mask has the
    input's dtype, as upstream's does; the reference's one-hot ``sum``
    promotes it (uint32 for uint8, int32 for bool).  The values agree."""
    x = (onp.arange(12).reshape(3, 4) * 7 % 5).astype(dtype)
    j, t = _both("topk", x, axis=-1, k=2, ret_typ="mask")
    assert t[0].dtype == onp.dtype(dtype)
    assert j[0].dtype == onp.dtype("uint32" if dtype == "uint8"
                                   else "int32")
    onp.testing.assert_array_equal(t[0].astype("int64"),
                                   j[0].astype("int64"))


def test_ties_order_is_the_reference_one():
    """Descending sort puts the highest index first among ties (a flip
    of the stable order), topk the lowest in both directions."""
    x = onp.array([[1.0, 2.0, 2.0, 1.0, 2.0]], "float32")
    t = tmx.nd.array(x)
    assert t.argsort(is_ascend=False).asnumpy().tolist() == \
        [[4.0, 2.0, 1.0, 3.0, 0.0]]
    assert t.topk(k=5).asnumpy().tolist() == [[1.0, 2.0, 4.0, 0.0, 3.0]]
    assert t.topk(k=5, is_ascend=True).asnumpy().tolist() == \
        [[0.0, 3.0, 1.0, 2.0, 4.0]]
    j = jmx.nd.array(x)
    assert j.argsort(is_ascend=False).asnumpy().tolist() == \
        t.argsort(is_ascend=False).asnumpy().tolist()


def test_methods_and_dtype():
    x = onp.random.RandomState(0).randn(3, 8).astype("float32")
    t, j = tmx.nd.array(x), jmx.nd.array(x)
    for m, kw in (("topk", dict(k=2, ret_typ="value")),
                  ("sort", dict(axis=0)), ("argsort", dict(dtype="int64"))):
        got = getattr(t, m)(**kw).asnumpy()
        want = getattr(j, m)(**kw).asnumpy()
        onp.testing.assert_array_equal(got, want)
    assert t.argsort(dtype="int64").dtype == onp.int64
    assert t.topk().dtype == onp.float32


def test_sort_gradient_matches_reference():
    x = _inputs("ties", (4, 7), seed=2)
    head = onp.random.RandomState(3).randn(4, 7).astype("float32")
    grads = []
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.sort(a, axis=1, is_ascend=False)
        y.backward(pkg.nd.array(head))
        grads.append(a.grad.asnumpy())
    onp.testing.assert_array_equal(grads[1], grads[0])


def test_keys_order_every_float_dtype():
    """The integer keys order float16/bfloat16/float64 as the values."""
    import torch

    v = torch.tensor([3.0, -0.5, 0.0, -0.0, float("inf"), -2.0])
    for dt in (torch.float16, torch.bfloat16, torch.float64):
        idx = sort_ops.stable_argsort(v.to(dt))
        assert idx.tolist() == [5, 1, 2, 3, 0, 4]
