"""The port's data iterators (``mx.io``) and initializers held against
the JAX package on the CPU.

``NDArrayIter`` shuffles with numpy's global RNG in both packages, so
one ``np.random.seed`` gives one order: batches, labels, pads and
``provide_*`` are compared exactly, over several epochs of every
``last_batch_handle``.  Initializers that draw no random numbers are
compared exactly; those that do are held to their distribution (the two
packages' random streams differ; values cross with ``set_params``).
"""
import json

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _data(n=23, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, 3, 2).astype("float32"),
            rng.randint(0, 5, n).astype("float32"))


def _epochs(pkg, handle, shuffle, n_epochs=3, batch_size=5, dicts=False):
    x, y = _data()
    onp.random.seed(42)
    data = {"img": x, "aux_in": x[:, 0]} if dicts else x
    label = {"lab": y} if dicts else y
    it = pkg.io.NDArrayIter(data, label, batch_size=batch_size,
                            shuffle=shuffle, last_batch_handle=handle)
    out = {"provide_data": [(d.name, d.shape, onp.dtype(d.dtype).name)
                            for d in it.provide_data],
           "provide_label": [(d.name, d.shape, onp.dtype(d.dtype).name)
                             for d in it.provide_label],
           "epochs": []}
    for _ in range(n_epochs):
        ep = []
        for b in it:
            ep.append(([a.asnumpy() for a in b.data],
                       [a.asnumpy() for a in b.label], b.pad, b.index))
        out["epochs"].append(ep)
        it.reset()
    return out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dicts", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle, dicts):
    j = _epochs(jmx, handle, shuffle, dicts=dicts)
    t = _epochs(tmx, handle, shuffle, dicts=dicts)
    assert t["provide_data"] == j["provide_data"]
    assert t["provide_label"] == j["provide_label"]
    assert [len(e) for e in t["epochs"]] == [len(e) for e in j["epochs"]]
    for te, je in zip(t["epochs"], j["epochs"]):
        for (td, tl, tp, ti), (jd, jl, jp, ji) in zip(te, je):
            assert tp == jp and ti == ji
            for a, b in zip(td + tl, jd + jl):
                assert a.dtype == b.dtype
                onp.testing.assert_array_equal(a, b)


def test_ndarray_iter_batches_stay_on_the_host():
    """The consumer moves a batch to its device; the iterator's batches
    are host arrays whatever the current context."""
    x, y = _data()
    with tmx.gpu(0):
        it = tmx.io.NDArrayIter(x, y, batch_size=4)
        b = next(iter(it))
    assert b.data[0].context == tmx.cpu() and b.label[0].context == tmx.cpu()


def test_ndarray_iter_hard_reset_and_roll_over_cache():
    res = []
    for pkg in (jmx, tmx):
        x, y = _data(n=11)
        it = pkg.io.NDArrayIter(x, y, batch_size=4,
                                last_batch_handle="roll_over")
        first = [b.data[0].asnumpy() for b in it]
        it.reset()
        second = [(b.data[0].asnumpy(), b.pad) for b in it]
        it.hard_reset()
        third = [b.data[0].asnumpy() for b in it]
        res.append((first, second, third))
    for t, j in zip(res[1], res[0]):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            if isinstance(a, tuple):
                assert a[1] == b[1]
                a, b = a[0], b[0]
            onp.testing.assert_array_equal(a, b)


def test_resize_and_prefetching_iters_match_reference():
    res = []
    for pkg in (jmx, tmx):
        x, y = _data()
        base = pkg.io.NDArrayIter(x, y, batch_size=4)
        rs = pkg.io.ResizeIter(base, 9)
        got = [(b.data[0].asnumpy(), b.pad) for b in rs]
        rs.reset()
        got += [(b.data[0].asnumpy(), b.pad) for b in rs]
        kw = {"device_feed": False} if pkg is jmx else {}
        pf = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=6),
             pkg.io.NDArrayIter(x * 2, y, batch_size=6, data_name="d2",
                                label_name="l2")],
            rename_data=[{"data": "a"}, {"d2": "b"}], **kw)
        descs = [(d.name, d.shape) for d in pf.provide_data]
        pre = [([a.asnumpy() for a in b.data], b.pad) for b in pf]
        res.append((got, descs, pre))
    (jg, jd, jp), (tg, td, tp) = res
    assert len(tg) == len(jg) == 18
    for (a, pa), (b, pb) in zip(tg, jg):
        assert pa == pb
        onp.testing.assert_array_equal(a, b)
    assert td == jd == [("a", (6, 3, 2)), ("b", (6, 3, 2))]
    assert len(tp) == len(jp)
    for (a, pa), (b, pb) in zip(tp, jp):
        assert pa == pb
        for u, v in zip(a, b):
            onp.testing.assert_array_equal(u, v)


def test_data_desc_and_batch_match_reference():
    for pkg in (jmx, tmx):
        d = pkg.io.DataDesc("data", (4, 3), "float32", "NC")
        assert (d.name, d.shape, d.dtype, d.layout) == ("data", (4, 3),
                                                        "float32", "NC")
        assert repr(d) == "DataDesc[data,(4, 3),float32,NC]"
        assert pkg.io.DataDesc.get_batch_axis("TNC") == 1
        lst = pkg.io.DataDesc.get_list([("a", (1,))], [("a", "int32")])
        assert lst[0].dtype == "int32"
        b = pkg.io.DataBatch([pkg.nd.ones((2, 3))], [pkg.nd.zeros((2,))],
                             pad=1)
        assert str(b) == ("DataBatch: data shapes: [(2, 3)] label shapes: "
                          "[(2,)]")
    with pytest.raises(AssertionError):
        tmx.io.DataBatch(tmx.nd.ones((1,)))


def test_what_waits_for_the_data_plane_is_absent():
    """The data plane is ported (its parity tests are
    ``tests/test_torch_{recordio,io_iterators,device_feed,
    image_record_iter}.py``); only ``ImageDetRecordIter`` still waits
    (ROADMAP §A 6).  ``PrefetchingIter(device_feed=True)`` feeds the
    current context's device, here the host."""
    for name in ("CSVIter", "LibSVMIter", "MNISTIter", "ImageRecordIter",
                 "DeviceFeedIter"):
        assert hasattr(jmx.io, name) and hasattr(tmx.io, name)
    assert hasattr(jmx.io, "ImageDetRecordIter")
    assert not hasattr(tmx.io, "ImageDetRecordIter")
    pf = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(*_data(), batch_size=5),
                                device_feed=True)
    ref = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(*_data(), batch_size=5),
                                 device_feed=True)
    got = [(b.data[0].asnumpy(), b.pad) for b in pf]
    want = [(b.data[0].asnumpy(), b.pad) for b in ref]
    assert len(got) == len(want) == 5
    for (a, pa), (b, pb) in zip(got, want):
        assert pa == pb
        onp.testing.assert_array_equal(a, b)
    assert all(b.data[0].context == tmx.cpu() for b in [pf.current_batch])


# ---------------------------------------------------------- initializers
def _init(pkg, init, name, shape, attrs=None):
    desc = pkg.init.InitDesc(name, attrs=attrs)
    v = init(desc, shape, "float32")
    return onp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


DETERMINISTIC = {
    "zero": lambda pkg: pkg.init.Zero(),
    "one": lambda pkg: pkg.init.One(),
    "constant": lambda pkg: pkg.init.Constant(0.37),
    "bilinear": lambda pkg: pkg.init.Bilinear(),
    "lstm_bias": lambda pkg: pkg.init.LSTMBias(forget_bias=2.5),
}


@pytest.mark.parametrize("kind", list(DETERMINISTIC))
@pytest.mark.parametrize("name", ["fc_weight", "fc_bias", "bn_gamma",
                                  "bn_moving_var", "bn_running_mean",
                                  "other"])
def test_deterministic_initializers_match_reference(kind, name):
    shape = (8, 2, 4, 4)
    j = _init(jmx, DETERMINISTIC[kind](jmx), name, shape)
    t = _init(tmx, DETERMINISTIC[kind](tmx), name, shape)
    assert t.dtype == j.dtype == onp.float32
    onp.testing.assert_allclose(t, j, rtol=1e-7, atol=0)


def test_initializer_dumps_and_init_attr_match_reference():
    for kind in ("uniform", "normal", "xavier", "msraprelu", "orthogonal",
                 "constant"):
        assert tmx.init.create(kind).dumps() == jmx.init.create(kind).dumps()
    attr = {"__init__": jmx.init.Constant(0.5).dumps()}
    for pkg in (jmx, tmx):
        v = _init(pkg, pkg.init.Uniform(), "x_weight", (3, 3), attr)
        onp.testing.assert_array_equal(v, onp.full((3, 3), 0.5, "float32"))
    # a variable's init attribute lands in the symbol JSON the same way
    j = jmx.sym.var("w", init=jmx.init.Constant(0.5))
    t = tmx.sym.var("w", init=tmx.init.Constant(0.5))
    assert t.tojson() == j.tojson()


def test_load_and_mixed_initializers_match_reference():
    params = {"arg:fc_weight": onp.arange(6, dtype="float32").reshape(2, 3)}
    res = []
    for pkg in (jmx, tmx):
        load = pkg.init.Load({k: pkg.nd.array(v) for k, v in params.items()},
                             default_init=pkg.init.Constant(7.0))
        mixed = pkg.init.Mixed([".*bias", ".*"],
                               [pkg.init.Zero(), pkg.init.Constant(3.0)])
        out = [load("fc_weight", (2, 3)), load("fc2_weight", (2,)),
               mixed("fc_bias", (4,)), mixed("fc_weight", (2,))]
        res.append([onp.asarray(o.numpy() if isinstance(o, torch.Tensor)
                                else o) for o in out])
        with pytest.raises(Exception, match="Shape mismatch"):
            load("fc_weight", (3, 2))
    for a, b in zip(res[1], res[0]):
        onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["uniform", "normal", "xavier_uniform",
                                  "xavier_gaussian", "msraprelu"])
def test_random_initializers_have_the_reference_distribution(kind):
    shape = (256, 64, 3, 3)
    make = {"uniform": lambda p: p.init.Uniform(0.2),
            "normal": lambda p: p.init.Normal(0.3),
            "xavier_uniform": lambda p: p.init.Xavier(magnitude=2.0),
            "xavier_gaussian": lambda p: p.init.Xavier(
                rnd_type="gaussian", factor_type="in"),
            "msraprelu": lambda p: p.init.MSRAPrelu(slope=0.1)}[kind]
    j = _init(jmx, make(jmx), "c_weight", shape)
    g = torch.Generator().manual_seed(0)
    t = make(tmx)(tmx.init.InitDesc("c_weight"), shape, g).numpy()
    assert t.shape == j.shape and t.dtype == onp.float32
    assert abs(t.std() - j.std()) <= 0.02 * j.std()
    assert abs(t.mean()) <= 0.02 * j.std()
    assert abs(onp.abs(t).max() - onp.abs(j).max()) <= 0.1 * onp.abs(j).max()
    # a seed gives the same values again
    again = make(tmx)(tmx.init.InitDesc("c_weight"), shape,
                      torch.Generator().manual_seed(0)).numpy()
    onp.testing.assert_array_equal(t, again)


def test_orthogonal_initializer_is_orthogonal_like_reference():
    for pkg in (jmx, tmx):
        w = _init(pkg, pkg.init.Orthogonal(scale=1.0), "fc_weight", (6, 10))
        onp.testing.assert_allclose(w @ w.T, onp.eye(6), atol=1e-5)
        w = _init(pkg, pkg.init.Orthogonal(scale=2.0, rand_type="normal"),
                  "fc_weight", (10, 4))
        onp.testing.assert_allclose(w.T @ w, 4 * onp.eye(4), atol=1e-4)


def test_gluon_form_of_an_initializer_still_takes_a_generator():
    g = torch.Generator().manual_seed(3)
    a = tmx.init.Xavier()(tmx.init.InitDesc("w_weight"), (4, 5), g)
    b = tmx.init.Xavier()(tmx.init.InitDesc("w_weight"), (4, 5),
                          torch.Generator().manual_seed(3))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    c = tmx.init.Xavier()(tmx.init.InitDesc("w_weight"), (4, 5), "float64")
    assert c.dtype == torch.float64
    with pytest.raises(MXNetError, match="unknown initializer"):
        tmx.init.create("bogus")
    fn = tmx.init.create(lambda name, out: out.fill(2.0))
    onp.testing.assert_array_equal(fn("x_weight", (2,)).numpy(), [2.0, 2.0])
    assert json.loads(tmx.init.MSRAPrelu().dumps()) == [
        "msraprelu", {"factor_type": "avg", "slope": 0.25}]
