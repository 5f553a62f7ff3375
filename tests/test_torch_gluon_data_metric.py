"""The port's ``metric`` and ``gluon.data`` held against the JAX package
on the CPU.

Metrics are host numpy over ``asnumpy()`` in both packages, the same
arithmetic: every value must be equal (to 1e-12 relative, for the
float64 sums).  ``DataLoader`` batches must be equal, dtypes included,
under ``numpy.random.seed`` (``RandomSampler`` shuffles with numpy's
global RNG); the reference's loader runs with its device feed off.  The
port's loader batches on the host and refuses the device feed and
worker processes.
"""
import math

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import metric as j_metric  # noqa: E402
from mxnet_tpu import nd as j_nd  # noqa: E402
from mxnet_tpu.gluon import data as j_data  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import metric as t_metric  # noqa: E402
from mxnet_tpu_torch import nd as t_nd  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon import data as t_data  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _softmax(z):
    e = onp.exp(z - z.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype("float32")


def _inputs(kind, seed):
    """(labels, preds) as numpy lists of two batches."""
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "class":
            p = _softmax(rng.randn(12, 5))
            y = rng.randint(0, 5, 12).astype("float32")
        elif kind == "binary":
            p = _softmax(rng.randn(12, 2))
            y = rng.randint(0, 2, 12).astype("float32")
        elif kind == "seq":
            p = _softmax(rng.randn(3, 4, 6))
            y = rng.randint(0, 6, (3, 4)).astype("float32")
        else:  # regression
            p = rng.randn(12, 3).astype("float32")
            y = (p + 0.3 * rng.randn(12, 3)).astype("float32")
        out.append((y, p))
    return out


METRICS = {
    "accuracy": ("class", lambda m: m.Accuracy()),
    "top_k": ("class", lambda m: m.TopKAccuracy(top_k=3)),
    "cross_entropy": ("class", lambda m: m.CrossEntropy()),
    "nll": ("class", lambda m: m.NegativeLogLikelihood()),
    "loss": ("regression", lambda m: m.Loss()),
    "f1_macro": ("binary", lambda m: m.F1()),
    "f1_micro": ("binary", lambda m: m.F1(average="micro")),
    "mcc": ("binary", lambda m: m.MCC()),
    "mae": ("regression", lambda m: m.MAE()),
    "mse": ("regression", lambda m: m.MSE()),
    "rmse": ("regression", lambda m: m.RMSE()),
    "pearsonr": ("regression", lambda m: m.PearsonCorrelation()),
    "perplexity": ("seq", lambda m: m.Perplexity(ignore_label=None)),
    "perplexity_ignore": ("seq", lambda m: m.Perplexity(ignore_label=2)),
    "create_acc": ("class", lambda m: m.create("acc")),
    "create_list": ("class", lambda m: m.create(["acc", "ce"])),
    "composite": ("class", lambda m: m.CompositeEvalMetric(
        [m.Accuracy(), m.TopKAccuracy(top_k=2), "nll_loss"])),
    "custom_np": ("regression", lambda m: m.np(
        lambda y, p: float(onp.abs(y - p).max()), name="maxabs")),
}


def _close(a, b):
    """Equal structure and names; numbers to 1e-12 (NaN, a metric with
    no data, equals NaN)."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    if isinstance(a, str):
        assert a == b
        return
    a, b = float(a), float(b)
    assert (math.isnan(a) and math.isnan(b)) or \
        abs(a - b) <= 1e-12 * max(abs(b), 1.0), (a, b)


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_reference(name):
    kind, make = METRICS[name]
    jm, tm = make(j_metric), make(t_metric)
    for y, p in _inputs(kind, 3):
        jm.update([j_nd.array(y)], [j_nd.array(p)])
        tm.update([t_nd.array(y)], [t_nd.array(p)])
        _close(tm.get(), jm.get())
    _close(tm.get_name_value(), jm.get_name_value())
    tm.reset()
    jm.reset()
    _close(tm.get(), jm.get())


def test_metric_registry_and_refusals():
    with pytest.raises(MXNetError, match="not registered"):
        t_metric.create("bogus")
    acc = t_metric.Accuracy()
    assert t_metric.create(acc) is acc
    assert t_metric.Accuracy().get_config() == \
        j_metric.Accuracy().get_config()
    with pytest.raises(MXNetError, match="Shape of labels"):
        acc.update([t_nd.array([1.0])], [t_nd.array([[0.1, 0.9]])] * 2)


def _dataset(pkg):
    rng = onp.random.RandomState(4)
    x = rng.rand(23, 3, 2).astype("float32")
    y = rng.randint(0, 5, 23)  # int64: narrowed to int32 in both
    return pkg.ArrayDataset(x, y)


def _batches(loader):
    out = []
    for batch in loader:
        out.append([(b.asnumpy(), str(b.asnumpy().dtype), b.shape)
                    for b in batch])
    return out


LOADERS = {
    "sequential": dict(batch_size=5),
    "shuffle": dict(batch_size=5, shuffle=True),
    "discard": dict(batch_size=4, shuffle=True, last_batch="discard"),
    "rollover": dict(batch_size=4, last_batch="rollover"),
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_dataloader_batches_match_reference(case):
    kw = LOADERS[case]
    jl = j_data.DataLoader(_dataset(j_data), device_feed=False, **kw)
    tl = t_data.DataLoader(_dataset(t_data), **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):
        onp.random.seed(10 + epoch)
        want = _batches(jl)
        onp.random.seed(10 + epoch)
        got = _batches(tl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for (ga, gd, gs), (wa, wd, ws) in zip(g, w):
                assert gd == wd and gs == ws
                assert onp.array_equal(ga, wa)
    for batch in tl:
        assert all(b.context == tmx.cpu() for b in batch)


def test_dataset_transforms_and_samplers_match_reference():
    for lazy in (True, False):
        jd = _dataset(j_data).transform_first(lambda x: x * 2.0, lazy)
        td = _dataset(t_data).transform_first(lambda x: x * 2.0, lazy)
        assert len(td) == len(jd)
        for i in (0, 7, 22):
            for a, b in zip(td[i], jd[i]):
                assert onp.array_equal(onp.asarray(a), onp.asarray(b))
    jd = _dataset(j_data).transform(lambda x, y: (x.sum(), y + 1))
    td = _dataset(t_data).transform(lambda x, y: (x.sum(), y + 1))
    assert [td[i] for i in range(5)] == [jd[i] for i in range(5)]
    assert len(_dataset(t_data).shard(4, 1)) == \
        len(_dataset(j_data).shard(4, 1))
    assert len(_dataset(t_data).take(3)) == 3
    assert len(_dataset(t_data).filter(lambda s: s[1] > 2)) == \
        len(_dataset(j_data).filter(lambda s: s[1] > 2))
    onp.random.seed(5)
    want = list(j_data.RandomSampler(17))
    onp.random.seed(5)
    assert list(t_data.RandomSampler(17)) == want
    for last in ("keep", "discard", "rollover"):
        jb = j_data.BatchSampler(j_data.SequentialSampler(10), 3, last)
        tb = t_data.BatchSampler(t_data.SequentialSampler(10), 3, last)
        assert list(tb) == list(jb) and len(tb) == len(jb)
    # NDArray samples stack, on the host
    nd_ds = t_data.SimpleDataset([t_nd.array(onp.full((2,), i, "float32"))
                                  for i in range(4)])
    (batch,) = [b for b in t_data.DataLoader(nd_ds, batch_size=4)]
    assert batch.shape == (4, 2) and batch.context == tmx.cpu()
    assert torch.equal(batch._data[:, 0], torch.arange(4.0))


@pytest.mark.parametrize("kw", [dict(device_feed=True),
                                dict(num_workers=2)])
def test_dataloader_refuses_what_is_not_ported(kw):
    """Ported since: the device feed and worker processes give the
    reference's batches (more cases in
    ``tests/test_torch_dataloader_workers.py``)."""
    jl = j_data.DataLoader(_dataset(j_data), batch_size=4, shuffle=True,
                           **kw)
    tl = t_data.DataLoader(_dataset(t_data), batch_size=4, shuffle=True,
                           **kw)
    onp.random.seed(3)
    want = _batches(jl)
    onp.random.seed(3)
    got = _batches(tl)
    tl.close()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for (ga, gd, gs), (wa, wd, ws) in zip(g, w):
            assert gd == wd and gs == ws
            assert onp.array_equal(ga, wa)
