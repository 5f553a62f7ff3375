"""The port's device feed (``io.DeviceFeedIter``, ``as_device_batch``,
``batch_nbytes``) held against the JAX package's on the CPU: the same
stream through both feeds (batches, pads, ``stats()`` byte counts equal
exactly), ``close()`` leaves no producer thread, a producer's error and
an injected ``feed.h2d`` fault reach the consumer as the reference's do.
Every test that waits on a thread has its own time limit (:func:`limited`,
which the other data-plane test files import)."""
import functools
import signal
import threading
import time

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_fs  # noqa: E402
from mxnet_tpu.resilience import faultsim as j_fs  # noqa: E402


def limited(seconds):
    """Fail a test that runs longer than ``seconds`` (SIGALRM in the
    main thread, where pytest and its xdist workers run tests), so a
    hung producer or worker fails its test instead of the run."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past {seconds} s")

            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*a, **kw)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _data(n=22, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, 3, 4).astype("float32"),
            rng.randint(0, 5, n).astype("float32"))


def _feed_threads():
    return [t for t in threading.enumerate() if t.name == "DeviceFeedIter"]


def _run(pkg, kind):
    x, y = _data()
    if kind == "iter":
        base = pkg.io.NDArrayIter(x, y, batch_size=5,
                                  last_batch_handle="pad")
    else:  # a generator of numpy tuples
        base = ((x[i:i + 4], y[i:i + 4]) for i in range(0, 20, 4))
    feed = pkg.io.DeviceFeedIter(base, depth=2)
    out = []
    for b in feed:
        if kind == "iter":
            out.append(([a.asnumpy() for a in b.data + b.label], b.pad))
        else:
            out.append(([onp.asarray(a.asnumpy()) for a in b], None))
    stats = feed.stats()
    feed.close()
    return out, stats


@limited(60)
@pytest.mark.parametrize("kind", ["iter", "generator"])
def test_feed_stream_matches_reference(kind):
    j, js = _run(jmx, kind)
    t, ts = _run(tmx, kind)
    assert len(j) == len(t) > 0
    for (ja, jp), (ta, tp) in zip(j, t):
        assert jp == tp
        for a, b in zip(ja, ta):
            onp.testing.assert_array_equal(a, b)
    assert ts["batches"] == js["batches"] == len(t)
    assert ts["h2d_bytes"] == js["h2d_bytes"] > 0


@limited(60)
def test_reset_replays_and_close_leaves_no_thread():
    x, y = _data()
    base = tmx.io.NDArrayIter(x, y, batch_size=6)
    before = len(_feed_threads())
    feed = tmx.io.DeviceFeedIter(base, depth=1)
    first = [b.data[0].asnumpy() for b in feed]
    feed.reset()
    again = [b.data[0].asnumpy() for b in feed]
    assert len(first) == len(again) == 4
    for a, b in zip(first, again):
        onp.testing.assert_array_equal(a, b)
    feed.reset()
    next(feed)  # the producer is blocked on a full queue now
    feed.close()
    feed.close()  # idempotent
    deadline = time.time() + 5
    while len(_feed_threads()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(_feed_threads()) == before
    with pytest.raises(StopIteration):
        next(feed)
    assert feed.stats()["epochs"] == 2
    assert feed.base is base and feed.provide_data == base.provide_data


@limited(60)
def test_producer_error_reaches_the_consumer():
    def broken():
        yield onp.zeros((2, 2), "float32")
        raise ValueError("source broke")

    for pkg in (jmx, tmx):
        feed = pkg.io.DeviceFeedIter(broken(), depth=2)
        next(feed)
        with pytest.raises(ValueError, match="source broke"):
            next(feed)
        with pytest.raises(StopIteration):
            next(feed)
        feed.close()


@limited(60)
def test_injected_transfer_faults_retry_as_the_reference(monkeypatch):
    """``feed.h2d:raise@1`` is absorbed by the bounded retry in both
    packages; a fault on every attempt reaches the consumer."""
    x, y = _data()
    for spec, absorbed in (("feed.h2d:raise@1", True),
                           ("feed.h2d:raise@1-3", False)):
        got = {}
        for name, pkg, fs in (("j", jmx, j_fs), ("t", tmx, t_fs)):
            fs.reset(spec)
            try:
                feed = pkg.io.DeviceFeedIter(
                    pkg.io.NDArrayIter(x, y, batch_size=11), depth=1)
                try:
                    got[name] = len(list(feed))
                except Exception as exc:  # noqa: BLE001
                    got[name] = type(exc).__name__
                feed.close()
            finally:
                fs.reset("")
        assert got["t"] == got["j"]
        assert (got["t"] == 2) == absorbed


def test_as_device_batch_and_nbytes_match_reference():
    x, y = _data(n=4)
    for pkg in (jmx, tmx):
        b = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)], pad=1,
                             index=onp.arange(4))
        kw = {} if pkg is jmx else {"device": tmx.cpu().torch_device()}
        out = pkg.io.as_device_batch(b, **kw)
        assert out.pad == 1 and list(out.index) == [0, 1, 2, 3]
        onp.testing.assert_array_equal(out.data[0].asnumpy(), x)
        assert pkg.io.device_feed.batch_nbytes(out) == x.nbytes + y.nbytes
        lst = pkg.io.as_device_batch([x, (y,)], **kw)
        assert isinstance(lst, list) and isinstance(lst[1], tuple)
    assert tmx.io.device_feed_enabled() == jmx.io.device_feed_enabled()


@limited(60)
def test_fit_takes_the_feed_and_reports_it(tmp_path):
    """Module.fit wraps train_data in the feed (the reference's default),
    closes it and hands the iterator back reset; the step records carry
    the feed's wait and bytes, as the reference's do."""
    from mxnet_tpu.telemetry import schema as j_schema
    from mxnet_tpu_torch import telemetry as t_tm

    rng = onp.random.RandomState(2)
    x = rng.randn(32, 6).astype("float32")
    y = rng.randint(0, 3, 32).astype("float32")
    it = tmx.io.NDArrayIter(x, y, batch_size=8)
    s = tmx.sym
    net = s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                           num_hidden=3, name="fc"),
                          name="softmax")
    before = len(_feed_threads())
    path = tmp_path / "fit.jsonl"
    t_tm.reset(str(path))
    try:
        tmx.mod.Module(net).fit(it, num_epoch=2)
    finally:
        t_tm.close()
    with open(path) as f:
        recs, problems = j_schema.validate_lines(f)
    assert not problems, problems
    steps = [r for r in recs if r["type"] == "step"]
    assert len(steps) == 8
    # deltas of the producer's bytes between steps: it runs ahead, so
    # a step's share varies, and the two epochs' sum is every batch's
    per_batch = 8 * 6 * 4 + 8 * 4
    h2d = [r["h2d_bytes"] for r in steps]
    assert all(v >= 0 and v % per_batch == 0 for v in h2d)
    assert 0 < sum(h2d) <= 8 * per_batch
    assert all(r["feed_wait_ms"] >= 0 for r in steps)
    assert len(_feed_threads()) == before
    assert it.cursor == -it.batch_size  # handed back reset


@limited(60)
def test_prefetching_iter_feeds_the_device():
    x, y = _data()
    res = []
    for pkg, kw in ((jmx, {}), (tmx, {})):
        pf = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=6),
                                    device_feed=True, **kw)
        res.append([(b.data[0].asnumpy(), b.pad) for b in pf])
    assert len(res[0]) == len(res[1]) == 4
    for (a, pa), (b, pb) in zip(*res):
        assert pa == pb
        onp.testing.assert_array_equal(a, b)
