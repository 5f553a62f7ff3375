"""The port's ``gluon.data.DataLoader`` with workers held against the JAX
package on the CPU: batches at 0 and 2 worker processes and with a
thread pool equal the reference's exactly (shuffled and not, every
``last_batch``), with the device feed on and off, ``pin_memory`` a
no-op on a host without a card.  Worker processes start by
``forkserver`` in the port (``fork`` in the reference).  Every test has
its own time limit."""
import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu.gluon import data as j_data  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.gluon import data as t_data  # noqa: E402

from test_torch_device_feed import limited  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _dataset(pkg, n=23):
    rng = onp.random.RandomState(0)
    x = rng.randn(n, 3, 2).astype("float32")
    y = rng.randint(0, 4, n).astype("int32")
    return pkg.ArrayDataset(x, y)


def _batches(loader):
    return [[(b.asnumpy(), str(b.asnumpy().dtype)) for b in batch]
            for batch in loader]


CASES = {
    "procs2": dict(num_workers=2),
    "procs2_shuffle": dict(num_workers=2, shuffle=True,
                           last_batch="discard"),
    "threads3": dict(num_workers=3, thread_pool=True, shuffle=True),
    "procs2_feed_pinned": dict(num_workers=2, device_feed=True,
                               pin_memory=True, last_batch="rollover"),
    "threads2_feed": dict(num_workers=2, thread_pool=True,
                          device_feed=True, prefetch=1),
}


@limited(120)
@pytest.mark.parametrize("case", list(CASES))
def test_worker_batches_match_reference(case):
    kw = dict(CASES[case])
    shuffle = kw.pop("shuffle", False)
    last = kw.pop("last_batch", None)
    feed = kw.pop("device_feed", None)
    jkw = {k: v for k, v in kw.items() if k != "pin_memory"}
    jl = j_data.DataLoader(_dataset(j_data), batch_size=5, shuffle=shuffle,
                           last_batch=last, device_feed=False, **jkw)
    tl = t_data.DataLoader(_dataset(t_data), batch_size=5, shuffle=shuffle,
                           last_batch=last, device_feed=feed, **kw)
    try:
        assert len(tl) == len(jl)
        for epoch in range(2):
            onp.random.seed(20 + epoch)
            want = _batches(jl)
            onp.random.seed(20 + epoch)
            got = _batches(tl)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for (ga, gd), (wa, wd) in zip(g, w):
                    assert gd == wd
                    onp.testing.assert_array_equal(ga, wa)
        for batch in tl:
            assert all(b.context == tmx.cpu() for b in batch)
    finally:
        tl.close()
        del jl


@limited(120)
def test_zero_and_two_workers_give_one_stream():
    """The same loader at 0 and 2 workers: one stream, batch for batch
    (the worker side batchifies to numpy, the main process makes the
    NDArrays)."""
    out = []
    for w in (0, 2):
        dl = t_data.DataLoader(_dataset(t_data), batch_size=4, num_workers=w,
                               device_feed=False)
        out.append(_batches(dl))
        dl.close()
    assert len(out[0]) == len(out[1]) == 6
    for g, h in zip(*out):
        for (a, ad), (b, bd) in zip(g, h):
            assert ad == bd
            onp.testing.assert_array_equal(a, b)
    assert t_data.dataloader.START_METHOD == "forkserver"
