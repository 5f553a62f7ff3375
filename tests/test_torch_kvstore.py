"""The port's single-process ``mx.kv`` held against the JAX package on
the CPU: ``local`` and ``device`` stores (init, push of one and of
several gradients, pull, pushpull, the optimizer on the store and its
state files) and 2-bit gradient compression (values, residuals, the
packed wire bytes) equal the reference's exactly; ``dist_*``,
``init_distributed`` and ``row_sparse_pull`` raise."""
import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _vals(seed=0, shape=(3, 4), n=3):
    rng = onp.random.RandomState(seed)
    return [rng.randn(*shape).astype("float32") for _ in range(n)]


def _drive(pkg, kind, optimizer):
    kv = pkg.kv.create(kind)
    w0, w1 = _vals(seed=1, n=2)
    kv.init([3, 5], [pkg.nd.array(w0), pkg.nd.array(w1)])
    if optimizer:
        kv.set_optimizer(pkg.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3))
    out = []
    for step in range(3):
        g = _vals(seed=10 + step)
        kv.push(3, [pkg.nd.array(g[0]), pkg.nd.array(g[1])])
        kv.push(5, pkg.nd.array(g[2]))
        a, b = pkg.nd.zeros((3, 4)), pkg.nd.zeros((3, 4))
        kv.pull([3, 5], out=[a, b])
        out += [a.asnumpy(), b.asnumpy()]
        c = pkg.nd.zeros((3, 4))
        kv.pushpull(5, pkg.nd.array(g[0] * 0.5), out=c)
        out.append(c.asnumpy())
    return kv, out


@pytest.mark.parametrize("kind", ["local", "device"])
@pytest.mark.parametrize("optimizer", [False, True])
def test_stores_match_reference(kind, optimizer):
    jkv, j = _drive(jmx, kind, optimizer)
    tkv, t = _drive(tmx, kind, optimizer)
    assert (tkv.rank, tkv.num_workers, tkv.type) == (jkv.rank,
                                                      jkv.num_workers,
                                                      jkv.type)
    assert len(t) == len(j) == 9
    for a, b in zip(j, t):
        onp.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    with pytest.raises(MXNetError, match="already initialized"):
        tkv.init(3, tmx.nd.zeros((3, 4)))
    with pytest.raises(MXNetError, match="not initialized"):
        tkv.push(9, tmx.nd.zeros((3, 4)))
    tkv.barrier()


def test_optimizer_state_files_round_trip(tmp_path):
    kv, _ = _drive(tmx, "device", True)
    path = str(tmp_path / "kv.states")
    kv.save_optimizer_states(path)
    kv2, _ = _drive(tmx, "device", True)
    kv2.load_optimizer_states(path)
    def flat(st):
        if isinstance(st, (tuple, list)):
            return [a for s in st for a in flat(s)]
        return [] if st is None else [st.asnumpy()]

    assert sorted(kv2._updater.states) == sorted(kv._updater.states) == [3, 5]
    for k in kv._updater.states:
        for a, b in zip(flat(kv._updater.states[k]),
                        flat(kv2._updater.states[k])):
            onp.testing.assert_array_equal(b, a)
    bare = tmx.kv.create("local")
    with pytest.raises(MXNetError, match="updater"):
        bare.save_optimizer_states(path)


def test_two_bit_compression_matches_reference():
    res = []
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.4})
        kv.init("w", pkg.nd.zeros((5, 7)))
        got = []
        for step in range(4):
            g = _vals(seed=30 + step, shape=(5, 7), n=1)[0]
            kv.push("w", pkg.nd.array(g))
            o = pkg.nd.zeros((5, 7))
            kv.pull("w", out=o)
            got.append(o.asnumpy())
        gc = pkg.kv.GradientCompression(0.5)
        x = _vals(seed=40, shape=(3, 5), n=1)[0] * 0.8
        packed = gc.compress_packed(0, pkg.nd.array(x)._data)
        got.append(onp.asarray(packed.numpy() if hasattr(packed, "numpy")
                               else packed))
        got.append(onp.asarray(gc.decompress(packed, (3, 5))))
        got.append(onp.asarray(gc._residual[0]))
        res.append(got)
    for a, b in zip(*res):
        onp.testing.assert_array_equal(b, a)
    with pytest.raises(MXNetError, match="unsupported compression"):
        tmx.kv.create().set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("name", ["dist_sync", "dist_async",
                                  "dist_device_sync"])
def test_dist_stores_and_sparse_pull_raise(name):
    with pytest.raises(MXNetError, match="§A 11"):
        tmx.kv.create(name)
    with pytest.raises(MXNetError, match="§A 11"):
        tmx.kv.init_distributed()
    kv = tmx.kv.create("local")
    kv.init(0, tmx.nd.ones((4, 2)))
    with pytest.raises(MXNetError, match="§A 3"):
        kv.row_sparse_pull(0, out=tmx.nd.zeros((4, 2)),
                           row_ids=tmx.nd.array([1]))
    with pytest.raises(MXNetError, match="unknown KVStore"):
        tmx.kv.create("bogus")
