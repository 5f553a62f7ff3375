"""The port's micro-batch predictor (``parallel/predict.py``) held against
the JAX package on the CPU.

``make_predict_fn`` at k = 2 and 4, in both forms (unrolled and map),
equals k = 1 bit for bit on the host and the reference's predict of the
same weights to 1e-5 of the output's largest magnitude.
``tune_microbatch`` persists its winner under the reference's key (its
params-signature digest, the batch's shape and dtype; platform ``cpu``)
and reloads it without timing again; ``MXNET_AUTOTUNE=2`` times again.
"""
import json

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu.parallel import functionalize as j_functionalize  # noqa: E402
from mxnet_tpu.parallel import predict as jpredict  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch.parallel import functionalize  # noqa: E402
from mxnet_tpu_torch.parallel import predict as tpredict  # noqa: E402

PREDICT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _host(tmp_path, monkeypatch):
    """On the host, with a fresh autotune cache."""
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    t_at.cache_clear()
    j_at.cache_clear()
    with tmx.cpu():
        yield
    t_at.cache_clear()
    j_at.cache_clear()


def _twins(name, tmp_path):
    """The port's net and the reference's with its weights: a two-layer
    MLP, or a ResNet-18 v1 at 32²."""
    onp.random.seed(0)
    if name == "mlp":
        def mlp(pkg, prefix=None):
            net = pkg.gluon.nn.HybridSequential(prefix=prefix)
            with net.name_scope():
                net.add(pkg.gluon.nn.Dense(32, activation="relu",
                                           in_units=16),
                        pkg.gluon.nn.Dense(5, in_units=32))
            return net

        tnet = mlp(tmx)
        tnet.initialize(tmx.init.Xavier())
        jnet = mlp(jmx, prefix=tnet.prefix)
        shape = (8, 16)
    else:
        tnet = tmx.gluon.model_zoo.vision.get_model(name, classes=10)
        tnet.initialize(tmx.init.Xavier())
        jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=10,
                                                    prefix=tnet.prefix)
        shape = (8, 3, 32, 32)
    f = str(tmp_path / "w.params")
    tnet.save_parameters(f)
    jnet.initialize()
    jnet.load_parameters(f)
    x = onp.random.RandomState(1).rand(*shape).astype("float32")
    return tnet, jnet, x


@pytest.mark.parametrize("name", ["mlp", "resnet18_v1"])
def test_chunked_predict_equals_whole_batch_and_reference(name, tmp_path):
    tnet, jnet, x = _twins(name, tmp_path)
    params, apply_fn = functionalize(tnet)
    xt = torch.from_numpy(x)
    whole = tpredict.make_predict_fn(apply_fn)(params, xt)
    jparams, japply = j_functionalize(jnet)
    want = onp.asarray(jpredict.make_predict_fn(japply)(jparams,
                                                        jnp.asarray(x)))
    scale = float(onp.abs(want).max())
    assert float(onp.abs(whole.numpy() - want).max()) <= PREDICT_TOL * scale
    for k in (2, 4):
        for unroll in (True, False):
            got = tpredict.make_predict_fn(apply_fn, microbatch=k,
                                           unroll=unroll)(params, xt)
            assert torch.equal(got, whole), (k, unroll)
            ref = onp.asarray(jpredict.make_predict_fn(
                japply, microbatch=k, unroll=unroll)(jparams,
                                                     jnp.asarray(x)))
            assert float(onp.abs(got.numpy() - ref).max()) \
                <= PREDICT_TOL * scale


def test_indivisible_batch_raises_the_reference_error(tmp_path):
    tnet, jnet, x = _twins("mlp", tmp_path)
    params, apply_fn = functionalize(tnet)
    jparams, japply = j_functionalize(jnet)
    with pytest.raises(ValueError) as te:
        tpredict.make_predict_fn(apply_fn, microbatch=3)(
            params, torch.from_numpy(x))
    with pytest.raises(ValueError) as je:
        jpredict.make_predict_fn(japply, microbatch=3)(jparams,
                                                       jnp.asarray(x))
    assert str(te.value) == str(je.value)


def test_unroll_auto_follows_the_reference_limit():
    assert tpredict._UNROLL_LIMIT == jpredict._UNROLL_LIMIT


def _entries(path):
    with open(path) as f:
        return json.load(f)["entries"]


def test_tune_persists_under_the_reference_key_and_reloads(tmp_path,
                                                           monkeypatch):
    tnet, jnet, x = _twins("mlp", tmp_path)
    params, apply_fn = functionalize(tnet)
    jparams, japply = j_functionalize(jnet)
    xt = torch.from_numpy(x)
    calls = []
    real = t_at.time_call

    def counted(fn, device, iters=4):
        calls.append(1)
        return real(fn, device, iters)

    monkeypatch.setattr(t_at, "time_call", counted)
    best, results = tpredict.tune_microbatch(apply_fn, params, xt,
                                             candidates=(1, 2, 4), iters=2)
    assert set(results) == {(1, False), (2, False), (2, True), (4, False),
                            (4, True)}
    assert best == min(results, key=results.get)
    assert len(calls) == 5
    (key,) = _entries(tmp_path / "autotune.json")
    # the reference's race on the same weights, in a cache of its own
    jdir = tmp_path / "ref"
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(jdir))
    j_at.cache_clear()
    jpredict.tune_microbatch(japply, jparams, jnp.asarray(x),
                             candidates=(1, 2, 4), iters=2)
    (jkey,) = _entries(jdir / "autotune.json")
    # op (with the params digest), shape and dtype are the reference's
    assert key.split("|")[:3] == jkey.split("|")[:3]
    assert key.split("|")[3] == "cpu"
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    # a fresh consult (another process's view) answers from the file
    t_at.cache_clear()
    again, res2 = tpredict.tune_microbatch(apply_fn, params, xt,
                                           candidates=(1, 2, 4), iters=2)
    assert (again, res2) == (best, results)
    assert len(calls) == 5
    # a narrower race is not answered by the wider stored one
    tpredict.tune_microbatch(apply_fn, params, xt, candidates=(1, 2),
                             iters=2)
    assert len(calls) == 8
    # level 2 races again on a hit
    monkeypatch.setenv("MXNET_AUTOTUNE", "2")
    tpredict.tune_microbatch(apply_fn, params, xt, candidates=(1, 2),
                             iters=2)
    assert len(calls) == 11


def test_params_digest_is_the_references(tmp_path):
    tnet, jnet, _ = _twins("resnet18_v1", tmp_path)
    params, _ = functionalize(tnet)
    jparams, _ = j_functionalize(jnet)
    import hashlib

    sig = ",".join(f"{tuple(leaf.shape)}{leaf.dtype}"
                   for leaf in jax.tree_util.tree_leaves(jparams))
    assert tpredict._params_digest(params) == \
        hashlib.sha1(sig.encode()).hexdigest()[:12]
