"""The port's random foundation (``_rng``, ``mx.random``,
``mx.nd.random``, ``ops/random_ops.py``, ``Dropout`` and the keyed
train step) against the reference on the CPU.

The two packages draw different streams (JAX's counter-based keys have
no PyTorch counterpart), so samplers are held by distribution: at 10⁵
draws each sample mean and variance lies within 5 standard errors of
the distribution's, and for the continuous samplers a two-sample
Kolmogorov–Smirnov test of the port's draws against the reference's
does not reject at the 10⁻³ level.  Names, keywords, defaults, output
dtypes and shapes are the reference's exactly; the density ops'
values within 1e-5.  Dropout is held on its semantics, and against the
reference's op with the same mask fed to both (the reference's
``jax.random.bernoulli`` and the port's ``_rng.draw_bernoulli``
patched), outputs and gradients exactly.
"""
import base64
import inspect
import json

import numpy as onp
import pytest
import torch
from scipy import stats

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import registry as j_reg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _rng, parallel  # noqa: E402
from mxnet_tpu_torch.ops import registry as t_reg  # noqa: E402

N = 10 ** 5
SIGMAS = 5.0
KS_LEVEL = 1e-3


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _random_names(reg):
    return sorted(n for n in reg.list_ops()
                  if reg.get_op(n).fn.__module__.endswith("random_ops"))


def test_registered_random_ops_are_the_reference_ones():
    names = _random_names(j_reg)
    assert _random_names(t_reg) == names
    assert len({j_reg.get_op(n).name for n in names}) == 27
    for n in names:
        j, t = j_reg.get_op(n), t_reg.get_op(n)
        assert t.name == j.name and t.key_param == j.key_param, n
        assert t.differentiable == j.differentiable, n
        j_kw = {p.name: p.default for p in
                inspect.signature(j.fn).parameters.values()}
        t_kw = {p.name: p.default for p in
                inspect.signature(t.fn).parameters.values()}
        assert t_kw == j_kw, n


def test_namespaces_are_the_reference_ones():
    assert sorted(tmx.nd.random.__all__) == sorted(jmx.nd.random.__all__)
    for name in jmx.nd.random.__all__:
        j = inspect.signature(getattr(jmx.nd.random, name))
        t = inspect.signature(getattr(tmx.nd.random, name))
        assert list(t.parameters) == list(j.parameters), name
        assert getattr(tmx.random, name) is getattr(tmx.nd.random, name)
    assert callable(tmx.random.seed)


# ------------------------------------------------------------ samplers
def _moments(x, mean, var):
    d = onp.asarray(x, onp.float64).reshape(-1)
    n = d.size
    m, v = d.mean(), d.var(ddof=1)
    m4 = ((d - m) ** 4).mean()
    assert abs(m - mean) < SIGMAS * (var / n) ** 0.5, (m, mean)
    assert abs(v - var) < SIGMAS * (max(m4 - v * v, 1e-30) / n) ** 0.5, \
        (v, var)


#: name -> (sampler(pkg) -> NDArray, mean, variance, continuous)
_SAMPLERS = {
    "uniform": (lambda p: p.nd.random.uniform(-1, 3, shape=(N,)),
                1.0, 16 / 12, True),
    "normal": (lambda p: p.nd.random.normal(2, 3, shape=(N,)), 2.0, 9.0,
               True),
    "randn": (lambda p: p.nd.random.randn(N, 2), 0.0, 1.0, True),
    "gamma": (lambda p: p.nd.random.gamma(2.5, 1.5, shape=(N,)), 3.75,
              5.625, True),
    "exponential": (lambda p: p.nd.random.exponential(2.0, shape=(N,)),
                    2.0, 4.0, True),
    "poisson": (lambda p: p.nd.random.poisson(4.0, shape=(N,)), 4.0, 4.0,
                False),
    "negative_binomial": (
        lambda p: p.nd.random.negative_binomial(3, 0.4, shape=(N,)), 4.5,
        11.25, False),
    "generalized_negative_binomial": (
        lambda p: p.nd.random.generalized_negative_binomial(
            2.0, 0.5, shape=(N,)), 2.0, 4.0, False),
    "randint": (lambda p: p.nd.random.randint(-3, 5, shape=(N,)), 0.5,
                63 / 12, False),
    "multinomial": (lambda p: p.nd.random.multinomial(
        p.nd.array([0.1, 0.2, 0.7]), shape=N), 1.6, 0.44, False),
    "multinomial_rows": (lambda p: p.nd.random.multinomial(
        p.nd.array([[0.2, 0.3, 0.5]] * 4), shape=N // 4), 1.3, 0.61, False),
    "sample_uniform": (lambda p: p.nd.random.uniform(
        p.nd.array([0.0, 0.0]), p.nd.array([2.0, 2.0]), shape=(N // 2,)),
        1.0, 1 / 3, True),
    "sample_normal": (lambda p: p.nd.random.normal(
        p.nd.array([1.0]), p.nd.array([0.5]), shape=(N,)), 1.0, 0.25, True),
    "sample_gamma": (lambda p: p.nd.sample_gamma(
        p.nd.array([2.0]), p.nd.array([0.5]), shape=(N,)), 1.0, 0.5, True),
    "sample_exponential": (lambda p: p.nd.sample_exponential(
        p.nd.array([0.5]), shape=(N,)), 2.0, 4.0, True),
    "sample_poisson": (lambda p: p.nd.sample_poisson(
        p.nd.array([3.0]), shape=(N,)), 3.0, 3.0, False),
    "sample_negative_binomial": (lambda p: p.nd.sample_negative_binomial(
        p.nd.array([3.0]), p.nd.array([0.4]), shape=(N,)), 4.5, 11.25,
        False),
    "sample_generalized_negative_binomial": (
        lambda p: p.nd.sample_generalized_negative_binomial(
            p.nd.array([2.0]), p.nd.array([0.5]), shape=(N,)), 2.0, 4.0,
        False),
    "uniform_like": (lambda p: p.nd.random.uniform_like(
        p.nd.zeros((N,)), low=2, high=4), 3.0, 4 / 12, True),
    "normal_like": (lambda p: p.nd.random.normal_like(
        p.nd.zeros((N,)), loc=-1, scale=2), -1.0, 4.0, True),
}


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_sampler_matches_reference_distribution(name):
    sample, mean, var, continuous = _SAMPLERS[name]
    tmx.random.seed(1)
    jmx.random.seed(1)
    got, want = sample(tmx), sample(jmx)
    assert got.shape == want.shape
    assert onp.dtype(got.dtype) == onp.dtype(want.dtype), (got.dtype,
                                                           want.dtype)
    g, w = got.asnumpy(), want.asnumpy()
    _moments(g, mean, var)
    _moments(w, mean, var)  # the reference's own draws, as a control
    if continuous:
        p = stats.ks_2samp(g.reshape(-1), w.reshape(-1)).pvalue
        assert p > KS_LEVEL, p


def test_shuffle_is_a_permutation_of_rows():
    x = onp.arange(40, dtype=onp.float32).reshape(20, 2)
    got = tmx.nd.random.shuffle(tmx.nd.array(x)).asnumpy()
    want = jmx.nd.random.shuffle(jmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_array_equal(onp.sort(got, axis=0), x)
    assert (got[:, 1] - got[:, 0] == 1).all()  # rows move whole


@pytest.mark.parametrize("dtype", [None, "float16", "float64", "int32"])
def test_dtypes_and_shapes_are_the_reference_ones(dtype):
    for op, kw in (("_random_uniform", {}), ("_random_normal", {}),
                   ("_random_poisson", {}), ("_random_gamma", {}),
                   ("_random_randint", dict(low=0, high=9))):
        if dtype in ("float16", "float64") and op == "_random_randint":
            continue
        if dtype == "int32" and op != "_random_randint":
            continue
        want = jmx.nd.invoke(op, [], shape=(3, 2), dtype=dtype, **kw)
        got = tmx.nd.invoke(op, [], shape=(3, 2), dtype=dtype, **kw)
        assert got.shape == want.shape == (3, 2)
        if dtype == "float64":
            # the port keeps 64-bit types, as its creation ops do (by
            # design); JAX without x64 narrows them to 32 bits
            assert onp.dtype(got.dtype) == onp.float64
            assert onp.dtype(want.dtype) == onp.float32
            continue
        assert onp.dtype(got.dtype) == onp.dtype(want.dtype), op


_PDF_CASES = {
    "_random_pdf_uniform": ([[0.5, 1.5, 3.0]], [[0.0], [2.0]]),
    "_random_pdf_normal": ([[0.5, -1.5, 3.0]], [[0.5], [2.0]]),
    "_random_pdf_gamma": ([[0.5, 1.5, 3.0]], [[2.0], [1.5]]),
    "_random_pdf_exponential": ([[0.5, 1.5, 3.0]], [[2.0]]),
    "_random_pdf_poisson": ([[0.0, 2.0, 5.0]], [[3.0]]),
    "_random_pdf_negative_binomial": ([[0.0, 2.0, 5.0]], [[3.0], [0.4]]),
    "_random_pdf_generalized_negative_binomial": ([[0.0, 2.0, 5.0]],
                                                  [[2.0], [0.5]]),
    "_random_pdf_dirichlet": ([[0.2, 0.3, 0.5]], [[1.5, 2.0, 3.0]]),
}


@pytest.mark.parametrize("name", sorted(_PDF_CASES))
@pytest.mark.parametrize("is_log", [False, True])
def test_density_ops_match_reference(name, is_log):
    sample, params = _PDF_CASES[name]
    arrays = [onp.asarray(sample, onp.float32)] + [
        onp.asarray(p, onp.float32) for p in params]
    want = jmx.nd.invoke(name, [jmx.nd.array(a) for a in arrays],
                         is_log=is_log).asnumpy()
    got = tmx.nd.invoke(name, [tmx.nd.array(a) for a in arrays],
                        is_log=is_log).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- seeding
def _draws():
    return onp.concatenate([tmx.nd.random.uniform(shape=(16,)).asnumpy(),
                            tmx.nd.random.normal(shape=(16,)).asnumpy(),
                            tmx.nd.random.randint(0, 100,
                                                  shape=(16,)).asnumpy()])


def test_seed_repeats_a_run_and_another_seed_does_not():
    tmx.random.seed(7)
    a = _draws()
    tmx.random.seed(7)
    b = _draws()
    tmx.random.seed(8)
    c = _draws()
    onp.testing.assert_array_equal(a, b)
    assert not onp.array_equal(a, c)
    tmx.random.seed(7, ctx=tmx.cpu())
    onp.testing.assert_array_equal(_draws(), a)


def test_keys_fold_and_split_deterministically():
    assert _rng.split(5) == _rng.split(5)
    assert len(set(_rng.split(5, 4))) == 4
    assert _rng.fold_in(5, 1) != _rng.fold_in(6, 1)
    assert all(0 <= k < 2 ** 63 for k in _rng.split(2 ** 64 - 1))


# ------------------------------------------------------------- Dropout
def test_dropout_semantics():
    x = tmx.nd.array(onp.random.RandomState(0).rand(64, 32) + 0.5)
    xn = x.asnumpy()
    p = 0.3
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=p).asnumpy()
    kept = y != 0
    onp.testing.assert_allclose(y[kept], xn[kept] / (1 - p), rtol=1e-6)
    assert abs(kept.mean() - (1 - p)) < 0.05
    # inference: the identity, unless mode="always"
    onp.testing.assert_array_equal(tmx.nd.Dropout(x, p=p).asnumpy(), xn)
    y = tmx.nd.Dropout(x, p=p, mode="always").asnumpy()
    assert (y == 0).any() and (y != 0).any()
    # p = 0: the identity in training
    with tmx.autograd.record():
        onp.testing.assert_array_equal(
            tmx.nd.Dropout(x, p=0.0).asnumpy(), xn)
    # axes: one draw shared along them
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=0.5, axes=(1,)).asnumpy()
    rows = (y != 0).all(axis=1) | (y == 0).all(axis=1)
    assert rows.all() and 0 < (y[:, 0] != 0).sum() < 64


def test_gluon_dropout_trains_under_record_only():
    x = tmx.nd.ones((8, 100))
    layer = tmx.gluon.nn.Dropout(0.5)
    assert "Dropout(p = 0.5" in repr(layer)
    with tmx.autograd.record():
        train = layer(x).asnumpy()
    with tmx.autograd.record(), tmx.autograd.predict_mode():
        pred = layer(x).asnumpy()
    assert set(onp.unique(train)) == {0.0, 2.0}
    onp.testing.assert_array_equal(pred, 1.0)
    onp.testing.assert_array_equal(layer(x).asnumpy(), 1.0)


class _Fed:
    """One bool mask per mask shape, from a seeded numpy stream, fed to
    both packages: the reference's ``jax.random.bernoulli`` and the
    port's ``_rng.draw_bernoulli``."""

    def __init__(self, seed):
        self.seed, self.masks = seed, {}

    def mask(self, keep, shape):
        key = (float(keep), tuple(shape))
        if key not in self.masks:
            rs = onp.random.RandomState(self.seed + len(self.masks))
            self.masks[key] = rs.rand(*shape) < keep
        return self.masks[key]

    def install(self, monkeypatch):
        import jax.numpy as jnp

        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(
                                self.mask(p, shape)))
        monkeypatch.setattr(_rng, "draw_bernoulli",
                            lambda keep, shape, device, gen: torch.as_tensor(
                                self.mask(keep, shape), device=device))


@pytest.mark.parametrize("axes", [(), (0,), (1, 2)])
def test_dropout_matches_reference_with_fed_masks(monkeypatch, axes):
    _Fed(3).install(monkeypatch)
    x0 = onp.random.RandomState(1).randn(4, 5, 6).astype(onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Dropout(x * 2, p=0.4, axes=axes)
        y.backward(pkg.nd.array(onp.arange(120, dtype=onp.float32)
                                .reshape(4, 5, 6)))
        res[pkg] = y.asnumpy(), x.grad.asnumpy()
    for g, w in zip(res[tmx], res[jmx]):
        onp.testing.assert_array_equal(g, w)


# ---------------------------------------------------- keys in the step
def _dropout_net():
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=16), nn.Dropout(0.5), nn.Dense(4,
                                                                in_units=64))
    net.initialize()
    return net


def _masks_of(apply_fn, params, x, key):
    seen = []
    orig = _rng.draw_bernoulli

    def rec(*a):
        m = orig(*a)
        seen.append(m.clone())
        return m

    _rng.draw_bernoulli = rec
    try:
        with torch.no_grad():
            out = apply_fn(params, x, key=key)
    finally:
        _rng.draw_bernoulli = orig
    return out, seen


def test_the_same_key_gives_the_same_masks():
    net = _dropout_net()
    params, apply_fn = parallel.functionalize(net, train=True)
    x = torch.ones(8, 16)
    (a, ma), (b, mb) = (_masks_of(apply_fn, params, x, 5) for _ in range(2))
    c, mc = _masks_of(apply_fn, params, x, 6)
    n0, m0 = _masks_of(apply_fn, params, x, None)
    n1, m1 = _masks_of(apply_fn, params, x, None)
    assert len(ma) == 1 and torch.equal(ma[0], mb[0]) and torch.equal(a, b)
    assert not torch.equal(ma[0], mc[0])
    assert torch.equal(m0[0], m1[0])  # None is one fixed key
    # the eager generator is not consumed by a keyed forward
    tmx.random.seed(3)
    first = _draws()
    tmx.random.seed(3)
    _masks_of(apply_fn, params, x, 9)
    onp.testing.assert_array_equal(_draws(), first)
    # outside a key scope the layer draws from the device's generator
    _, plain = _masks_of(parallel.functionalize(net, train=False)[1],
                         params, x, 5)
    assert plain == []  # not training: no draw


def test_train_step_and_trainer_take_fresh_masks():
    net = _dropout_net()
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    y = torch.arange(8) % 4
    seen = []
    orig = _rng.draw_bernoulli
    _rng.draw_bernoulli = lambda *a: seen.append(orig(*a)) or seen[-1]
    try:
        step, params, state = parallel.make_train_step(
            net, loss, "sgd", learning_rate=0.1, device="cpu")
        for key in (1, 1, 2):
            _, params, state = step(params, state, x, y, key, 1.0)
        trainer = parallel.DataParallelTrainer(
            _dropout_net(), loss, "sgd", learning_rate=0.1, device="cpu")
        trainer.fit_batch(x, y)
        trainer.fit_batch(x, y)
    finally:
        _rng.draw_bernoulli = orig
    assert len(seen) == 5
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0],
                                                             seen[2])
    assert not torch.equal(seen[3], seen[4])


def test_module_with_symbolic_dropout_trains_and_predicts():
    sym = tmx.sym
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = sym.Dropout(net, p=0.5, name="drop")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    onp.random.seed(0)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),))
    x = tmx.nd.array(onp.random.RandomState(1).randn(16, 10))
    batch = tmx.io.DataBatch([x], [tmx.nd.array(onp.arange(16) % 4)])
    before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert not onp.array_equal(mod.get_params()[0]["fc1_weight"].asnumpy(),
                               before)
    # inference: Dropout is the identity, two forwards agree
    outs = []
    for _ in range(2):
        mod.forward(batch, is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    onp.testing.assert_array_equal(outs[0], outs[1])
    mod.forward(batch, is_train=True)
    assert not onp.array_equal(mod.get_outputs()[0].asnumpy(), outs[0])


# ------------------------------------------------- checkpoint manifest
def test_manifest_rng_round_trip_and_reference_numpy_bytes():
    from mxnet_tpu.resilience.checkpoint import capture_rng as j_capture
    from mxnet_tpu_torch.resilience.checkpoint import (capture_rng,
                                                       restore_rng)

    onp.random.seed(21)
    tmx.random.seed(4)
    tmx.nd.random.uniform(shape=(3,))
    snap = json.loads(json.dumps(capture_rng()))  # as a manifest holds it
    assert snap["numpy"] == j_capture()["numpy"]
    key = onp.frombuffer(base64.b64decode(snap["numpy"][1]["b64"]),
                         onp.uint32)
    onp.testing.assert_array_equal(key, onp.random.get_state()[1])
    after = (onp.random.rand(4), _draws())
    onp.random.rand(9)
    _draws()
    restore_rng(snap)
    again = (onp.random.rand(4), _draws())
    onp.testing.assert_array_equal(after[0], again[0])
    onp.testing.assert_array_equal(after[1], again[1])
    assert sorted(snap["device"]["generators"]) == ["cpu"]
    # a reference manifest's device key (a JAX key) is not the port's:
    # its numpy part is restored, its device part skipped
    restore_rng({"numpy": snap["numpy"], "device": [0, 42]})
    onp.testing.assert_array_equal(onp.random.rand(4), after[0])
