"""The classification zoo (``gluon/model_zoo/vision``: LeNet, AlexNet,
VGG, SqueezeNet, DenseNet, Inception v3, MobileNet v1/v2) and its new
layers (``Dropout``, ``AvgPool2D``, ``MaxPool2D(ceil_mode=True)``)
against the reference on the CPU.

- Every classification name of the reference's ``get_model`` builds,
  with the reference's parameter names and shapes (the three SSD
  detectors build too; they are held in ``tests/test_torch_ssd.py``).
- Weights come from ``np.random.seed`` + ``initialize`` in both packages
  (He-scaled Xavier, so that activations keep their scale through the
  deep nets in inference); they are equal bit for bit.
- Forward parity at each family's smallest input, batch 1, in
  inference, to 1e-5 of the output's largest magnitude.  DenseNet's
  smallest named net takes 224² (its last pool is 7x7 at 1/32 of the
  input), where the reference's eager forward compiles each of its
  ~600 layer shapes for most of a minute on the CPU: the family is held
  at ``DenseNet(16, 8, [2, 2])`` (56²), and ``densenet121`` on its
  parameter names.  Inception v3 is held on its forward only (at 299²),
  for the same reason.
- Three fused ``make_train_step`` steps (fp32, SGD momentum, wd, the
  sharded-bucket arm with the bucket kernel forced: the reference's
  Pallas kernel in interpret mode, the port's plain version) on a fixed
  batch of 8, the Dropout masks fed to both, in training mode: losses to
  1e-4, each tensor to 1e-4 of its largest magnitude (of 1e-3 at least:
  a conv bias that a BatchNorm follows has no gradient, and holds fp32
  summation noise of 1e-9).
- MobileNet v1 and v2 (27 and 52 BatchNorms, no residual in v1) are
  ill-conditioned in fp32 at init: summing a BatchNorm beta's gradient
  cancels, and each package's fp32 step 1 departs from the exact one by
  percents on some tensors (measured against the reference's float64
  step: the reference by up to 4.5 %, the port by up to 2.7 %, MobileNet
  v1 at 64²), which three steps with momentum amplify further.  Their
  three steps are held in float64 against the reference's float64 steps
  (``jax.enable_x64``; both packages' BatchNorm and train step made to
  keep float64 where they round to fp32: ``_Float64``) to 1e-8;
  their fp32 step 1 is held, as a whole and tensor by tensor, against
  the reference's float64 step: no farther from it than twice the
  reference's own fp32 step is, plus 1e-4 of the whole update's norm.
- ``.params`` files written by either package load in the other.
"""
import types

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu.ops import nn as j_nn_ops  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as j_vision  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _rng  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import nn as t_nn_ops  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as t_vision  # noqa: E402

FWD_TOL = 1e-5
STEP_TOL = 1e-4
F64_TOL = 1e-8
STEPS = 3
SSD = ("ssd_300_vgg16_reduced", "ssd_512_vgg16", "ssd_300_resnet18")
CLASSIFIERS = sorted(n for n in j_vision._models
                     if not n.startswith(("resnet", "ssd")))


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _init(pkg):
    return pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)


class _Fed:
    """One bool mask per (keep, shape), from a seeded numpy stream, fed
    to the reference's ``jax.random.bernoulli`` and the port's
    ``_rng.draw_bernoulli``."""

    def __init__(self, monkeypatch, seed=5):
        self.seed, self.masks = seed, {}
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(
                                self.mask(p, shape)))
        monkeypatch.setattr(_rng, "draw_bernoulli",
                            lambda keep, shape, device, gen: torch.as_tensor(
                                self.mask(keep, shape), device=device))

    def mask(self, keep, shape):
        key = (float(keep), tuple(shape))
        if key not in self.masks:
            rs = onp.random.RandomState(self.seed + len(self.masks))
            self.masks[key] = rs.rand(*shape) < keep
        return self.masks[key]


# ------------------------------------------------------------- names
def test_get_model_takes_every_classification_name():
    assert len(CLASSIFIERS) == 25
    for name in CLASSIFIERS:
        assert type(t_vision.get_model(name)).__name__ == type(
            j_vision.get_model(name)).__name__, name
    for name in SSD:  # ported with the detection ops (tests/test_torch_ssd.py)
        assert type(t_vision.get_model(name)).__name__ == "SSD"
    with pytest.raises(MXNetError, match="pretrained"):
        t_vision.get_model("vgg11", pretrained=True)
    exported = set(t_vision.__all__)
    assert {"VGG", "vgg16_bn", "AlexNet", "DenseNet", "densenet201",
            "SqueezeNet", "squeezenet1_1", "Inception3", "inception_v3",
            "MobileNet", "MobileNetV2", "mobilenet_v2_0_25", "LeNet",
            "lenet", "get_model"} <= exported
    assert {"Dropout", "AvgPool2D", "MaxPool2D"} <= set(tmx.gluon.nn.__all__)


# --------------------------------------------------- pooling (layers)
_POOL_CASES = [  # (layer, kwargs, input side)
    ("MaxPool2D", dict(pool_size=3, strides=2, ceil_mode=True), 13),
    ("MaxPool2D", dict(pool_size=3, strides=2, ceil_mode=True), 14),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True),
     14),
    ("MaxPool2D", dict(pool_size=2, strides=2), 7),
    ("AvgPool2D", dict(pool_size=3, strides=2, ceil_mode=True), 14),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True),
     14),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True,
                       count_include_pad=False), 14),
    ("AvgPool2D", dict(pool_size=3, strides=1, padding=1,
                       count_include_pad=False), 8),
    ("AvgPool2D", dict(pool_size=7), 7),
]


@pytest.mark.parametrize("case", range(len(_POOL_CASES)))
def test_pooling_layers_match_reference(case):
    """``ceil_mode`` (``pooling_convention="full"``) adds the window the
    rounding up makes, with and without padding, as the reference does;
    the values and the gradient agree."""
    layer, kw, side = _POOL_CASES[case]
    x0 = onp.random.RandomState(case).randn(2, 3, side, side).astype(
        onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.gluon.nn, layer)(**kw)(x)
        y.backward(pkg.nd.array(onp.arange(y.size, dtype=onp.float32)
                                .reshape(y.shape)))
        res[pkg] = y.asnumpy(), x.grad.asnumpy()
    assert res[tmx][0].shape == res[jmx][0].shape
    for g, w in zip(res[tmx], res[jmx]):
        onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------ forward
#: family -> (block maker(pkg), input side, image channels)
_FORWARD = {
    "lenet": (lambda v: v.get_model("lenet"), 28, 1),
    "alexnet": (lambda v: v.get_model("alexnet", classes=10), 63, 3),
    "vgg": (lambda v: v.get_model("vgg11_bn", classes=10), 32, 3),
    "squeezenet": (lambda v: v.get_model("squeezenet1.0", classes=10), 33,
                   3),
    "densenet": (lambda v: v.DenseNet(16, 8, [2, 2], classes=10), 56, 3),
    "inception": (lambda v: v.get_model("inceptionv3", classes=10), 299, 3),
    "mobilenet": (lambda v: v.get_model("mobilenet0.25", classes=10), 32,
                  3),
    "mobilenetv2": (lambda v: v.get_model("mobilenetv2_0.25", classes=10),
                    32, 3),
}


def _built(pkg, family, x, seed=4):
    net = _FORWARD[family][0](pkg.gluon.model_zoo.vision)
    onp.random.seed(seed)
    net.initialize(_init(pkg))
    with pkg.autograd.pause():
        net(pkg.nd.array(x))  # resolves the deferred shapes
    return net


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _close(got, want, tol, floor=0.0):
    assert got.shape == want.shape
    scale = max(float(onp.abs(want).max()), floor, 1e-30)
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _image(family, batch=1):
    _, side, ch = _FORWARD[family]
    return onp.random.RandomState(1).rand(batch, ch, side, side).astype(
        onp.float32)


@pytest.mark.parametrize("family", sorted(_FORWARD))
def test_forward_matches_reference(family):
    x = _image(family)
    nets = {pkg: _built(pkg, family, x) for pkg in (jmx, tmx)}
    wj, wt = _params(nets[jmx]), _params(nets[tmx])
    assert list(wt) == list(wj)
    for n in wj:
        assert wt[n].tobytes() == wj[n].tobytes(), n
    outs = {pkg: net(pkg.nd.array(x)).asnumpy() for pkg, net in
            nets.items()}
    _close(outs[tmx], outs[jmx], FWD_TOL)


def test_densenet121_names_and_known_shapes_match_reference():
    j = j_vision.get_model("densenet121")
    t = t_vision.get_model("densenet121")
    jp, tp = j.collect_params(), t.collect_params()
    assert list(tp) == list(jp) and len(jp) == 606
    for n in jp:
        assert tp[n].shape == tuple(jp[n].shape), n


# --------------------------------------------------------- trajectory
#: family -> (block maker(vision module), input side, image channels)
_STEP_NETS = {
    "lenet": (lambda v: v.LeNet(classes=10), 28, 1),
    "alexnet": (lambda v: v.AlexNet(classes=10), 63, 3),
    "vgg": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 16, 16, 32, 32],
                            classes=10, batch_norm=True), 32, 3),
    "squeezenet": (lambda v: v.get_model("squeezenet1.1", classes=10), 32,
                   3),
    "densenet": (lambda v: v.DenseNet(16, 8, [2, 2], classes=10), 56, 3),
    "mobilenet": (lambda v: v.get_model("mobilenet0.25", classes=10), 64,
                  3),
    "mobilenetv2": (lambda v: v.get_model("mobilenetv2_0.25", classes=10),
                    64, 3),
}
_ILL_CONDITIONED = ("mobilenet", "mobilenetv2")
_KW = dict(learning_rate=0.01, momentum=0.9, wd=1e-4, donate=False,
           optimizer_sharding="ps")


def _step_net(pkg, family):
    """(net initialized from the numpy seed, x, y)."""
    make, side, ch = _STEP_NETS[family]
    net = make(pkg.gluon.model_zoo.vision)
    rs = onp.random.RandomState(2)
    x = rs.rand(8, ch, side, side).astype(onp.float32)
    y = (onp.arange(8) % 10).astype(onp.float32)
    onp.random.seed(6)
    net.initialize(_init(pkg))
    with pkg.autograd.pause():
        net(pkg.nd.array(x[:1]))
    return net, x, y


def _by_layer(params):
    """``{name without the net's own prefix: numpy}`` (the two packages
    count their net instances apart)."""
    return {n.split("_", 1)[1]: onp.asarray(v, onp.float64)
            for n, v in params.items()}


class _Float64(types.ModuleType):
    """``jax.numpy`` or ``torch`` whose ``float32`` is float64.  Both
    packages' BatchNorm and train-step modules round the batch
    statistics, the loss and the gradients of a float64 step to fp32;
    patched in as their ``jnp``/``torch`` (:data:`_F64_PATCHES`), it
    keeps the step float64 throughout."""

    def __init__(self, base):
        super().__init__(base.__name__)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, "float64" if name == "float32" else name)


_F64_PATCHES = {jmx: ((j_nn_ops, "jnp", jnp), (j_par, "jnp", jnp)),
                tmx: ((t_nn_ops, "torch", torch), (t_par, "torch", torch))}


def _trajectory(pkg, family, steps, dtype=torch.float32):
    """(losses, params before, [params after each of ``steps`` fused
    steps]).  float64 runs the plain rule: the bucket kernel takes
    fp32."""
    net, x, y = _step_net(pkg, family)
    f64 = dtype == torch.float64
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, base in _F64_PATCHES[pkg] if f64 else ():
            mp.setattr(mod, name, _Float64(base))
        return _run_steps(pkg, net, x, y, steps, f64)


def _run_steps(pkg, net, x, y, steps, f64):
    losses, after = [], []
    if pkg is jmx:
        mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
        with jax.enable_x64(f64), \
                j_at.force(fused_bucket_opt="jnp" if f64 else "pallas"):
            if f64:
                net.cast("float64")
                x = x.astype(onp.float64)
            step, p, s = j_par.make_train_step(
                net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                mesh=mesh, **_KW)
            before = _by_layer(p)
            for i in range(steps):
                loss, p, s = step(p, s, x, y, jax.random.key(i),
                                  float(i + 1))
                losses.append(float(loss))
                after.append(_by_layer(p))
        return losses, before, after
    dtype = torch.float64 if f64 else torch.float32
    net = net.to(dtype)
    with t_at.force(fused_bucket_opt=not f64):
        step, p, s = t_par.make_train_step(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            mesh=t_par.get_mesh(devices=["cpu"]), **_KW)
        before = _by_layer({n: v.numpy().copy() for n, v in p.items()})
        for i in range(steps):
            loss, p, s = step(p, s, torch.from_numpy(x).to(dtype),
                              torch.from_numpy(y), i, float(i + 1))
            losses.append(float(loss))
            after.append(_by_layer({n: v.numpy().copy()
                                    for n, v in p.items()}))
    return losses, before, after


def _match(losses, params, ref_losses, ref_params, tol):
    onp.testing.assert_allclose(losses, ref_losses, rtol=tol)
    assert sorted(params) == sorted(ref_params)
    for n in ref_params:
        _close(params[n], ref_params[n], tol, floor=1e-3)


@pytest.mark.parametrize("family", sorted(set(_STEP_NETS)
                                          - set(_ILL_CONDITIONED)))
def test_fused_steps_match_reference(family, monkeypatch):
    _Fed(monkeypatch)
    jl, _, jp = _trajectory(jmx, family, STEPS)
    tl, _, tp = _trajectory(tmx, family, STEPS)
    assert jl[-1] < jl[0]
    _match(tl, tp[-1], jl, jp[-1], STEP_TOL)


@pytest.mark.parametrize("family", [f for f in _ILL_CONDITIONED
                                    if f != "mobilenet"])
def test_ill_conditioned_steps_match_reference_in_float64(family,
                                                          monkeypatch):
    """MobileNet's case is ``test_torch_zoo_mobilenet_f64.py``'s, a file
    of its own for ``--dist loadfile``."""
    _hold_ill_conditioned(family, monkeypatch)


def _hold_ill_conditioned(family, monkeypatch):
    """Three float64 steps to ``F64_TOL``; the fp32 step 1, as a whole
    and tensor by tensor, no farther from the reference's float64 step
    than the reference's fp32 step is (twice, plus ``STEP_TOL`` of the
    whole update's norm: a relu6 that rounding flips moves one tensor's
    error by more than its own update in either package)."""
    _Fed(monkeypatch)
    rl, p0, rp = _trajectory(jmx, family, STEPS, torch.float64)
    dl, _, dp = _trajectory(tmx, family, STEPS, torch.float64)
    assert rl[-1] < rl[0]
    _match(dl, dp[-1], rl, rp[-1], F64_TOL)
    jl, _, (jp,) = _trajectory(jmx, family, 1)
    tl, _, (tp,) = _trajectory(tmx, family, 1)
    onp.testing.assert_allclose(tl, rl[:1], rtol=FWD_TOL)
    onp.testing.assert_allclose(jl, rl[:1], rtol=FWD_TOL)
    norm = onp.linalg.norm
    names = sorted(p0)
    whole = norm(onp.concatenate([(rp[0][n] - p0[n]).reshape(-1)
                                  for n in names]))

    def err(p, group):
        return norm(onp.concatenate([(p[n] - rp[0][n]).reshape(-1)
                                     for n in group]))

    for group in [names] + [[n] for n in names]:
        assert err(tp, group) <= 2 * err(jp, group) + STEP_TOL * whole, (
            group if len(group) == 1 else "whole", err(tp, group),
            err(jp, group), whole)


# ---------------------------------------------------------- .params
def test_params_files_cross_both_ways(tmp_path):
    x = _image("squeezenet")
    src = {pkg: _built(pkg, "squeezenet", x, seed=9) for pkg in (jmx, tmx)}
    outs = {}
    for writer, reader in ((jmx, tmx), (tmx, jmx)):
        path = str(tmp_path / f"{writer.__name__}.params")
        src[writer].save_parameters(path)
        net = _built(reader, "squeezenet", x, seed=10)
        net.load_parameters(path)
        outs[reader] = net(reader.nd.array(x)).asnumpy()
        for a, b in zip(_params(net).values(), _params(src[writer]).values()):
            onp.testing.assert_array_equal(a, b)
    _close(outs[tmx], outs[jmx], FWD_TOL)
    a, b = (open(str(tmp_path / f"{p.__name__}.params"), "rb").read()
            for p in (jmx, tmx))
    assert a == b  # the same weights give the same bytes
