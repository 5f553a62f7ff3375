"""The SSD detectors (``gluon/model_zoo/vision/ssd.py``), their training
recipe, the port's ``example/train_ssd.py`` and the rest of
``gluon.loss`` held against the JAX package on the CPU.

Inputs are numpy from a seed; weights come from ``np.random.seed`` +
``initialize(Xavier())`` in both packages (equal bit for bit).
Tolerances (fp32):

- the three SSD names: the reference's parameter names, shapes and
  output shapes; forward at 128² (VGG16-reduced, 4 classes) and 96²
  (ResNet-18) to 1e-5 of each output's largest magnitude; ``.params``
  files cross both ways (the same bytes from the same weights);
- three steps of ``tests/test_detection.py``'s
  ``test_ssd_trains_and_detects`` recipe (``test_torch_ssd_detection_
  recipe.py``) (ResNet-18 SSD, BatchNorm
  training, masked cross-entropy and smooth L1 over the targets), and
  three of the example's (VGG16-reduced at 48², ignored anchors fed to
  the cross-entropy as -1; ``test_torch_ssd_example_recipe.py``): in float64 (both packages kept float64
  throughout) every loss and parameter to 1e-8 of its largest
  magnitude; in fp32, every loss and parameter (as a whole and tensor
  by tensor) no farther from the reference's float64 steps than twice
  the reference's own fp32 distance, plus 1e-4 of the whole update.
  The reference's fp32 step is the less accurate one here: the
  ResNet-18 SSD's stem weight departs 0.4 % from float64 after one
  step there, 1.5e-6 in the port (ROADMAP §C);
- every loss of ``gluon.loss``, forward and gradient to 1e-5.
"""
import contextlib
import importlib
import os
import subprocess
import sys
import types

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as j_vision  # noqa: E402
from mxnet_tpu.ops import nn as j_nn_ops  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.example import train_ssd  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as t_vision  # noqa: E402
from mxnet_tpu_torch.ops import nn as t_nn_ops  # noqa: E402

FWD_TOL = 1e-5
STEP_TOL = 1e-4
F64_TOL = 1e-8
LOSS_TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_NETS = {  # name -> (num_classes, input side)
    "ssd_300_vgg16_reduced": (4, 128),
    "ssd_512_vgg16": (3, 128),
    "ssd_300_resnet18": (2, 96),
}


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


def _image(side, batch=2, seed=1):
    return onp.random.RandomState(seed).rand(batch, 3, side, side) \
        .astype("float32")


@contextlib.contextmanager
def _fresh_names(pkg):
    """Each package's per-process block-name counter
    (``gluon.block._NM``) starts from zero for one build and comes back
    as it was after: the auto-generated prefixes (``resnetv10_``, ...)
    then do not depend on which nets earlier tests of the same process
    built with only one of the packages."""
    nm = importlib.import_module(pkg.__name__ + ".gluon.block")._NM
    saved, nm._counter = nm._counter, {}
    try:
        yield
    finally:
        nm._counter = saved


def _built(pkg, name, seed=0):
    classes, side = SSD_NETS[name]
    onp.random.seed(seed)
    with _fresh_names(pkg):
        net = (j_vision if pkg is jmx else t_vision).get_model(
            name, num_classes=classes)
    net.initialize(init=pkg.init.Xavier())
    net(pkg.nd.array(_image(side, batch=1)))  # resolve deferred shapes
    return net


def _params(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", sorted(SSD_NETS))
def test_ssd_builds_with_reference_names_and_outputs(name):
    j, t = _built(jmx, name), _built(tmx, name)
    assert list(t.collect_params()) == list(j.collect_params())
    jp, tp = _params(j), _params(t)
    assert list(tp) == list(jp)
    for k in jp:
        onp.testing.assert_array_equal(tp[k], jp[k])
    x = _image(SSD_NETS[name][1])
    j_out, t_out = j(jmx.nd.array(x)), t(tmx.nd.array(x))
    for a, b in zip(t_out, j_out):
        assert a.shape == b.shape
        assert _rel(a.asnumpy(), b.asnumpy()) <= FWD_TOL
    n = t_out[2].shape[1]
    assert t_out[0].shape == (2, n, SSD_NETS[name][0] + 1)
    assert t_out[1].shape == (2, 4 * n)


def test_get_model_builds_the_three_names():
    for name in SSD_NETS:
        net = t_vision.get_model(name)
        assert type(net).__name__ == "SSD" and net.num_classes == 20
    assert {"SSD", "get_ssd", "ssd_300_vgg16_reduced", "ssd_512_vgg16",
            "ssd_300_resnet18"} <= set(t_vision.__all__)
    with pytest.raises(ValueError, match="backbone"):
        t_vision.get_ssd("vgg19")


def test_params_files_cross_both_ways(tmp_path):
    name = "ssd_300_resnet18"
    x = _image(SSD_NETS[name][1])
    src = {jmx: _built(jmx, name, seed=3), tmx: _built(tmx, name, seed=3)}
    outs = {}
    for writer, reader in ((jmx, tmx), (tmx, jmx)):
        path = str(tmp_path / f"{writer.__name__}.params")
        src[writer].save_parameters(path)
        net = _built(reader, name, seed=4)
        net.load_parameters(path)
        for a, b in zip(_params(net).values(), _params(src[writer]).values()):
            onp.testing.assert_array_equal(a, b)
        outs[reader] = [o.asnumpy() for o in net(reader.nd.array(x))]
    for a, b in zip(outs[tmx], outs[jmx]):
        assert _rel(a, b) <= FWD_TOL
    a, b = (open(str(tmp_path / f"{p.__name__}.params"), "rb").read()
            for p in (jmx, tmx))
    assert a == b


# ------------------------------------------------------------ training
def _detection_recipe_loss(pkg, net, x, labels):
    """``test_ssd_trains_and_detects``'s loss: ignored anchors masked out
    of the cross-entropy, both terms over the positives."""
    cls_preds, loc_preds, anchors = net(x)
    loc_t, loc_m, cls_t = net.training_targets(anchors, cls_preds, labels)
    lc = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
        cls_preds.reshape((-1, net.num_classes + 1)), cls_t.reshape((-1,)))
    keep = cls_t.reshape((-1,)) >= 0
    npos = (cls_t > 0).sum() + 1e-6
    lc = (lc * keep).sum() / npos
    ll = pkg.nd.smooth_l1((loc_preds - loc_t) * loc_m, scalar=1.0).sum() \
        / npos
    return lc + ll


def _example_recipe_loss(pkg, net, x, labels):
    """The example's loss (``example/ssd/train_ssd.py:87-93``)."""
    if pkg is tmx:
        return train_ssd.multibox_loss(*net(x), labels, net.num_classes)
    cls_preds, loc_preds, anchors = net(x)
    loc_t, loc_mask, cls_t = jmx.nd.contrib.MultiBoxTarget(
        anchors, labels, cls_preds.transpose((0, 2, 1)),
        overlap_threshold=0.5, negative_mining_ratio=3.0)
    cls_loss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        cls_preds.reshape((-1, net.num_classes + 1)), cls_t.reshape((-1,)))
    loc_loss = jmx.nd.abs((loc_preds - loc_t) * loc_mask).mean()
    return cls_loss.mean() + loc_loss


class _Float64(types.ModuleType):
    """``jax.numpy`` or ``torch`` whose ``float32`` is float64: both
    packages' BatchNorm rounds a float64 step's batch statistics to
    fp32; patched in as their ``jnp``/``torch``, it keeps the step
    float64 throughout."""

    def __init__(self, base):
        super().__init__(base.__name__)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, "float64" if name == "float32" else name)


_F64_PATCHES = {jmx: (j_nn_ops, "jnp", jnp), tmx: (t_nn_ops, "torch", torch)}


def _train(pkg, name, batches, loss_fn, lr, f64=False, steps=3, **opt):
    """(losses, params before, params after ``steps`` Gluon steps)."""
    dt = "float64" if f64 else "float32"
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        if f64:
            mod, attr, base = _F64_PATCHES[pkg]
            mp.setattr(mod, attr, _Float64(base))
        onp.random.seed(0)
        classes, _ = SSD_NETS[name]
        net = (j_vision if pkg is jmx else t_vision).get_model(
            name, num_classes=classes)
        net.initialize(init=pkg.init.Xavier())
        # resolve the deferred shapes at the training batch: a predict
        # pass moves nothing, and at the steps' shapes the reference
        # compiles its ops once for both passes
        net(pkg.nd.array(batches[0][0]))
        net.cast(dt)
        before = _params(net)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(learning_rate=lr, **opt))
        losses = []
        for i in range(steps):
            x, y = (pkg.nd.array(a.astype(dt), dtype=dt)
                    for a in batches[i % len(batches)])
            with pkg.autograd.record():
                loss = loss_fn(pkg, net, x, y)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(float(loss.asnumpy()))
        return net, losses, before, _params(net)


def _hold_steps(name, batches, loss_fn, lr, **opt):
    """The float64 steps to ``F64_TOL``; the fp32 steps (losses, the
    parameters as a whole and tensor by tensor) no farther from the
    reference's float64 steps than twice the reference's own fp32
    distance from them, plus ``STEP_TOL`` of the whole update.  Returns
    the two fp32 runs."""
    runs = {(pkg, f64): _train(pkg, name, batches, loss_fn, lr, f64, **opt)
            for pkg in (jmx, tmx) for f64 in (False, True)}
    _, r_losses, r_before, ref = runs[jmx, True]
    _, d_losses, _, dp = runs[tmx, True]
    onp.testing.assert_allclose(d_losses, r_losses, rtol=F64_TOL)
    for k in ref:
        assert _rel(dp[k], ref[k]) <= F64_TOL, k
    (_, j_losses, _, jp), (_, t_losses, _, tp) = runs[jmx, False], \
        runs[tmx, False]
    r, j, t = (onp.asarray(v) for v in (r_losses, j_losses, t_losses))
    assert (abs(t - r) <= 2 * abs(j - r) + STEP_TOL * abs(r)).all(), \
        (t_losses, j_losses, r_losses)
    norm = onp.linalg.norm
    whole = norm(onp.concatenate([(ref[k] - r_before[k]).reshape(-1)
                                  for k in ref]))

    def err(p, group):
        return norm(onp.concatenate([(p[k] - ref[k]).reshape(-1)
                                     for k in group]))

    for group in [list(ref)] + [[k] for k in ref]:
        assert err(tp, group) <= 2 * err(jp, group) + STEP_TOL * whole, (
            group if len(group) == 1 else "whole", err(tp, group),
            err(jp, group), whole)
    return runs[jmx, False], runs[tmx, False]


def test_example_trains_on_the_host(tmp_path):
    res = train_ssd.train(batch_size=2, steps=3, lr=0.004, num_classes=2,
                          data_shape=64, ctx=tmx.cpu())
    assert len(res["losses"]) == 3 and all(onp.isfinite(res["losses"]))
    params = res["net"].collect_params()
    assert {str(p.data()._data.device) for p in params.values()} == {"cpu"}
    # --rec: ImageDetRecordIter over a detection corpus, past an epoch
    from test_torch_image_det_record_iter import write_det_corpus

    rec = str(tmp_path / "det.rec")
    write_det_corpus(rec, n=5, classes=2)
    res = train_ssd.train(batch_size=2, steps=4, lr=0.004, num_classes=2,
                          data_shape=64, ctx=tmx.cpu(), rec=rec)
    assert len(res["losses"]) == 4 and all(onp.isfinite(res["losses"]))
    assert res["feed"]["batches"] >= 4


def test_example_script_runs_with_ctx_cpu():
    """The script itself, as a user runs it: it fails unless the loss
    falls, so it runs long enough for that at a tiny size."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "mxnet_tpu_torch", "example",
                                      "train_ssd.py"),
         "--ctx", "cpu", "--batch-size", "2", "--steps", "12",
         "--data-shape", "64", "--num-classes", "2", "--lr", "0.01"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "train_ssd OK" in out.stdout


def test_example_defaults_to_the_card():
    """``--ctx`` is the card unless ``cpu`` is asked for: without one,
    the default raises instead of falling back to the host."""
    if tmx.num_gpus():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(MXNetError):
        train_ssd.main(["--batch-size", "1", "--steps", "1",
                        "--data-shape", "64"])


# ---------------------------------------------------------------- losses
def _f32(*shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


LOSS_CASES = {  # name -> (class, kwargs, inputs, sample_weight shape)
    "l2": ("L2Loss", {}, lambda: [_f32(4, 5), _f32(4, 5, seed=1)], (4, 1)),
    "l2_weight": ("L2Loss", dict(weight=3.0), lambda: [
        _f32(4, 2, 3), _f32(4, 6, seed=1)], None),
    "l1": ("L1Loss", dict(batch_axis=1), lambda: [
        _f32(3, 4), _f32(3, 4, seed=1)], (1, 4)),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}, lambda: [
        _f32(4, 5), (_f32(4, 5, seed=1) > 0).astype("float32")], (4, 1)),
    "sigmoid_bce_pos_weight": ("SigmoidBCELoss", {}, lambda: [
        _f32(4, 5), (_f32(4, 5, seed=1) > 0).astype("float32"), None,
        onp.abs(_f32(1, 5, seed=2)) + 0.5], None),
    "sigmoid_bce_from_sigmoid": ("SigmoidBCELoss", dict(from_sigmoid=True),
                                 lambda: [1 / (1 + onp.exp(-_f32(4, 5))),
                                          (_f32(4, 5, seed=1) > 0)
                                          .astype("float32")], None),
    "sigmoid_bce_from_sigmoid_pos_weight": (
        "SigmoidBCELoss", dict(from_sigmoid=True), lambda: [
            1 / (1 + onp.exp(-_f32(4, 5))),
            (_f32(4, 5, seed=1) > 0).astype("float32"), None,
            onp.abs(_f32(1, 5, seed=2)) + 0.5], None),
    "kl_div": ("KLDivLoss", {}, lambda: [
        onp.log(onp.abs(_f32(4, 5)) + 0.1),
        onp.abs(_f32(4, 5, seed=1)) + 0.01], (4, 1)),
    "kl_div_logits": ("KLDivLoss", dict(from_logits=False), lambda: [
        _f32(4, 5), onp.abs(_f32(4, 5, seed=1)) + 0.01], None),
    "huber": ("HuberLoss", dict(rho=0.7), lambda: [
        _f32(4, 5), _f32(4, 5, seed=1)], (4, 1)),
    "hinge": ("HingeLoss", dict(margin=0.5), lambda: [
        _f32(4, 5), onp.sign(_f32(4, 5, seed=1))], (4, 1)),
    "squared_hinge": ("SquaredHingeLoss", {}, lambda: [
        _f32(4, 5), onp.sign(_f32(4, 5, seed=1))], None),
    "logistic_signed": ("LogisticLoss", {}, lambda: [
        _f32(4, 5), onp.sign(_f32(4, 5, seed=1))], (4, 1)),
    "logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                        lambda: [_f32(4, 5), (_f32(4, 5, seed=1) > 0)
                                 .astype("float32")], None),
    "triplet": ("TripletLoss", dict(margin=0.3), lambda: [
        _f32(4, 6), _f32(4, 6, seed=1), _f32(4, 6, seed=2)], (4,)),
    "poisson": ("PoissonNLLLoss", {}, lambda: [
        _f32(4, 5) * 0.5, onp.abs(_f32(4, 5, seed=1)) * 3], None),
    "poisson_full": ("PoissonNLLLoss", dict(from_logits=False,
                                            compute_full=True), lambda: [
        onp.abs(_f32(4, 5)) + 0.2, onp.round(onp.abs(
            _f32(4, 5, seed=1)) * 3)], (4, 1)),
    "cosine": ("CosineEmbeddingLoss", dict(margin=0.2), lambda: [
        _f32(4, 6), _f32(4, 6, seed=1),
        onp.array([1, -1, 1, -1], "float32")], (4, 1)),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}, lambda: [
        _f32(4, 5), onp.array([0, 4, 2, -1], "float32")], (4, 1)),
}


def _loss_run(pkg, case):
    cls, kw, make, sw_shape = LOSS_CASES[case]
    arrays = make()
    xs = [None if a is None else pkg.nd.array(a) for a in arrays]
    xs[0].attach_grad()
    extra = []
    if sw_shape is not None:
        extra = [pkg.nd.array(onp.abs(_f32(*sw_shape, seed=7)))]
    with pkg.autograd.record():
        loss = getattr(pkg.gluon.loss, cls)(**kw)(*xs, *extra)
    loss.backward()
    return loss.asnumpy(), xs[0].grad.asnumpy()


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_reference(case):
    (jl, jg), (tl, tg) = _loss_run(jmx, case), _loss_run(tmx, case)
    assert tl.shape == jl.shape
    onp.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    onp.testing.assert_allclose(tg, jg, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_loss_names_and_refusals():
    from mxnet_tpu.gluon import loss as j_loss

    t_names = set(tmx.gluon.loss.__all__)
    assert t_names == set(j_loss.__all__) - {"CTCLoss"}
    assert tmx.gluon.loss.SigmoidBCELoss is \
        tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss
    with pytest.raises(MXNetError, match="label_format"):
        tmx.gluon.loss.LogisticLoss(label_format="other")
    with pytest.raises(MXNetError, match="number"):
        tmx.gluon.loss.L1Loss(weight="2")(tmx.nd.ones((2, 3)),
                                          tmx.nd.ones((2, 3)))
    assert repr(tmx.gluon.loss.L2Loss()) == repr(jmx.gluon.loss.L2Loss())
