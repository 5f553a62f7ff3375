"""Three steps of the reference's ``test_ssd_trains_and_detects``
recipe (the ResNet-18 SSD) on both packages, then ``detect``.

Each recipe test has a file of its own, so that ``pytest -n N --dist
loadfile`` gives it a worker of its own: the reference compiles every
op of the net at its first use, once in fp32 and once in float64, and
that cost dominates the run.  The recipes and their tolerances are
``test_torch_ssd.py``'s (see its docstring).
"""
import numpy as onp

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from test_torch_ssd import (  # noqa: F401 (the autouse fixture)
    _host, _hold_steps, _detection_recipe_loss)


def test_detection_recipe_three_steps_match_reference():
    x = onp.random.RandomState(5).rand(2, 3, 96, 96).astype("float32")
    labels = onp.array([[[0, 0.1, 0.1, 0.45, 0.45]],
                        [[1, 0.5, 0.5, 0.95, 0.95]]], "float32")
    runs = _hold_steps("ssd_300_resnet18", [(x, labels)],
                       _detection_recipe_loss, lr=0.01)
    dets = []
    for pkg, (net, *_) in zip((jmx, tmx), runs):
        cls_preds, loc_preds, anchors = net(pkg.nd.array(x))
        dets.append(net.detect(cls_preds, loc_preds, anchors).asnumpy())
    j_det, t_det = dets
    assert t_det.shape == j_det.shape == (2, 200, 6)
    kept = t_det[t_det[:, :, 0] >= 0]
    assert len(kept) and ((kept[:, 1] >= 0) & (kept[:, 1] <= 1)).all()
