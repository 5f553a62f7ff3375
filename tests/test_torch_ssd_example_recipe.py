"""Three steps of the port's ``example/train_ssd.py`` recipe (the
VGG16-reduced SSD at 48²) on both packages.

Each recipe test has a file of its own, so that ``pytest -n N --dist
loadfile`` gives it a worker of its own: the reference compiles every
op of the net at its first use, once in fp32 and once in float64, and
that cost dominates the run.  The recipes and their tolerances are
``test_torch_ssd.py``'s (see its docstring).
"""
import numpy as onp

import mxnet_tpu_torch as tmx
from test_torch_ssd import (  # noqa: F401 (the autouse fixture)
    _host, _hold_steps, _example_recipe_loss, train_ssd)


def test_example_recipe_three_steps_match_reference():
    rng = onp.random.RandomState(0)
    batches = []
    for _ in range(3):
        x, y = train_ssd.synthetic_batch(rng, 2, 4, data_shape=48,
                                         ctx=tmx.cpu())
        batches.append((x.asnumpy(), y.asnumpy()))
    assert (batches[0][1][:, :, 0] == -1).any()  # padding rows
    _hold_steps("ssd_300_vgg16_reduced", batches, _example_recipe_loss,
                lr=0.004, momentum=0.9, wd=5e-4)
