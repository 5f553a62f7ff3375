"""The port's ``example/train_imagenet.py`` held against the reference's
``example/image-classification/train_imagenet.py`` on the CPU: one tiny
JPEG corpus (12 images of 104², ResNet-18 v1 at 96², batch 4, 10
classes, fp32), the reference's initial weights copied into the port's step by
name (the two packages' initializers draw in another order), the same
``ImageRecordIter`` batches (the native library decodes on both sides),
three SGD steps at lr 0.01: losses within 1e-4.  At 32² the last stage
is 1x1, so its BatchNorm normalises 4 values a channel: there a 1e-6
relative change of the port's own weights moves its second loss by 0.1,
and no two float32 implementations agree; at the example's lr 0.1 the
loss blows up from 2.3 to 15 in three steps."""
import importlib.util
import os
import sys

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import test_utils as jtu  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import _native  # noqa: E402
from mxnet_tpu_torch.example import train_imagenet as t_ex  # noqa: E402

from test_torch_device_feed import limited  # noqa: E402

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "example", "image-classification", "train_imagenet.py")


def _reference_example():
    spec = importlib.util.spec_from_file_location("ref_train_imagenet",
                                                  _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARGS = ["--network", "resnet18_v1", "--batch-size", "4", "--image-shape",
        "3,96,96", "--num-classes", "10", "--dtype", "float32",
        "--epochs", "1", "--lr", "0.01"]


@limited(240)
def test_three_steps_match_reference(tmp_path, monkeypatch):
    if _native.get_lib() is None:
        pytest.skip("needs g++ and libjpeg for the native library")
    path = str(tmp_path / "train.rec")
    jtu.write_rec_corpus(path, n=12, size=104, seed=9,
                         labels=lambda i: i % 10)
    ref = _reference_example()
    losses = []
    first = {}

    def recording(*a, **kw):
        step_fn, params, state = make(*a, **kw)
        first.update({n: onp.asarray(v) for n, v in params.items()})

        def step(*sa):
            out = step_fn(*sa)
            losses.append(float(out[0]))
            return out
        return step, params, state

    make = ref.make_train_step
    monkeypatch.setattr(ref, "make_train_step", recording)
    monkeypatch.setattr(sys, "argv", ["train_imagenet.py", "--data-train",
                                      path] + ARGS)
    onp.random.seed(0)
    ref.main()
    t_make = t_ex.make_train_step

    def unprefixed(names):
        # a block's name prefix counts the nets a process has made
        # (``resnetv10_`` or later), so it differs between packages
        return {n.split("_", 1)[1]: n for n in names}

    def from_reference(*a, **kw):
        step_fn, params, state = t_make(*a, **kw)
        ref_names = unprefixed(first)
        assert sorted(unprefixed(params)) == sorted(ref_names)
        with torch.no_grad():
            for short, n in unprefixed(params).items():
                params[n].copy_(torch.from_numpy(first[ref_names[short]]))
        return step_fn, params, state

    monkeypatch.setattr(t_ex, "make_train_step", from_reference)
    res = t_ex.train(t_ex.parse_args(["--data-train", path, "--ctx", "cpu"]
                                     + ARGS), log=lambda *a: None)
    assert res["steps"] == len(losses) == 3
    assert all(onp.isfinite(res["losses"]))
    onp.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-4)


def test_dist_store_and_many_cards_raise(tmp_path):
    path = str(tmp_path / "t.rec")
    jtu.write_rec_corpus(path, n=4, size=16, seed=2)
    args = t_ex.parse_args(["--data-train", path, "--ctx", "cpu",
                            "--kv-store", "dist_sync"] + ARGS)
    with pytest.raises(tmx.MXNetError, match="§A 11"):
        t_ex.build(args)
    args = t_ex.parse_args(["--data-train", path, "--ctx", "cpu",
                            "--gpus", "0,1"] + ARGS)
    with pytest.raises(tmx.MXNetError):
        t_ex.build(args)
