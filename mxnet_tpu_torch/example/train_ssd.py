#!/usr/bin/env python
"""Train SSD-300 (VGG16-reduced backbone) on detection data (counterpart
of ``example/ssd/train_ssd.py``, upstream MXNet's example/ssd/train.py).

    python mxnet_tpu_torch/example/train_ssd.py --batch-size 8 --steps 30 [--ctx cpu]

It trains on the reference's synthetic boxes through the imperative
Gluon loop (``autograd.record()``, ``backward``, ``gluon.Trainer.step``
with SGD): ``MultiBoxTarget`` makes the targets, the loss is softmax
cross-entropy over them plus an L1 location term, and the script fails
unless the loss falls.  The reference script's flags, plus ``--ctx``
(``gpu``, the default: the first CUDA card; ``cpu``: the host) and
``--data-shape`` (the image side).  ``--rec FILE`` trains from a
detection RecordIO corpus instead, through ``mx.io.ImageDetRecordIter``
(labels padded with -1), its batches fed to the training device.
:func:`build`, :func:`step` and :func:`train` are what other scripts
call.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon, nd  # noqa: E402


def synthetic_batch(rng, batch_size, num_classes, data_shape=300, ctx=None):
    """Images and per-image ground truth [cls, x1, y1, x2, y2] (up to two
    boxes, rows of -1 after), drawn from ``rng`` as the reference draws
    them, on ``ctx``."""
    x = rng.rand(batch_size, 3, data_shape, data_shape).astype("float32")
    labels = onp.full((batch_size, 3, 5), -1.0, "float32")
    for i in range(batch_size):
        for b in range(rng.randint(1, 3)):
            x1, y1 = rng.uniform(0.0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            labels[i, b] = [rng.randint(0, num_classes),
                            x1, y1, min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return nd.array(x, ctx=ctx), nd.array(labels, ctx=ctx)


def build(num_classes=4, lr=0.004, momentum=0.9, wd=5e-4, data_shape=300,
          ctx=None, network="ssd_300_vgg16_reduced"):
    """``(net, trainer)``: the zoo's ``network`` Xavier-initialized on
    ``ctx`` (from numpy's global RNG), its shapes resolved by one
    forward at ``data_shape``; SGD with momentum and weight decay."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    net = gluon.model_zoo.vision.get_model(network, num_classes=num_classes)
    net.initialize(init=mx.init.Xavier(), ctx=ctx)
    net(nd.zeros((1, 3, data_shape, data_shape), ctx=ctx))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": momentum,
                             "wd": wd})
    return net, trainer


def multibox_loss(cls_preds, loc_preds, anchors, labels, num_classes):
    """The reference recipe's loss (``example/ssd/train_ssd.py:87-93``):
    softmax cross-entropy over ``MultiBoxTarget``'s class targets (an
    ignored anchor's -1 picks the last class, as in the reference) plus
    the mean L1 distance of the masked location targets."""
    loc_t, loc_mask, cls_t = mx.nd.contrib.MultiBoxTarget(
        anchors, labels, cls_preds.transpose((0, 2, 1)),
        overlap_threshold=0.5, negative_mining_ratio=3.0)
    cls_loss = gluon.loss.SoftmaxCrossEntropyLoss()(
        cls_preds.reshape((-1, num_classes + 1)), cls_t.reshape((-1,)))
    loc_loss = nd.abs((loc_preds - loc_t) * loc_mask).mean()
    return cls_loss.mean() + loc_loss


def step(net, trainer, x, y, num_classes, host_ms=None):
    """One training step: forward and loss under ``record()``,
    ``backward``, ``trainer.step`` (its host time appended to
    ``host_ms``).  Returns the loss (an NDArray on the device)."""
    with autograd.record():
        loss = multibox_loss(*net(x), y, num_classes)
    loss.backward()
    t0 = time.perf_counter()
    trainer.step(x.shape[0])
    if host_ms is not None:
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return loss


def next_batch(it, ctx):
    """The next ``(data, label)`` of the iterator ``it`` on ``ctx``,
    starting a new epoch at the end of one."""
    try:
        batch = next(it)
    except StopIteration:
        it.reset()
        batch = next(it)
    return batch.data[0].as_in_context(ctx), batch.label[0].as_in_context(ctx)


def train(batch_size=8, steps=30, lr=0.004, num_classes=4, data_shape=300,
          ctx=None, seed=0, log=logging.info, rec=None):
    """The reference's loop: a fresh synthetic batch each step, or the
    next batch of ``ImageDetRecordIter`` over the corpus ``rec``.
    Returns ``{"losses", "ms_per_step", "net"}`` (and ``"feed"``, the
    iterator's ``stats()``, with ``rec``); ``ms_per_step`` is the wall
    time of the steps, the device synchronized once at the end."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    net, trainer = build(num_classes, lr, data_shape=data_shape, ctx=ctx)
    rng = onp.random.RandomState(seed)
    it = None if rec is None else mx.io.ImageDetRecordIter(
        path_imgrec=rec, batch_size=batch_size,
        data_shape=(3, data_shape, data_shape), ctx=ctx)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        if it is not None:
            x, y = next_batch(it, ctx)
        else:
            x, y = synthetic_batch(rng, batch_size, num_classes, data_shape,
                                   ctx)
        losses.append(step(net, trainer, x, y, num_classes))
        if i % 10 == 0:
            log(f"step {i} multibox loss {float(losses[-1].asnumpy()):.4f}")
    mx.nd.waitall()
    wall = time.perf_counter() - t0
    losses = [float(v.asnumpy()) for v in losses]
    res = {"losses": losses, "ms_per_step": wall / max(steps, 1) * 1e3,
           "net": net}
    if it is not None:
        res["feed"] = it.stats()
        it.close()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.004)
    ap.add_argument("--num-classes", type=int, default=4)
    ap.add_argument("--data-shape", type=int, default=300)
    ap.add_argument("--rec", default=None,
                    help="detection .rec file (synthetic data if unset)")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    res = train(args.batch_size, args.steps, args.lr, args.num_classes,
                args.data_shape, ctx, rec=args.rec)
    first, last = res["losses"][0], res["losses"][-1]
    logging.info("loss %.4f -> %.4f, %.1f ms/step", first, last,
                 res["ms_per_step"])
    if not last < first:
        raise SystemExit(f"multibox loss did not decrease: {first:.4f} -> "
                         f"{last:.4f}")
    print("train_ssd OK")
    return res


if __name__ == "__main__":
    main()
