#!/usr/bin/env python
"""Train LeNet/MLP on MNIST with the imperative Gluon loop (counterpart
of ``example/image-classification/train_mnist.py``).

    python mxnet_tpu_torch/example/train_mnist.py --network lenet [--ctx cpu]

The same flags as the reference's script, plus ``--ctx`` (``gpu``, the
default: the first CUDA card; ``cpu``: the host).  Without
``--data-dir`` it trains on the reference's synthetic digits (class k
is a bright (k+2)x(k+2) top-left patch over noise).  :func:`train`
returns the per-epoch losses and accuracies and the step time.
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
from mxnet_tpu_torch import autograd, gluon  # noqa: E402


def build(network):
    net = gluon.nn.HybridSequential()
    if network == "mlp":
        net.add(gluon.nn.Flatten(),
                gluon.nn.Dense(128, activation="relu"),
                gluon.nn.Dense(64, activation="relu"),
                gluon.nn.Dense(10))
    else:  # lenet
        net.add(gluon.nn.Conv2D(20, 5, activation="tanh"),
                gluon.nn.MaxPool2D(2, 2),
                gluon.nn.Conv2D(50, 5, activation="tanh"),
                gluon.nn.MaxPool2D(2, 2),
                gluon.nn.Flatten(),
                gluon.nn.Dense(500, activation="tanh"),
                gluon.nn.Dense(10))
    return net


def synth(n, seed):
    """The reference's synthetic digits: ``n`` 28x28x1 images in [0, 1]
    with labels, from ``seed``."""
    rng = onp.random.RandomState(seed)
    y = rng.randint(0, 10, n).astype("int32")
    x = rng.rand(n, 28, 28, 1).astype("float32") * 0.2
    for i in range(n):
        k = 2 + y[i]
        x[i, :k, :k, 0] += 0.8
    return gluon.data.ArrayDataset(x, y)


def _on(data, ctx, network):
    data = data.as_in_context(ctx)
    if network == "lenet" and data.ndim == 4:
        data = data.transpose((0, 3, 1, 2))
    return data


def train(network="lenet", batch_size=64, epochs=2, lr=0.02, ctx=None,
          train_ds=None, val_ds=None, log=logging.info):
    """The reference's loop: ``autograd.record()`` forward and loss,
    ``backward``, ``Trainer.step``, ``metric.Accuracy`` per epoch, then
    validation.  Returns ``{"epochs": [{"loss", "train_acc"}],
    "val_acc", "ms_per_step", "ms_per_step_by_epoch", "steps"}``:
    ``ms_per_step`` is the mean wall time of a step (data to the
    device, forward, backward, update, metrics) with the device
    synchronized once per epoch; by epoch, the first one holds the
    warm-up."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    train_ds = train_ds if train_ds is not None else synth(4096, 1)
    val_ds = val_ds if val_ds is not None else synth(512, 2)
    train_data = gluon.data.DataLoader(train_ds, batch_size=batch_size,
                                       shuffle=True)
    val_data = gluon.data.DataLoader(val_ds, batch_size=batch_size)

    net = build(network)
    net.initialize(init=mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    losses = mx.metric.Loss()

    res = {"epochs": [], "steps": 0, "ms_per_step_by_epoch": []}
    step_s = 0.0
    for epoch in range(epochs):
        steps0 = res["steps"]
        metric.reset()
        losses.reset()
        t0 = time.perf_counter()
        for data, label in train_data:
            data = _on(data, ctx, network)
            label = label.as_in_context(ctx)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            metric.update([label], [out])
            losses.update(None, [loss])
            res["steps"] += 1
        mx.nd.waitall()
        step_s += time.perf_counter() - t0
        res["ms_per_step_by_epoch"].append(
            (time.perf_counter() - t0) * 1e3 / max(res["steps"] - steps0, 1))
        name, acc = metric.get()
        res["epochs"].append({"loss": float(losses.get()[1]),
                              "train_acc": float(acc)})
        log(f"epoch {epoch}: loss {losses.get()[1]:.4f} train "
            f"{name}={acc:.4f}")

    metric.reset()
    for data, label in val_data:
        out = net(_on(data, ctx, network))
        metric.update([label.as_in_context(ctx)], [out])
    res["val_acc"] = float(metric.get()[1])
    res["ms_per_step"] = step_s / max(res["steps"], 1) * 1e3
    log(f"validation {metric.get()[0]}={res['val_acc']:.4f}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="lenet", choices=["mlp", "lenet"])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--data-dir", default=None,
                    help="directory with the MNIST idx files (not ported "
                         "yet: the synthetic digits are used without it)")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data_dir:
        raise SystemExit("--data-dir: the MNIST dataset is not ported yet "
                         "(ROADMAP §A item 6)")
    logging.info("no --data-dir: training on synthetic digits")
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    res = train(args.network, args.batch_size, args.epochs, args.lr, ctx)
    logging.info("%.3f ms/step over %d steps", res["ms_per_step"],
                 res["steps"])


if __name__ == "__main__":
    main()
