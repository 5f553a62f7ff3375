#!/usr/bin/env python
"""ImageNet-style training from RecordIO (counterpart of
``example/image-classification/train_imagenet.py``; upstream MXNet's
example/image-classification/train_imagenet.py + common/fit.py).

    python mxnet_tpu_torch/example/train_imagenet.py \\
        --data-train train.rec --network resnet50_v1 --batch-size 128

``ImageRecordIter`` feeds ``parallel.make_train_step``: on the card the
iterator decodes each batch's JPEGs with nvJPEG and augments them with
the hand-written kernel ahead of the step (the device feed), so batches
arrive on the card and never cross back to the host.  The reference's
flags (``--gpus`` and ``--kv-store dist_sync`` raise: one card, one
process, ROADMAP §A 11), plus ``--ctx`` (``gpu``, the default: the first
CUDA card; ``cpu``: decode with the native library and train on the
host).  With ``--data-parallel-mesh`` the step takes the one-card mesh,
and ``MXNET_OPTIMIZER_SHARDING=ps`` puts the update on the flat-bucket
kernels, as the reference's step follows that knob.  :func:`build` and :func:`train` are what other scripts call.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import gluon  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import get_mesh, make_train_step  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-train", required=True)
    ap.add_argument("--network", default="resnet50_v1")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--optimizer", default="sgd",
                    help="any registry optimizer, e.g. lars")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--loss-scale", default=None,
                    help="'dynamic' or a float")
    ap.add_argument("--kv-store", default="device",
                    help="device | local (dist_* is not ported yet)")
    ap.add_argument("--data-parallel-mesh", action="store_true",
                    help="take the one-card data mesh")
    ap.add_argument("--gpus", default=None,
                    help="comma list of device ids (one card only)")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return ap.parse_args(argv)


def build(args):
    """``(kv, it, step_fn, params, opt_state)``: the store, the record
    iterator on the target (``--ctx``), the zoo's ``--network``
    Xavier-initialised (numpy's global RNG, as the reference's) with its
    shapes resolved by one forward, and the train step."""
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    kv = mx.kv.create(args.kv_store)
    shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.gpus:
        ids = [int(i) for i in args.gpus.split(",")]
        mesh = get_mesh(devices=[mx.gpu(i) for i in ids])
    else:
        mesh = get_mesh(devices=[ctx]) if args.data_parallel_mesh \
            else None
    it = mx.io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=shape,
        batch_size=args.batch_size, shuffle=True, rand_crop=True,
        rand_mirror=True, resize=256 if shape[1] >= 224 else -1,
        mean_r=123.68, mean_g=116.28, mean_b=103.53,
        std_r=58.395, std_g=57.12, std_b=57.375,
        part_index=kv.rank, num_parts=kv.num_workers, ctx=ctx)
    net = gluon.model_zoo.vision.get_model(args.network,
                                           classes=args.num_classes)
    net.initialize(init=mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((1,) + shape, ctx=ctx))
    sharding = mx.config.get_env("MXNET_OPTIMIZER_SHARDING") or None
    step_fn, params, opt_state = make_train_step(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer=args.optimizer, learning_rate=args.lr, momentum=0.9,
        compute_dtype=args.dtype if args.dtype != "float32" else None,
        loss_scale=args.loss_scale, mesh=mesh, donate=False,
        optimizer_sharding=sharding if mesh is not None else None,
        device=None if mesh is not None else ctx)
    return kv, it, step_fn, params, opt_state


def train(args, log=logging.info):
    """The reference's loop: each batch of the iterator, already on the
    step's device, through the step.  Returns ``{"losses", "steps",
    "img_s"}`` (``img_s`` over the whole run, host clock, the device
    synchronised at the end)."""
    kv, it, step_fn, params, opt_state = build(args)
    losses = []
    t = 0
    tic = time.time()
    n = 0
    loss = None
    try:
        for epoch in range(args.epochs):
            it.reset()
            for batch in it:
                x = batch.data[0]._data
                y = batch.label[0]._data
                t += 1
                loss, params, opt_state = step_fn(params, opt_state, x, y,
                                                  0, float(t))
                losses.append(loss)
                n += x.shape[0]
                if t % 50 == 0:
                    log("epoch %d iter %d: loss=%.4f %.1f img/s" % (
                        epoch, t, float(loss), n / (time.time() - tic)))
    finally:
        it.close()
    if loss is None:
        raise MXNetError("no batch: the record file is empty")
    losses = [float(v) for v in losses]  # the one sync, at the end
    return {"losses": losses, "steps": t,
            "img_s": n / (time.time() - tic)}


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    res = train(args)
    logging.info("done: final loss %.4f", res["losses"][-1])
    return res


if __name__ == "__main__":
    main()
