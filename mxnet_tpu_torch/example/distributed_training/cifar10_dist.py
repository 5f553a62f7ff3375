#!/usr/bin/env python
"""Distributed data-parallel training of ResNet-18 v1 on CIFAR-10-sized
images (counterpart of ``example/distributed_training/cifar10_dist.py``).

    python -m mxnet_tpu_torch.tools.launch -n 2 [--cpu] \\
        python mxnet_tpu_torch/example/distributed_training/cifar10_dist.py \\
        --synthetic

The reference's arguments and loop: ``get_resnet(1, 18, classes=10)``,
3x32x32 random images and labels from each worker's own seed
(``1000 + rank``), batch 64 a worker, SGD at lr 0.05 over a
``dist_sync`` store, the Trainer summing the gradients over the workers
and each worker updating its replica (``update_on_kvstore=False``), 30
steps.  Every worker seeds the initializers' RNG with 0, so the
replicas start equal and stay equal.  ``--kvstore dist_async``
updates on the parameter server's shards instead; ``--out PREFIX``
writes each worker's losses, timings and wire bytes to
``PREFIX.r<rank>.json`` and its parameters to ``PREFIX.r<rank>.npz``.
The workers run on the card unless the launcher was given ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402


def _sync(ctx):
    if ctx.device_type == "gpu":
        import torch

        torch.cuda.synchronize()


def train(args):
    """Run the loop; returns this worker's report."""
    kv = mx.kv.create(args.kvstore)
    logging.info("worker %d/%d", kv.rank, kv.num_workers)
    ctx = mx.current_context()
    # every replica must start equal: update_on_kvstore=False
    # broadcasts no weights
    onp.random.seed(0)
    mx.random.seed(0)
    net = gluon.model_zoo.vision.get_resnet(1, 18, classes=10)
    net.initialize(init=mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr}, kvstore=kv,
                            update_on_kvstore=args.kvstore == "dist_async")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    rng = onp.random.RandomState(1000 + kv.rank)  # per-worker shard
    global_batch = args.batch_size * kv.num_workers
    losses, step_host_ms, wire = [], [], []
    t0 = None
    for step in range(args.steps):
        if step == min(2, args.steps - 1):
            _sync(ctx)
            t0 = time.perf_counter()
            timed_from = step
        x = mx.nd.array(rng.rand(args.batch_size, 3, 32, 32)
                        .astype("float32"), ctx=ctx)
        y = mx.nd.array(rng.randint(0, 10, args.batch_size)
                        .astype("float32"), ctx=ctx)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        bytes0 = kv.total_wire_bytes
        h0 = time.perf_counter()
        trainer.step(global_batch)
        step_host_ms.append((time.perf_counter() - h0) * 1e3)
        wire.append(kv.total_wire_bytes - bytes0)
        losses.append(float(loss.mean().asnumpy()))
        if step % 10 == 0:
            logging.info("worker %d step %d loss %.4f", kv.rank, step,
                         losses[-1])
    _sync(ctx)
    wall = time.perf_counter() - t0
    kv.barrier()
    timed = args.steps - timed_from
    report = {
        "rank": kv.rank, "num_workers": kv.num_workers,
        "kvstore": args.kvstore, "backend": kv.backend, "shard": kv.shard,
        "device": str(ctx), "losses": losses,
        "ms_per_step": wall / timed * 1e3,
        "img_s_all_workers": global_batch * timed / wall,
        "trainer_step_host_ms": sum(step_host_ms[timed_from:]) / timed,
        "wire_bytes_per_step": wire[-1],
    }
    if args.out:
        with open(f"{args.out}.r{kv.rank}.json", "w") as f:
            json.dump(report, f)
        onp.savez(f"{args.out}.r{kv.rank}.npz", **{
            name: p.data().asnumpy()
            for name, p in net.collect_params().items()})
    logging.info("worker %d done", kv.rank)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=64,
                    help="per-worker batch")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--synthetic", action="store_true",
                    help="random data (no dataset download)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--kvstore", default="dist_sync",
                    choices=["dist_sync", "dist_async"])
    ap.add_argument("--out", default=None,
                    help="write PREFIX.r<rank>.json and .npz")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train(args)


if __name__ == "__main__":
    main()
