#!/usr/bin/env python
"""Manual model parallelism with ``AttrScope(ctx_group)``/``group2ctx``
(counterpart of ``example/model-parallel/matrix_factorization.py``): the
user and item embeddings live in two groups, each on its own device, and
only the small interaction term crosses between them.

    python mxnet_tpu_torch/example/model_parallel/matrix_factorization.py \
        --steps 80

The same flags as the reference's script.  With a CUDA card the user
group runs on ``gpu(0)`` and the item group on ``cpu()`` (a real split
across devices); without one both groups are contexts of the host
(``cpu(0)``, ``cpu(1)``: one device, so the placement is recorded and
nothing moves).  :func:`train` returns the per-step losses and the
executor (its ``placement`` and ``transfers``).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import nd, sym  # noqa: E402


def build(num_users, num_items, k):
    user = sym.Variable("user")
    item = sym.Variable("item")
    score = sym.Variable("score")
    with mx.AttrScope(ctx_group="dev1"):
        u = sym.Embedding(user, input_dim=num_users, output_dim=k,
                          name="user_embed")
    with mx.AttrScope(ctx_group="dev2"):
        v = sym.Embedding(item, input_dim=num_items, output_dim=k,
                          name="item_embed")
        pred = sym.sum(u * v, axis=1)
    loss = sym.sum(sym.square(pred - score)) / sym.Variable("bs_const")
    return loss


def default_groups():
    """``(bind context, group2ctx)``: the card and the host when a card
    exists, else two contexts of the host."""
    import torch

    if torch.cuda.is_available():
        return mx.gpu(0), {"dev1": mx.gpu(0), "dev2": mx.cpu(0)}
    return mx.cpu(0), {"dev1": mx.cpu(0), "dev2": mx.cpu(1)}


def train(args, ctx, g2c, seed=0):
    """The reference's loop: ``args.steps`` SGD steps at ``args.lr`` on
    batches drawn from ``RandomState(seed)``; returns ``(losses,
    executor)``."""
    rng = onp.random.RandomState(seed)
    true_u = (rng.randn(args.users, args.factors) * 0.5).astype("float32")
    true_v = (rng.randn(args.items, args.factors) * 0.5).astype("float32")
    loss_sym = build(args.users, args.items, args.factors)
    bs = args.batch_size
    arg_arrays = {
        "user": nd.zeros((bs,), ctx=mx.cpu()),
        "item": nd.zeros((bs,), ctx=mx.cpu()),
        "score": nd.zeros((bs,), ctx=mx.cpu()),
        "bs_const": nd.array([float(bs)], ctx=mx.cpu()),
        "user_embed_weight": nd.array(
            rng.randn(args.users, args.factors).astype("float32") * .3,
            ctx=mx.cpu()),
        "item_embed_weight": nd.array(
            rng.randn(args.items, args.factors).astype("float32") * .3,
            ctx=mx.cpu()),
    }
    grad_req = {n: "null" for n in ("user", "item", "score", "bs_const")}
    grad_req.update({"user_embed_weight": "write",
                     "item_embed_weight": "write"})
    grads = {"user_embed_weight": nd.zeros((args.users, args.factors),
                                           ctx=mx.cpu()),
             "item_embed_weight": nd.zeros((args.items, args.factors),
                                           ctx=mx.cpu())}
    ex = loss_sym.bind(ctx=ctx, args=arg_arrays, args_grad=grads,
                       grad_req=grad_req, group2ctx=g2c)
    losses = []
    for step in range(args.steps):
        ui = rng.randint(0, args.users, bs)
        vi = rng.randint(0, args.items, bs)
        y = (true_u[ui] * true_v[vi]).sum(axis=1)
        out = ex.forward(is_train=True,
                         user=nd.array(ui.astype("float32"), ctx=mx.cpu()),
                         item=nd.array(vi.astype("float32"), ctx=mx.cpu()),
                         score=nd.array(y.astype("float32"),
                                        ctx=mx.cpu()))[0]
        ex.backward()
        for n in ("user_embed_weight", "item_embed_weight"):
            a = ex.arg_dict[n]
            a._adopt(a._data - args.lr * ex.grad_dict[n]._data)
        losses.append(float(out.asnumpy().reshape(())[()]))
        if step % 100 == 0:
            logging.info("step %d mse %.4f", step, losses[-1])
    return losses, ex


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--users", type=int, default=50)
    ap.add_argument("--items", type=int, default=40)
    ap.add_argument("--factors", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1.0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx, g2c = default_groups()
    losses, ex = train(args, ctx, g2c)
    # the reference's windows of 50 steps, shorter for a short run
    w = max(1, min(50, len(losses) // 2))
    head = sum(losses[:w]) / w
    tail = sum(losses[-w:]) / w
    logging.info("mse %.4f -> %.4f (%d boundary transfers a step)", head,
                 tail, ex.transfers)
    assert tail < head * (0.3 if w == 50 else 1.0), \
        "model-parallel MF did not converge"
    print("model_parallel_mf OK")


if __name__ == "__main__":
    main()
