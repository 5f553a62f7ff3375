#!/usr/bin/env python
"""Bucketed LSTM word LM with ``BucketingModule`` (counterpart of
``example/rnn/bucketing/lstm_bucketing.py``): variable-length sequences
batched into per-length buckets that share one parameter set, each
bucket's graph holding one ``sym.RNN`` node.

    python mxnet_tpu_torch/example/lstm_bucketing.py --steps 60 [--ctx cpu]

The reference script's flags, plus ``--ctx`` (``gpu``, the default:
the first CUDA card; ``cpu``: the host).  Synthetic token streams, as
the reference's.  :func:`train` returns the perplexity of each step and
the module; the script asserts that perplexity ends below 0.8 of where
it started.
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
from mxnet_tpu_torch import sym  # noqa: E402
from mxnet_tpu_torch.io import DataBatch, DataDesc  # noqa: E402

BUCKETS = (8, 16)


def sym_gen_factory(vocab, embed, hidden):
    """Per-bucket unrolled LSTM graph; parameters are shared across
    buckets by name (the BucketingModule contract)."""
    def sym_gen(seq_len):
        data = sym.Variable("data")          # (batch, seq_len) ids
        label = sym.Variable("softmax_label")
        emb = sym.Embedding(data, input_dim=vocab, output_dim=embed,
                            name="embed")
        cell_out = sym.RNN(
            sym.transpose(emb, axes=(1, 0, 2)),   # TNC for the op
            state_size=hidden, num_layers=1, mode="lstm",
            name="lstm")
        # back to batch-major so the flattened positions line up with
        # the batch-major flattened labels
        bm = sym.transpose(cell_out, axes=(1, 0, 2), name="bm")
        flat = sym.Reshape(bm, shape=(-1, hidden), name="flat")
        fc = sym.FullyConnected(flat, num_hidden=vocab, name="decoder")
        out = sym.SoftmaxOutput(fc, sym.Reshape(label, shape=(-1,)),
                                name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def synthetic_batches(rng, steps, batch_size, vocab):
    """Markov-ish token streams cut to a random bucket per batch."""
    for _ in range(steps):
        L = BUCKETS[rng.randint(len(BUCKETS))]
        base = rng.randint(0, vocab, (batch_size, 1))
        seq = (base + onp.arange(L)) % vocab      # learnable structure
        data = seq.astype("float32")
        label = ((seq + 1) % vocab).astype("float32")
        yield DataBatch(
            data=[mx.nd.array(data, ctx=mx.cpu())],
            label=[mx.nd.array(label, ctx=mx.cpu())],
            bucket_key=L,
            provide_data=[DataDesc("data", (batch_size, L))],
            provide_label=[DataDesc("softmax_label", (batch_size, L))])


def train(batch_size=16, steps=60, vocab=32, embed=16, hidden=32, lr=0.5,
          ctx=None, arg_params=None, log=logging.info):
    """The reference's loop: bind on the first batch's bucket, Uniform(0.1)
    weights (or ``arg_params``), SGD momentum 0.9, ``steps`` batches of
    forward, perplexity, backward, update.  Returns ``{"perplexity":
    one per step, "buckets": the bucket of each step, "module",
    "ms_per_step"}`` (wall time, the device synchronized at the end)."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    mod = mx.mod.BucketingModule(
        sym_gen_factory(vocab, embed, hidden),
        default_bucket_key=max(BUCKETS), context=ctx)
    rng = onp.random.RandomState(0)
    warm = next(synthetic_batches(rng, 1, batch_size, vocab))
    mod.bind(data_shapes=warm.provide_data,
             label_shapes=warm.provide_label)
    mod.init_params(initializer=mx.init.Uniform(0.1), arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", lr),
                                         ("momentum", 0.9)))
    metric = mx.metric.Perplexity(ignore_label=None)
    res = {"perplexity": [], "buckets": [], "module": mod}
    t0 = time.perf_counter()
    for i, batch in enumerate(synthetic_batches(rng, steps, batch_size,
                                                vocab)):
        mod.forward(batch, is_train=True)
        metric.reset()
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
        ppl = metric.get()[1]
        res["perplexity"].append(ppl)
        res["buckets"].append(batch.bucket_key)
        if i % 10 == 0:
            log(f"step {i} bucket {batch.bucket_key} perplexity {ppl:.2f}")
    mx.nd.waitall()
    res["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--embed", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    res = train(args.batch_size, args.steps, args.vocab, args.embed,
                args.hidden, args.lr, ctx)
    first, last = res["perplexity"][0], res["perplexity"][-1]
    logging.info("perplexity %.2f -> %.2f", first, last)
    assert last < first * 0.8, "perplexity did not improve"
    print("lstm_bucketing OK")
    return res


if __name__ == "__main__":
    main()
