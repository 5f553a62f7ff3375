#!/usr/bin/env python
"""LSTM word-level language model with truncated BPTT (counterpart of
``example/rnn/word_lm.py``, upstream MXNet's
``example/gluon/word_language_model``).

    python mxnet_tpu_torch/example/word_lm.py --epochs 2 [--ctx cpu]

The model is ``Embedding -> Dropout -> gluon.rnn.LSTM -> Dropout ->
Dense(flatten=False)``, trained by the imperative Gluon loop
(``autograd.record()``, ``backward``, ``gluon.Trainer.step`` with SGD
and ``clip_gradient``), hybridized.  The reference script's flags, plus
``--ctx`` (``gpu``, the default: the first CUDA card; ``cpu``: the
host) and ``--embed``, ``--hidden``, ``--layers`` (the model's
widths).  Without ``--data`` it trains on the
reference's synthetic Markov corpus.  :func:`train` returns the losses
and the step time.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402


class RNNModel(gluon.HybridBlock):
    """Embedding -> LSTM stack -> Dense decoder."""

    def __init__(self, vocab_size, embed_dim=200, hidden=200, layers=2,
                 dropout=0.2, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = gluon.nn.Dropout(dropout)
            self.embed = gluon.nn.Embedding(vocab_size, embed_dim)
            self.rnn = gluon.rnn.LSTM(hidden, num_layers=layers,
                                      dropout=dropout)
            self.decoder = gluon.nn.Dense(vocab_size, flatten=False)
        self._hidden = hidden
        self._layers = layers

    def begin_state(self, batch_size, ctx=None):
        return self.rnn.begin_state(batch_size=batch_size, ctx=ctx)

    def forward(self, x, *states):
        # x: (seq, batch) token ids
        emb = self.drop(self.embed(x))
        out, out_states = self.rnn(emb, list(states))
        decoded = self.decoder(self.drop(out))
        return (decoded, *out_states)


def synthetic_corpus(vocab, n=20000, seed=0):
    """The reference's Markov-ish corpus: each token follows a fixed
    successor with probability 0.8, else a uniform one."""
    rng = onp.random.RandomState(seed)
    trans = rng.randint(0, vocab, size=(vocab,))
    tokens = [0]
    for _ in range(n):
        nxt = trans[tokens[-1]] if rng.rand() < 0.8 else rng.randint(vocab)
        tokens.append(int(nxt))
    return tokens


def batchify(tokens, batch_size):
    n = len(tokens) // batch_size
    data = onp.asarray(tokens[: n * batch_size], "float32")
    return data.reshape(batch_size, n).T  # (seq_total, batch)


def detach(states):
    """Cut the graph behind the states (truncated BPTT): a torch tensor
    carries its history, so the states must be detached, not rewrapped."""
    return [s.detach() for s in states]


def build(vocab, embed=200, hidden=200, layers=2, dropout=0.2, lr=1.0,
          clip=0.25, ctx=None, params_file=None):
    """``(model, trainer, loss_fn)``: the model Xavier-initialized on
    ``ctx`` (from numpy's global RNG) or loaded from ``params_file`` (a
    reference ``save_parameters`` file), hybridized; SGD with
    ``clip_gradient``."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    model = RNNModel(vocab, embed, hidden, layers, dropout)
    model.initialize(init=mx.init.Xavier(), ctx=ctx)
    if params_file is not None:
        model.load_parameters(params_file)
    model.hybridize()
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": lr, "clip_gradient": clip})
    return model, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def step(model, trainer, loss_fn, x, y, states, host_ms=None):
    """One truncated-BPTT step: forward and loss under ``record()``,
    ``backward``, ``trainer.step`` (its host time appended to
    ``host_ms``).  Returns the per-token loss and the detached states."""
    states = detach(states)
    with autograd.record():
        out = model(x, *states)
        logits, states = out[0], list(out[1:])
        loss = loss_fn(logits.reshape((-1, logits.shape[-1])),
                       y.reshape((-1,)))
    loss.backward()
    t0 = time.perf_counter()
    trainer.step(x.shape[0] * x.shape[1])
    if host_ms is not None:
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return loss, states


def train(vocab=500, embed=200, hidden=200, layers=2, dropout=0.2,
          batch_size=16, bptt=20, epochs=2, lr=1.0, clip=0.25, ctx=None,
          tokens=None, params_file=None, max_steps=None, log=logging.info):
    """The reference's loop over ``tokens`` (default: the synthetic
    corpus at ``vocab``), ``max_steps`` steps at most.  Returns
    ``{"losses": mean loss of each step, "epochs": [{"perplexity"}],
    "ms_per_step", "steps", "model"}``; ``ms_per_step`` is the wall time
    of the steps with the device synchronized once per epoch."""
    ctx = ctx if ctx is not None else mx.gpu(0)
    if tokens is None:
        tokens = synthetic_corpus(vocab)
    else:
        vocab = max(tokens) + 1
    data = batchify(tokens, batch_size)
    model, trainer, loss_fn = build(vocab, embed, hidden, layers, dropout,
                                    lr, clip, ctx, params_file)
    res = {"losses": [], "epochs": [], "steps": 0}
    wall = 0.0
    for epoch in range(epochs):
        states = model.begin_state(batch_size, ctx=ctx)
        sums, n_tok = [], 0
        t0 = time.perf_counter()
        for i in range(0, data.shape[0] - 1 - bptt, bptt):
            if max_steps is not None and res["steps"] >= max_steps:
                break
            x = mx.nd.array(data[i:i + bptt], ctx=ctx)
            y = mx.nd.array(data[i + 1:i + 1 + bptt], ctx=ctx)
            loss, states = step(model, trainer, loss_fn, x, y, states)
            sums.append(loss.sum())
            n_tok += batch_size * bptt
            res["steps"] += 1
        mx.nd.waitall()
        wall += time.perf_counter() - t0
        if n_tok == 0:
            raise SystemExit(
                "corpus too small for batch_size*(bptt+1) tokens")
        step_sums = [float(s.asnumpy()) for s in sums]
        res["losses"] += [s / (batch_size * bptt) for s in step_sums]
        ppl = math.exp(sum(step_sums) / n_tok)
        res["epochs"].append({"perplexity": ppl})
        log(f"epoch {epoch}: perplexity {ppl:.2f}")
    res["ms_per_step"] = wall / max(res["steps"], 1) * 1e3
    res["model"] = model
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="token-id text file")
    ap.add_argument("--vocab", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--bptt", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=0.25)
    ap.add_argument("--embed", type=int, default=200)
    ap.add_argument("--hidden", type=int, default=200)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    tokens = None
    if args.data:
        with open(args.data) as f:
            tokens = [int(t) for t in f.read().split()]
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    res = train(args.vocab, args.embed, args.hidden, args.layers,
                batch_size=args.batch_size, bptt=args.bptt,
                epochs=args.epochs, lr=args.lr, clip=args.clip, ctx=ctx,
                tokens=tokens)
    logging.info("%.3f ms/step over %d steps", res["ms_per_step"],
                 res["steps"])
    if args.epochs > 0:
        print(f"final_perplexity={res['epochs'][-1]['perplexity']:.2f}")
    return res


if __name__ == "__main__":
    main()
