"""One side of the distributed Trainer's checks, run under a launcher
with 2 workers:

    python -m mxnet_tpu_torch.tools.launch -n 2 --cpu \\
        python tests/torch_dist_trainer_worker.py torch OUT [RUN ...]
    python tools/launch.py -n 2 --cpu \\
        python tests/torch_dist_trainer_worker.py jax OUT [RUN ...]

The first argument picks the package.  Each RUN (default ``f64``) trains
a fresh ResNet-18 v1 at 32x32 through a fresh ``dist_sync`` store (the
Trainer sums the gradients over the workers) and writes its parameters
before and after (running statistics aside) and its mean loss at each
step to ``OUT.<RUN>.r0.npz``; every other rank writes each trained
parameter's SHA-256 to ``OUT.<RUN>.r<rank>.npz``:

- ``f64``: batch 4 a worker, 3 steps of SGD with momentum, each worker
  updating its replica (``update_on_kvstore=False``);
- ``f64_uokv``: the same with ``update_on_kvstore=True``, the store's
  updater applying the summed gradient;
- ``fp32_example`` and ``f64_example``: one step of
  ``cifar10_dist.py``'s recipe (batch 64 a worker, SGD at lr 0.05, no
  momentum, ``update_on_kvstore=False``) in float32 and in float64, on
  each of 3 batches from the initial weights, batch ``b`` written to
  ``OUT.<RUN>.b<b>.r<rank>.npz``.  TF32 is off on the card, as in every
  card-against-host check.  ``fp32_example_native`` is ``fp32_example``
  with cuDNN off (``torch.backends.cudnn.enabled``), so that the card's
  convolutions are PyTorch's own kernels.

The ``f64*`` runs are float64 throughout: at 32x32 the last stage's
BatchNorm normalises 4 values a channel at batch 4, and an fp32 step
departs from the exact one by percents within 3 steps (both packages'
BatchNorm rounds its statistics to fp32; a ``jax.numpy``/``torch`` whose
``float32`` is float64 is patched into their ``ops/nn.py``, as
``tests/test_torch_zoo.py`` does).  The weights are set from one seeded
draw in both packages and on every device (each ``*_weight`` uniform in
±sqrt(3/fan_in), in sorted name order; the rest as initialised), and so
are the data (``RandomState(1000 + rank)``).
"""
import hashlib
import os
import sys
import types

import numpy as onp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: run: (dtype, batch a worker, steps, optimizer settings,
#: update_on_kvstore, batches: each from the initial weights)
RUNS = {
    "f64": ("float64", 4, 3, {"learning_rate": 0.05, "momentum": 0.9},
            False, 1),
    "f64_uokv": ("float64", 4, 3, {"learning_rate": 0.05, "momentum": 0.9},
                 True, 1),
    "fp32_example": ("float32", 64, 1, {"learning_rate": 0.05}, False, 3),
    "fp32_example_native": ("float32", 64, 1, {"learning_rate": 0.05},
                            False, 3),
    "f64_example": ("float64", 64, 1, {"learning_rate": 0.05}, False, 3),
}
#: runs whose convolutions take PyTorch's own kernels, not cuDNN's
NATIVE_CONV = ("fp32_example_native",)


class _Float64(types.ModuleType):
    """A module whose ``float32`` is ``float64``."""

    def __init__(self, base):
        super().__init__(base.__name__)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, "float64" if name == "float32" else name)


def _package(which):
    """``(mx, the ops/nn module, the name of its array module)``."""
    if which == "jax":
        import jax

        jax.config.update("jax_enable_x64", True)
        import mxnet_tpu as mx
        from mxnet_tpu.ops import nn as nn_ops

        return mx, nn_ops, "jnp"
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as nn_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx, nn_ops, "torch"


def train(mx, run, out):
    """One RUN; writes its files; returns the rank."""
    import time
    from importlib import import_module

    t0 = time.perf_counter()
    dtype, batch, steps, opt_kw, uokv, batches = RUNS[run]
    autograd = import_module(mx.__name__ + ".autograd")
    gluon = import_module(mx.__name__ + ".gluon")
    kv = mx.kv.create("dist_sync")
    assert kv.num_workers == 2, kv.num_workers
    net = gluon.model_zoo.vision.get_resnet(1, 18, classes=10)
    net.initialize(init=mx.init.Xavier())
    with autograd.pause():
        net(mx.nd.zeros((1, 3, 32, 32)))  # resolves deferred shapes
    net.cast(dtype)
    draw = onp.random.RandomState(7)
    params = net.collect_params()
    for name in sorted(params):
        if name.endswith("_weight"):
            shape = params[name].shape
            bound = (3.0 / int(onp.prod(shape[1:]))) ** 0.5
            params[name].set_data(mx.nd.array(
                draw.uniform(-bound, bound, shape), dtype=dtype))
    # names without the net's prefix, which counts the nets made so far
    held = {n.split("_", 1)[1]: p for n, p in params.items()
            if p.grad_req != "null"}
    init = {n: p.data().asnumpy() for n, p in held.items()}
    trainer = gluon.Trainer(params, "sgd", opt_kw, kvstore=kv,
                            update_on_kvstore=uokv)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(1000 + kv.rank)
    for b in range(batches):
        for n, p in held.items():
            p.set_data(mx.nd.array(init[n], dtype=dtype))
        losses = []
        for _ in range(steps):
            x = mx.nd.array(rng.rand(batch, 3, 32, 32), dtype=dtype)
            y = mx.nd.array(rng.randint(0, 10, batch), dtype=dtype)
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch * kv.num_workers)
            losses.append(float(loss.mean().asnumpy()))
        kv.barrier()
        trained = {n: p.data().asnumpy() for n, p in held.items()}
        assert all(v.dtype == onp.dtype(dtype) for v in trained.values())
        trained.update({"init:" + n: v for n, v in init.items()})
        trained["loss:steps"] = onp.array(losses)
        if kv.rank:
            # the other replicas: each parameter's digest, enough to
            # hold them equal to rank 0's bit for bit
            trained = {n: onp.array(hashlib.sha256(v.tobytes())
                                    .hexdigest())
                       for n, v in trained.items() if ":" not in n}
        tag = "" if batches == 1 else f".b{b}"
        onp.savez(f"{out}.{run}{tag}.r{kv.rank}.npz", **trained)
    print(f"[worker {kv.rank}] {run} {time.perf_counter() - t0:.1f} s",
          flush=True)
    return kv.rank


def main():
    which, out = sys.argv[1], sys.argv[2]
    runs = sys.argv[3:] or ["f64"]
    mx, nn_ops, array_mod = _package(which)
    plain = getattr(nn_ops, array_mod)
    for run in runs:
        f64 = RUNS[run][0] == "float64"
        setattr(nn_ops, array_mod, _Float64(plain) if f64 else plain)
        if which == "torch":
            import torch

            torch.backends.cudnn.enabled = run not in NATIVE_CONV
        rank = train(mx, run, out)
    setattr(nn_ops, array_mod, plain)
    print(f"[worker {rank}] {which} trainer OK", flush=True)


if __name__ == "__main__":
    main()
