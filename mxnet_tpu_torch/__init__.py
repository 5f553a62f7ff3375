"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Each module mirrors the module of the same path in ``mxnet_tpu`` (the
JAX package, which stays the reference) and computes the same thing
with ``torch`` tensors on an explicit device.  Where the reference
runs a Pallas kernel for the TPU, the port runs a kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` on first use, beside a
plain PyTorch version of the same math that the CPU takes.

Entry points run on ``cuda:0`` (``mx.gpu(0)``, the default context)
unless the caller passes ``device="cpu"``, ``ctx=mx.cpu()`` or enters
``with mx.cpu():``; asking for CUDA where there is none raises.

The slices ported so far are the generative decode server
(:mod:`mxnet_tpu_torch.serving`), ResNet training through the fused step
(:mod:`mxnet_tpu_torch.parallel`), the imperative front end (``mx.nd``,
:mod:`~mxnet_tpu_torch.autograd`, ``.params`` files,
:mod:`~mxnet_tpu_torch.library`) and the imperative Gluon training loop
(:mod:`~mxnet_tpu_torch.gluon` blocks on NDArrays, ``gluon.Trainer``,
:mod:`~mxnet_tpu_torch.optimizer`, :mod:`~mxnet_tpu_torch.lr_scheduler`,
:mod:`~mxnet_tpu_torch.metric`, ``gluon.data``) and the symbolic half
(``mx.sym`` and its graph executor, ``mx.mod`` modules, ``mx.io``
iterators, ``mx.model`` checkpoints, ``mx.callback``, ``mx.monitor``)
and the random foundation with the classification zoo
(:mod:`~mxnet_tpu_torch.random`, ``mx.nd.random``, ``Dropout``, keyed
train steps, ``gluon.model_zoo.vision``) and the serving path for
trained models (:mod:`~mxnet_tpu_torch.deploy` artifacts,
``serving.ModelServer``, the HTTP front, ``serving.ModelHost``) and
quantized and mixed-precision inference (:mod:`~mxnet_tpu_torch.
quantization`, ``contrib.quantization``, ``contrib.amp``) and the
telemetry that observes them (:mod:`~mxnet_tpu_torch.telemetry`'s run
log, spans, watchdog and numerics monitor, :mod:`~mxnet_tpu_torch.
profiler` on ``torch.profiler``) and the data plane that feeds them
(:mod:`~mxnet_tpu_torch.recordio`, ``mx.io``'s iterators and device
feed, ``ImageRecordIter`` decoding on the card, :mod:`~mxnet_tpu_torch.
image`, the DataLoader's workers, the single-process ``mx.kv``), with
what they run.
"""
__version__ = "0.1.0"

from . import base  # noqa: F401
from . import config  # noqa: F401

if config.get_env("MXNET_PROFILER_AUTOSTART"):
    from . import profiler as _profiler_autostart

    _profiler_autostart.set_state("run")
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, current_context, default_device,  # noqa: F401
                      gpu, num_gpus, resolve_device)
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import library  # noqa: F401
from . import random  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import metric  # noqa: F401
from . import optimizer  # noqa: F401
from . import gluon  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import AttrScope  # noqa: F401
from . import io  # noqa: F401
from . import recordio  # noqa: F401
from . import image  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import model  # noqa: F401
from . import callback  # noqa: F401
from . import monitor  # noqa: F401
from . import monitor as mon  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import deploy  # noqa: F401
from . import contrib  # noqa: F401
from . import quantization  # noqa: F401
from . import profiler  # noqa: F401
from . import telemetry  # noqa: F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "default_device", "resolve_device", "nd",
           "ndarray", "autograd", "library", "random", "gluon", "init", "initializer",
           "lr_scheduler", "metric", "optimizer", "sym", "symbol",
           "AttrScope", "io", "model", "callback", "monitor", "mon",
           "mod", "module", "deploy", "contrib", "quantization",
           "profiler", "telemetry", "recordio", "image", "kv",
           "kvstore"]
