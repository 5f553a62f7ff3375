"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Each module mirrors the module of the same path in ``mxnet_tpu`` (the
JAX package, which stays the reference) and computes the same thing
with ``torch`` tensors on an explicit ``torch.device``.  Where the
reference runs a Pallas kernel for the TPU, the port runs a kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` on first
use, beside a plain PyTorch version of the same math that the CPU
takes.

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

The slice ported so far is the generative decode server
(:mod:`mxnet_tpu_torch.serving`) and what it runs.
"""
__version__ = "0.1.0"

from . import base  # noqa: F401
from . import config  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import cpu, default_device, gpu, resolve_device  # noqa: F401

__all__ = ["MXNetError", "cpu", "gpu", "default_device",
           "resolve_device"]
