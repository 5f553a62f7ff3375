"""Devices (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` names a device the way the reference's does
(``cpu(0)``, ``gpu(i)``) and resolves to a ``torch.device``.  It is
the port's own object, not a ``torch.device``: ``with mx.cpu():`` sets
the port's thread-local default context and never torch's default
device (``with torch.device(...)`` would change where every torch
factory call in the thread allocates).

The default context is ``gpu(0)``, the first CUDA card (the
reference's is ``cpu(0)``): an entry point given no device runs on the
card, and a CUDA device asked for on a host without one raises — the
port never moves work to the CPU on its own.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "from_torch_device", "default_device",
           "resolve_device"]


class Context:
    """A device context.  devtype ids mirror the reference's Context enum
    (include/mxnet/base.h kCPU=1 kGPU=2 kCPUPinned=3 kCPUShared=5)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_id = device_type.device_id
            device_type = device_type.device_type
        if device_type not in self.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def torch_device(self) -> torch.device:
        """The ``torch.device`` (a CUDA one is checked to exist)."""
        if self.device_type == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __eq__(self, other):
        if isinstance(other, (torch.device, str)):
            other = from_torch_device(torch.device(other))
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The host CPU."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return Context("gpu", device_id)


def current_context() -> Context:
    """The thread's default context: ``gpu(0)`` unless a ``with ctx:``
    scope set another."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)


def num_gpus():
    """Number of CUDA cards torch sees (reference: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def from_torch_device(dev: torch.device) -> Context:
    """The :class:`Context` of a tensor's ``torch.device``."""
    if dev.type == "cuda":
        return Context("gpu", 0 if dev.index is None else dev.index)
    if dev.type == "cpu":
        return Context("cpu", 0)
    raise MXNetError(f"unsupported device {dev}")


def default_device():
    return gpu(0)


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; a :class:`Context`, a string or a
    ``torch.device`` is taken as given.  A CUDA device on a host whose
    torch sees no card raises."""
    if device is None:
        device = default_device()
    if isinstance(device, Context):
        dev = torch.device("cuda", device.device_id) \
            if device.device_type == "gpu" else torch.device("cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but torch sees no CUDA card; "
                "pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
