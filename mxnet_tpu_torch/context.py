"""Devices (counterpart of ``mxnet_tpu/context.py``).

``cpu()`` and ``gpu(i)`` name ``torch.device`` objects.  The default
device is ``cuda:0``: an entry point given no device runs on the card,
and a CUDA device asked for on a host without one raises — the port
never moves work to the CPU on its own.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for API parity)."""
    del device_id
    return torch.device("cpu")


def gpu(device_id=0):
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", int(device_id))


def default_device():
    return gpu(0)


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; a string or ``torch.device`` is taken as
    given.  A CUDA device on a host whose torch sees no card raises."""
    dev = default_device() if device is None else torch.device(device)
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
