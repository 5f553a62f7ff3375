"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import SGD, Optimizer, register  # noqa: F401

__all__ = ["Optimizer", "SGD", "register"]
