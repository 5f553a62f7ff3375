"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import LARS, SGD, Adam, Optimizer, register  # noqa: F401

__all__ = ["Optimizer", "SGD", "Adam", "LARS", "register"]
