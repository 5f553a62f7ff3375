"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (LARS, NAG, SGD, Adam, AdaGrad, AdamW,  # noqa: F401
                        Optimizer, RMSProp, Signum, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "Adam", "AdamW", "AdaGrad",
           "RMSProp", "LARS", "Updater", "create", "get_updater",
           "register"]
