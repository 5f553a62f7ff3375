"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, Updater, create, register  # noqa: F401
from . import contrib  # noqa: F401
