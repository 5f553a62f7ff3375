"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``): the subset
the classification zoo uses."""
from . import layout  # noqa: F401
from .activations import Activation  # noqa: F401
from .basic_layers import (BatchNorm, Dense, Dropout, Flatten,  # noqa: F401
                           HybridSequential)
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D  # noqa: F401
from .layout import default_layout  # noqa: F401

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "MaxPool2D",
           "default_layout", "layout"]
