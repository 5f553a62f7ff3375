"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``): the subset
ResNet v1 uses."""
from . import layout  # noqa: F401
from .activations import Activation  # noqa: F401
from .basic_layers import BatchNorm, Dense, Flatten, HybridSequential  # noqa: F401
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D  # noqa: F401
from .layout import default_layout  # noqa: F401

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "MaxPool2D",
           "default_layout", "layout"]
