"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``): the subset
the classification zoo and the recurrent models use."""
from . import layout  # noqa: F401
from .activations import Activation  # noqa: F401
from .basic_layers import (BatchNorm, Dense, Dropout,  # noqa: F401
                           Embedding, Flatten, HybridLambda,
                           HybridSequential, Lambda, Sequential)
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D  # noqa: F401
from .layout import default_layout  # noqa: F401

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Embedding", "Flatten", "GlobalAvgPool2D",
           "HybridLambda", "HybridSequential", "Lambda", "MaxPool2D",
           "Sequential", "default_layout", "layout"]
