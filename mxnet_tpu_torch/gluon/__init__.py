"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks and parameters
(deferred shapes included), the layers ResNet and LeNet use, the
softmax cross-entropy loss, the model zoo's ResNets, the ``Trainer``
and ``gluon.data``."""
from . import data, loss, model_zoo, nn, trainer  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer", "data", "loss",
           "model_zoo", "nn", "trainer"]
