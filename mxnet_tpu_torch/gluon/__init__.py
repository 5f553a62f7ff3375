"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, the layers ResNet
v1 uses, the softmax cross-entropy loss and the model zoo's ResNet v1."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import Parameter, ParameterDict  # noqa: F401

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "loss",
           "model_zoo", "nn"]
