"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1."""
from .resnet import *  # noqa: F401,F403
from .resnet import __all__  # noqa: F401
