"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision  # noqa: F401
