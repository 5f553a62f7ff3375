"""Gluon data (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers and the ``DataLoader``, which batches on the host."""
from .dataloader import *  # noqa: F401,F403
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
