"""Module API (counterpart of ``mxnet_tpu/module/``; reference:
python/mxnet/module/)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import (PythonLossModule, PythonModule,  # noqa: F401
                                SequentialModule)
