"""Data iterators (counterpart of ``mxnet_tpu/io/``; reference:
python/mxnet/io/)."""
from .io import *  # noqa: F401,F403
from .device_feed import (  # noqa: F401
    DeviceFeedIter, as_device_batch, batch_nbytes, device_feed_enabled)
from .image_record_iter import (  # noqa: F401
    ImageDetRecordIter, ImageRecordIter)
from .iterators import CSVIter, LibSVMIter, MNISTIter  # noqa: F401
