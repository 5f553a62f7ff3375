"""Data iterators (counterpart of ``mxnet_tpu/io/``; reference:
python/mxnet/io/).  ``ImageDetRecordIter`` waits for the next slice of
the data plane (ROADMAP §A 6)."""
from .io import *  # noqa: F401,F403
from .device_feed import (  # noqa: F401
    DeviceFeedIter, as_device_batch, batch_nbytes, device_feed_enabled)
from .image_record_iter import ImageRecordIter  # noqa: F401
from .iterators import CSVIter, LibSVMIter, MNISTIter  # noqa: F401
