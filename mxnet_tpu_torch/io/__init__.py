"""Data iterators (counterpart of ``mxnet_tpu/io/``; reference:
python/mxnet/io/).  ``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``ImageRecordIter`` and ``DeviceFeedIter`` wait for the port's data plane
(ROADMAP §A 6)."""
from .io import *  # noqa: F401,F403
