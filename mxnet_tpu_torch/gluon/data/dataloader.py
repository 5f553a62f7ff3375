"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are assembled in the calling process (``num_workers=0``) and
come out as host NDArrays, stacked the reference's way; the training
loop moves them to its device (``as_in_context``).  Worker processes
(``num_workers > 0``) and the asynchronous device feed
(``device_feed=True``) are not ported yet and raise (ROADMAP §A item
6): the reference feeds the device by default, the port never does
(ROADMAP §C).
"""
from __future__ import annotations

import numpy as onp

from ...base import MXNetError
from ...context import cpu
from ...ndarray import NDArray, array, stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the host: NDArrays with ``stack``,
    tuples field by field, anything else through numpy (64-bit types
    narrowed to 32 bits, as in the reference)."""
    if isinstance(data[0], NDArray):
        return stack(*(d.as_in_context(cpu()) for d in data))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return array(onp.asarray(data), ctx=cpu())


class DataLoader:
    """Loads batches from a Dataset (reference gluon ``DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=False, device_feed=None,
                 feed_depth=None):
        if num_workers > 0:
            raise MXNetError("DataLoader worker processes (num_workers > "
                             "0) are not ported yet (ROADMAP §A item 6)")
        if device_feed:
            raise MXNetError("the DataLoader's device feed "
                             "(device_feed=True) is not ported yet "
                             "(ROADMAP §A item 6)")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for batch in self._batch_sampler:
            yield self._batchify_fn([self._dataset[idx] for idx in batch])

    def __len__(self):
        return len(self._batch_sampler)
