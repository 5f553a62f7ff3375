"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are assembled in the calling process (``num_workers=0``), in a
pool of worker processes (``num_workers > 0``) or in a pool of threads
(``thread_pool=True``).  Worker processes return numpy batches over
pipes and never touch CUDA: they start by ``forkserver``, whose server
is a fresh process that never initialised CUDA, so a pool made after
the parent has used the card is safe (``fork`` copies the parent's CUDA
state into a child that must not use it).  The dataset and the batchify
function are therefore pickled to the workers.  ``pin_memory=True``
pins the host batches (where a card exists) for an asynchronous copy.

With the device feed (``device_feed``, default ``MXNET_DEVICE_FEED``,
on) each epoch's iterator is wrapped in ``io.DeviceFeedIter``: batches
reach the current context's device ahead of the step, on a side stream.
On a host context they stay host NDArrays.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.pool

import numpy as onp
import torch

from ...context import cpu
from ...ndarray import NDArray, array, stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

#: the worker processes' start method (see the module's docstring)
START_METHOD = "forkserver"


def default_batchify_fn(data):
    """Stack samples into a batch on the host: NDArrays with ``stack``,
    tuples field by field, anything else through numpy (64-bit types
    narrowed to 32 bits, as in the reference)."""
    if isinstance(data[0], NDArray):
        return stack(*(d.as_in_context(cpu()) for d in data))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return array(onp.asarray(data), ctx=cpu())


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy out (the main process makes the
    NDArrays; workers touch no device)."""
    if isinstance(data[0], NDArray):
        return onp.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(i) for i in zip(*data)]
    return onp.asarray(data)


def _numpy_to_nd(data):
    """Worker-produced numpy batches to host NDArrays (64-bit types
    narrowed to 32 bits, as the reference's JAX arrays narrow them)."""
    if isinstance(data, onp.ndarray):
        return array(data, ctx=cpu())
    if isinstance(data, (list, tuple)):
        return [_numpy_to_nd(d) for d in data]
    return data


def _pin(data):
    if isinstance(data, NDArray):
        return NDArray(data._data.pin_memory())
    if isinstance(data, (list, tuple)):
        return [_pin(d) for d in data]
    return data


_worker_dataset = None


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset
    torch.set_num_threads(1)


def _worker_fn(samples, batchify_fn, dataset=None):
    """Batch one index list in a worker."""
    ds = dataset if dataset is not None else _worker_dataset
    return batchify_fn([ds[i] for i in samples])


class _MultiWorkerIter:
    def __init__(self, worker_pool, batchify_fn, batch_sampler,
                 pin_memory=False, worker_fn=_worker_fn, prefetch=0,
                 dataset=None):
        self._worker_pool = worker_pool
        self._batchify_fn = batchify_fn
        self._batch_sampler = batch_sampler
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        self._iter = iter(self._batch_sampler)
        self._worker_fn = worker_fn
        self._pin_memory = pin_memory
        self._dataset = dataset
        for _ in range(prefetch):
            self._push_next()

    def __len__(self):
        return len(self._batch_sampler)

    def _push_next(self):
        r = next(self._iter, None)
        if r is None:
            return
        async_ret = self._worker_pool.apply_async(
            self._worker_fn, (r, self._batchify_fn, self._dataset))
        self._data_buffer[self._sent_idx] = async_ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            assert not self._data_buffer, (
                "Data buffer should be empty at this moment")
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx)
        batch = _numpy_to_nd(ret.get())
        if self._pin_memory:
            batch = _pin(batch)
        self._rcvd_idx += 1
        return batch

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self


class DataLoader:
    """Loads batches from a Dataset (reference gluon ``DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=False, device_feed=None,
                 feed_depth=None):
        self._dataset = dataset
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()
        self._thread_pool = thread_pool
        self._device_feed = device_feed
        self._feed_depth = feed_depth
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
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._worker_pool = None
        self._prefetch = max(
            0, int(prefetch) if prefetch is not None
            else 2 * self._num_workers)
        if self._num_workers > 0:
            if self._thread_pool:
                self._worker_pool = multiprocessing.pool.ThreadPool(
                    self._num_workers)
            else:
                self._worker_pool = multiprocessing.get_context(
                    START_METHOD).Pool(
                    self._num_workers,
                    initializer=_worker_initializer,
                    initargs=[self._dataset])
        if batchify_fn is None:
            if num_workers > 0 and not thread_pool:
                self._batchify_fn = default_mp_batchify_fn
            else:
                self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn

    def __iter__(self):
        if self._num_workers == 0:

            def same_process_iter():
                for batch in self._batch_sampler:
                    ret = self._batchify_fn(
                        [self._dataset[idx] for idx in batch])
                    yield _pin(ret) if self._pin_memory else ret

            it = same_process_iter()
        else:
            it = _MultiWorkerIter(
                self._worker_pool, self._batchify_fn,
                self._batch_sampler,
                pin_memory=self._pin_memory, worker_fn=_worker_fn,
                prefetch=self._prefetch,
                # process workers hold the dataset from their
                # initializer; threads share this one
                dataset=self._dataset if self._thread_pool else None)
        from ...io.device_feed import DeviceFeedIter, device_feed_enabled

        feed = self._device_feed
        if feed is None:
            feed = device_feed_enabled()
        if feed:
            # a fresh wrapper per epoch (the inner iterator is one-shot)
            return DeviceFeedIter(it, depth=self._feed_depth)
        return it

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Stop the worker pool (also at garbage collection)."""
        if self._worker_pool is not None:
            self._worker_pool.terminate()
            self._worker_pool.join()
            self._worker_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
