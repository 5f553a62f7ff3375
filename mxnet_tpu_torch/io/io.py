"""DataIter / NDArrayIter / ResizeIter / PrefetchingIter (counterpart of
``mxnet_tpu/io/io.py``).

Reference parity: python/mxnet/io/io.py (``DataIter`` base, ``NDArrayIter``
:491 in-memory iterator with shuffle + last_batch_handling, ``ResizeIter``
:282, ``PrefetchingIter`` :347) and ``DataDesc``/``DataBatch``.

``NDArrayIter``'s batches are host NDArrays (``cpu(0)``): the consumer
(``Module.forward``, an executor) or a ``DeviceFeedIter`` around the
iterator moves them to its device.  ``PrefetchingIter`` puts each batch
on the device in its prefetch threads when the device feed is on
(``device_feed``, default ``MXNET_DEVICE_FEED``).  ``NDArrayIter`` shuffles with numpy's global RNG,
as the reference does, so one ``np.random.seed`` gives one order in both
packages.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as onp

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape+dtype+layout descriptor (reference io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be a list"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be a list"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return (f"{self.__class__.__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (reference io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(),
                pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, numpy) (reference
    io_utils.init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (onp.ndarray, nd.NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise MXNetError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    out = []
    for k, v in data.items():
        if isinstance(v, nd.NDArray):
            v = v.asnumpy()
        out.append((k, onp.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """In-memory iterator (reference io.py:491): shuffle, pad/discard/
    roll_over last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = onp.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.cursor = -self.batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.data
        ]

    @property
    def provide_label(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.label
        ]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if (self.last_batch_handle == "roll_over"
                and self.num_data - self.batch_size < self.cursor
                < self.num_data):
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data and data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "roll_over":
                # cache the incomplete tail; it heads next epoch's first
                # batch (reference io.py roll_over semantics)
                self._cache_data = data
                self._cache_label = label
                raise StopIteration
        batch = DataBatch(
            data=data, label=label, pad=self.getpad(), index=None)
        if (self.last_batch_handle == "roll_over"
                and self._cache_data is not None):
            self._cache_data = None
            self._cache_label = None
        return batch

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        return [nd.array(x[1][start:end], ctx=cpu()) for x in data_source]

    def _concat(self, first_data, second_data):
        return [
            nd.concat(first_data[i], second_data[i], dim=0)
            for i in range(len(first_data))
        ]

    def _batchify(self, data_source, cache):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if (self.last_batch_handle == "roll_over"
                and -self.batch_size < self.cursor < 0):
            # first batch of an epoch following a cached partial tail
            assert cache is not None, (
                "roll_over: first epoch should not have a negative cursor")
            second_part = self._getdata(
                data_source, 0, self.cursor + self.batch_size)
            if not cache:
                return second_part
            return self._concat(cache, second_part)
        if self.cursor + self.batch_size <= self.num_data:
            return self._getdata(
                data_source, self.cursor, self.cursor + self.batch_size)
        if self.last_batch_handle == "pad":
            # wrap around to fill the batch
            first_part = self._getdata(
                data_source, self.cursor, self.num_data)
            second_part = self._getdata(
                data_source, 0,
                self.batch_size - self.num_data + self.cursor)
            if not first_part:
                return first_part
            return self._concat(first_part, second_part)
        # discard / roll_over: return the partial tail as-is
        return self._getdata(data_source, self.cursor, self.num_data)

    def getdata(self):
        return self._batchify(self.data, self._cache_data)

    def getlabel(self):
        return self._batchify(self.label, self._cache_label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        if (self.last_batch_handle == "roll_over" and -self.batch_size
                < self.cursor < 0):
            return -self.cursor
        return 0

    def _shuffle_data(self):
        onp.random.shuffle(self.idx)
        self.data = [(k, v[self.idx]) for k, v in self.data]
        self.label = [(k, v[self.idx]) for k, v in self.label]


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch (reference
    io.py:282)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators (reference
    io.py:347; C++ analog src/io/iter_prefetcher.h).

    ``device_feed`` (None follows ``MXNET_DEVICE_FEED``, default on)
    copies each batch to the current context's device (read at
    construction) inside the prefetch thread, on the feed's side
    stream; ``next()`` hands it over by a stream wait."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device_feed=None):
        super().__init__()
        from .device_feed import _target, device_feed_enabled

        if device_feed is None:
            device_feed = device_feed_enabled()
        self._feed_device = _target() if device_feed else None
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    batch = self.iters[i].next()
                    dev = self._feed_device
                    if dev is not None:
                        from .device_feed import (as_device_batch,
                                                  side_stream_put)

                        batch = side_stream_put(
                            lambda b=batch: as_device_batch(b, dev), dev)
                    self.next_batch[i] = batch
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i])
            for i in range(self.n_iter)
        ]
        for thread in self.prefetch_threads:
            thread.daemon = True
            thread.start()

    def __del__(self):
        if not hasattr(self, "prefetch_threads"):
            return  # the constructor raised
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([
            [
                DataDesc(r[x.name], x.shape, x.dtype)
                if isinstance(x, DataDesc) else DataDesc(*x)
                for x in i.provide_data
            ]
            for r, i in zip(self.rename_data, self.iters)
        ], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([
            [
                DataDesc(r[x.name], x.shape, x.dtype)
                if isinstance(x, DataDesc) else DataDesc(*x)
                for x in i.provide_label
            ]
            for r, i in zip(self.rename_label, self.iters)
        ], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        from .device_feed import Ready

        for e in self.data_ready:
            e.wait()
        self.next_batch = [b.take() if isinstance(b, Ready) else b
                           for b in self.next_batch]
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, (
                    "Number of entry mismatches between iterators")
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, (
                "Number of entry mismatches between iterators")
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad
