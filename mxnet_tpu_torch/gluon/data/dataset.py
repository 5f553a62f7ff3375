"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``):
``Dataset`` with ``transform``/``transform_first``/``filter``/
``shard``/``take``/``sample``, ``SimpleDataset``, ``ArrayDataset`` and
``RecordFileDataset``.  The downloaded datasets (``gluon/data/vision``)
are not ported yet (ROADMAP §A 6)."""
from __future__ import annotations

import os

from ... import recordio
from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return SimpleDataset([self[i] for i in range(count)])

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([i for i in trans])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, dataset, sampler):
        self._dataset = dataset
        self._sampler = sampler
        self._indices = list(iter(sampler))

    def __len__(self):
        return len(self._sampler)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (reference ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = None
        self._data = []
        for i, data in enumerate(args):
            data = self._getdata(data)
            if self._length is None:
                self._length = len(data)
            else:
                assert len(data) == self._length, (
                    f"All arrays must have the same length; array[0] has "
                    f"length {self._length} while array[{i}] has "
                    f"{len(data)}.")
            self._data.append(data)

    @staticmethod
    def _getdata(data):
        if isinstance(data, NDArray) and data.ndim == 1:
            return data.asnumpy()
        return data

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file and its .idx (reference
    RecordFileDataset): item ``i`` is the raw bytes of the ``i``-th
    indexed record."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(
            self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
