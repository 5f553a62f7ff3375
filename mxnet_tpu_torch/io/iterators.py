"""CSVIter, LibSVMIter and MNISTIter (counterpart of
``mxnet_tpu/io/iterators.py``).

Reference parity: src/io/iter_csv.cc:218 (CSVIter), iter_libsvm.cc
(LibSVMIter), iter_mnist.cc:260 (MNISTIter).  The file is parsed once,
with numpy, at construction; a batch is a slice of the parsed array,
handed out as host NDArrays (``cpu(0)``) as ``NDArrayIter``'s are: the
consumer, or a ``DeviceFeedIter`` around the iterator, moves it to the
card.
"""
from __future__ import annotations

import gzip
import struct

import numpy as onp

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from .io import DataBatch, DataDesc, DataIter

__all__ = ["CSVIter", "LibSVMIter", "MNISTIter"]


class _ArrayFeedIter(DataIter):
    """Shared batching engine: dense arrays in, reference round_batch /
    pad semantics out."""

    def __init__(self, data, label, batch_size, shuffle=False,
                 round_batch=True, seed=0, data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._data = data
        self._label = label
        self._shuffle = shuffle
        self._round_batch = round_batch
        self._rng = onp.random.RandomState(seed)
        self._order = onp.arange(len(data))
        self._data_name = data_name
        self._label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data.shape[1:])]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self._label.shape[1:])]

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._rng.shuffle(self._order)

    def iter_next(self):
        return self._cursor < len(self._order)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        n = len(self._order)
        end = self._cursor + self.batch_size
        idx = self._order[self._cursor:end]
        pad = 0
        if end > n:
            if self._round_batch:
                # wrap and report pad; onp.resize cycles when the
                # dataset is smaller than the remaining pad (same
                # semantics as ImageRecordIter)
                pad = end - n
                idx = onp.concatenate([idx, onp.resize(self._order, pad)])
            # round_batch=False: final batch genuinely smaller, pad=0
        self._cursor = end
        return DataBatch(
            data=[nd.array(self._data[idx], ctx=cpu())],
            label=[nd.array(self._label[idx], ctx=cpu())],
            pad=pad, index=idx,
            provide_data=self.provide_data,
            provide_label=self.provide_label)


class CSVIter(_ArrayFeedIter):
    """Reference: src/io/iter_csv.cc:218 — dense CSV rows reshaped to
    ``data_shape``; optional label CSV (default 0s, reference
    behavior)."""

    def __init__(self, data_csv, data_shape, batch_size, label_csv=None,
                 label_shape=(1,), shuffle=False, round_batch=True,
                 seed=0, dtype="float32", **kwargs):
        raw = onp.loadtxt(data_csv, delimiter=",", dtype=dtype,
                          ndmin=2)
        want = 1
        for d in data_shape:
            want *= int(d)
        if raw.shape[1] != want:
            raise MXNetError(
                f"CSVIter: {raw.shape[1]} columns cannot reshape to "
                f"data_shape {tuple(data_shape)}")
        data = raw.reshape((-1,) + tuple(int(d) for d in data_shape))
        if label_csv is not None:
            lab = onp.loadtxt(label_csv, delimiter=",", dtype=dtype,
                              ndmin=2)
            lab = lab.reshape((-1,) + tuple(int(d) for d in label_shape))
            if len(lab) != len(data):
                raise MXNetError("CSVIter: label/data row mismatch")
        else:
            lab = onp.zeros((len(data),) + tuple(
                int(d) for d in label_shape), dtype)
        if tuple(label_shape) == (1,):
            lab = lab.reshape(len(data))
        super().__init__(data, lab, batch_size, shuffle, round_batch,
                         seed)


class LibSVMIter(_ArrayFeedIter):
    """Reference: src/io/iter_libsvm.cc — ``label idx:val ...`` rows.

    Returns DENSE batches of width ``data_shape[0]`` (the reference's
    choice: the row is what the model consumes)."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_shape=(1,), shuffle=False, round_batch=True,
                 seed=0, dtype="float32", **kwargs):
        width = int(data_shape[0]) if isinstance(
            data_shape, (tuple, list)) else int(data_shape)
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                labels.append(float(parts[0]))
                row = onp.zeros(width, dtype)
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    k = int(k)
                    if k >= width:
                        raise MXNetError(
                            f"LibSVMIter: index {k} >= data_shape "
                            f"{width}")
                    row[k] = float(v)
                rows.append(row)
        data = onp.stack(rows) if rows else onp.zeros((0, width), dtype)
        super().__init__(data, onp.asarray(labels, dtype), batch_size,
                         shuffle, round_batch, seed)


def _read_idx(path):
    """Parse an IDX (MNIST) file, gzip-transparent."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        raw = f.read()
    magic, = struct.unpack(">i", raw[:4])
    ndim = magic & 0xFF
    dtype_code = (magic >> 8) & 0xFF
    if dtype_code != 0x08:
        raise MXNetError(f"IDX dtype {dtype_code:#x} unsupported")
    dims = struct.unpack(">" + "i" * ndim, raw[4:4 + 4 * ndim])
    a = onp.frombuffer(raw, dtype=onp.uint8, offset=4 + 4 * ndim)
    return a.reshape(dims)


class MNISTIter(_ArrayFeedIter):
    """Reference: src/io/iter_mnist.cc:260 — IDX image/label files,
    pixel scaling to [0,1], optional flat output."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, silent=True, input_shape=None,
                 **kwargs):
        imgs = _read_idx(image).astype("float32") / 255.0
        labs = _read_idx(label).astype("float32")
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        elif input_shape is not None:
            imgs = imgs.reshape((len(imgs),) + tuple(input_shape))
        else:
            imgs = imgs[:, None]  # (N, 1, 28, 28)
        if len(imgs) != len(labs):
            raise MXNetError("MNISTIter: image/label count mismatch")
        super().__init__(imgs, labs, batch_size, shuffle, True, seed)
