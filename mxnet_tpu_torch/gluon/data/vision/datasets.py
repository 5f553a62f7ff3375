"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; reference
python/mxnet/gluon/data/vision/datasets.py).

``MNIST``/``FashionMNIST`` read the IDX files (plain or ``.gz``),
``CIFAR10``/``CIFAR100`` the binary batches, ``ImageRecordDataset`` a
``.rec`` file and its ``.idx``, ``ImageFolderDataset`` one folder of
images per class.  They read local files only: a missing file raises the
reference's error, and nothing is downloaded.  Images are HWC uint8
NDArrays on the host; labels int32.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from .... import ndarray as nd
from .... import recordio
from ....base import MXNetError
from ....context import cpu
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = struct.unpack(">I", data[:4])[0]
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = onp.frombuffer(data[4 + 4 * ndim:], dtype=onp.uint8)
    return arr.reshape(dims)


def _host_uint8(arr):
    return nd.array(arr, ctx=cpu(), dtype="uint8")


class _DownloadedDataset(Dataset):
    """A dataset of local files under ``root`` (the reference's base of
    MNIST and CIFAR; it downloads nothing)."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from the IDX files in ``root``."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.isfile(p):
                return p
        raise MXNetError(
            f"{base} not found under {self._root}; this environment has "
            "no network egress — place the IDX files there manually.")

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        images = _read_idx(self._find(files[0]))
        labels = _read_idx(self._find(files[1]))
        self._data = _host_uint8(images.reshape(-1, 28, 28, 1))
        self._label = labels.astype(onp.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the binary batches in ``root`` (or its
    ``cifar-10-batches-bin``)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_subdir = "cifar-10-batches-bin"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = onp.frombuffer(fin.read(), dtype=onp.uint8).reshape(
                -1, 3072 + 1)
        return (data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, 0].astype(onp.int32))

    def _base(self):
        sub = os.path.join(self._root, self._archive_subdir)
        return sub if os.path.isdir(sub) else self._root

    def _get_data(self):
        base = self._base()
        if self._train:
            filenames = [os.path.join(base, f"data_batch_{i}.bin")
                         for i in range(1, 6)]
        else:
            filenames = [os.path.join(base, "test_batch.bin")]
        for f in filenames:
            if not os.path.isfile(f):
                raise MXNetError(
                    f"{f} not found; no network egress — place CIFAR "
                    "binary batches there manually.")
        data, label = zip(*[self._read_batch(f) for f in filenames])
        self._data = _host_uint8(onp.concatenate(data))
        self._label = onp.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100 (``fine_label``: the 100 classes, else the 20
    superclasses)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._archive_subdir = "cifar-100-binary"
        _DownloadedDataset.__init__(self, root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = onp.frombuffer(fin.read(), dtype=onp.uint8).reshape(
                -1, 3072 + 2)
        return (data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                data[:, 0 + self._fine_label].astype(onp.int32))

    def _get_data(self):
        f = os.path.join(self._base(),
                         "train.bin" if self._train else "test.bin")
        if not os.path.isfile(f):
            raise MXNetError(f"{f} not found (no network egress)")
        data, label = self._read_batch(f)
        self._data = _host_uint8(data)
        self._label = label


class ImageRecordDataset(RecordFileDataset):
    """Images and labels of a ``.rec`` file: item ``i`` is ``(HWC uint8
    image, label)`` (``flag`` 0: grayscale)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img_bytes = recordio.unpack(record)
        img = _host_uint8(recordio._imdecode(
            onp.frombuffer(img_bytes, dtype=onp.uint8), self._flag))
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """Images in ``root/<class>/``: the label is the class folder's index
    in sorted order (``synsets``); ``.jpg``, ``.jpeg`` and ``.png``."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                if os.path.splitext(filename)[1].lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        with open(fname, "rb") as f:
            buf = onp.frombuffer(f.read(), dtype=onp.uint8)
        img = _host_uint8(recordio._imdecode(buf, self._flag))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
