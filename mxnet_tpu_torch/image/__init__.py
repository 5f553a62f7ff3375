"""mx.image: image I/O, transforms, augmenters and ImageIter
(counterpart of ``mxnet_tpu/image/__init__.py``).

Reference parity: python/mxnet/image/image.py (imread/imdecode/imresize/
the crops, the Augmenter chain built by CreateAugmenter :1025, the
pure-Python ImageIter :1139).

Decoded images are HWC uint8 host NDArrays (``cpu(0)``): decoding and
augmenting one image at a time is host work.  ``imdecode`` decodes with
PIL, as the reference does, and with the native library
(``mxnet_tpu_torch._native``, libjpeg) where PIL is missing; resizes go
through PIL.  The batched path that decodes on the card is
``io.ImageRecordIter``.
"""
from __future__ import annotations

import io as _io
import os
import random as pyrandom

import numpy as onp

import torch

from .. import ndarray as nd
from .. import recordio
from ..base import MXNetError
from ..context import cpu
from ..io.io import DataBatch, DataIter

__all__ = [
    "imread", "imdecode", "imresize", "resize_short", "fixed_crop",
    "center_crop", "random_crop", "random_size_crop", "color_normalize",
    "copyMakeBorder", "Augmenter", "SequentialAug", "RandomOrderAug",
    "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
    "RandomSizedCropAug", "HorizontalFlipAug", "CastAug",
    "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
    "HueJitterAug", "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
    "RandomGrayAug", "CreateAugmenter", "ImageIter",
]


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("mx.image needs PIL (Pillow) for this call, "
                         "and it is not installed") from None
    return Image


def _host(arr, dtype=None):
    """A host NDArray over a numpy array."""
    return nd.array(onp.ascontiguousarray(arr), ctx=cpu(), dtype=dtype)


def _t(src):
    """The tensor of an NDArray (or of an array-like)."""
    if isinstance(src, nd.NDArray):
        return src._data
    return torch.as_tensor(onp.asarray(src))


def _decode_native(buf, flag):
    """libjpeg through the native library: RGB uint8 HWC."""
    import ctypes

    from .. import _native

    lib = _native.get_lib()
    if lib is None:
        raise MXNetError("mx.image needs PIL (Pillow) or the native "
                         "library (g++ and libjpeg) to decode, and has "
                         "neither")
    a = onp.frombuffer(bytes(buf), onp.uint8)
    p = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.rec_jpeg_size(p, len(a), ctypes.byref(h), ctypes.byref(w)):
        raise MXNetError("imdecode: not a JPEG libjpeg can read")
    out = onp.empty((h.value, w.value, 3), onp.uint8)
    if lib.rec_jpeg_decode(p, len(a), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), h.value, w.value):
        raise MXNetError("imdecode: libjpeg failed to decode")
    if not flag:
        gray = out.astype("float32") @ onp.array(
            [0.299, 0.587, 0.114], "float32")
        out = onp.clip(onp.round(gray), 0, 255).astype(onp.uint8)
    return out


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to an HWC uint8 host NDArray
    (reference image.py imdecode: PIL; the native library's libjpeg
    where PIL is missing)."""
    if isinstance(buf, nd.NDArray):
        buf = bytes(buf.asnumpy().astype("uint8").tobytes())
    try:
        Image = _pil()
    except MXNetError:
        arr = _decode_native(buf, flag)
    else:
        img = Image.open(_io.BytesIO(bytes(buf)))
        img = img.convert("RGB" if flag else "L")
        arr = onp.asarray(img)
    if not to_rgb and flag:
        arr = arr[..., ::-1]  # BGR like OpenCV default
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _host(arr, dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    """Reference: image.py imread."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Reference: image.py imresize (bilinear default)."""
    Image = _pil()
    arr = src.asnumpy() if isinstance(src, nd.NDArray) else onp.asarray(src)
    mode_in = arr.astype("uint8")
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS}.get(interp, Image.BILINEAR)
    img = Image.fromarray(mode_in.squeeze() if mode_in.shape[-1] == 1
                          else mode_in)
    img = img.resize((w, h), resample)
    out = onp.asarray(img)
    if out.ndim == 2:
        out = out[:, :, None]
    return _host(out, dtype="uint8")


def resize_short(src, size, interp=2):
    """Resize the shorter side to `size` (reference image.py:_get_interp
    + resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Reference: image.py fixed_crop."""
    out = nd.NDArray(_t(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                     interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(w - new_w, 0))
    y0 = pyrandom.randint(0, max(h - new_h, 0))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                     interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random area+aspect crop (reference image.py random_size_crop /
    the Inception-style aug)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """Reference: image.py color_normalize."""
    arr = _t(src).to(torch.float32)
    out = arr - _t(mean).to(torch.float32)
    if std is not None:
        out = out / _t(std).to(torch.float32)
    return nd.NDArray(out)


def copyMakeBorder(src, top, bot, left, right, type=0, value=0):  # noqa: A002,N802
    arr = src.asnumpy()
    out = onp.pad(arr, ((top, bot), (left, right), (0, 0)),
                  mode="constant", constant_values=value)
    return _host(out, dtype=str(arr.dtype))


# ------------------------------------------------------------- augmenters
class Augmenter:
    """Reference: image.py Augmenter base."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = (size, area,
                                                         ratio, interp)

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return nd.NDArray(torch.flip(_t(src), dims=[1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return nd.NDArray(_t(src).to(torch.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], "float32")

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        arr = _t(src).to(torch.float32)
        gray = (arr * torch.from_numpy(self._coef)).sum() \
            * (3.0 / arr.numel())
        return nd.NDArray(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], "float32")

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        arr = _t(src).to(torch.float32)
        gray = (arr * torch.from_numpy(self._coef)).sum(dim=2,
                                                          keepdim=True)
        return nd.NDArray(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Reference image.py HueJitterAug (yiq rotation)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], "float32")
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], "float32")

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       "float32")
        t = onp.dot(onp.dot(self.ityiq, bt), self.tyiq).T
        arr = _t(src).to(torch.float32)
        return nd.NDArray(arr @ torch.from_numpy(
            onp.ascontiguousarray(t, "float32")))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-noise lighting (reference image_aug_default.cc pca noise)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, "float32")
        self.eigvec = onp.asarray(eigvec, "float32")

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,)).astype(
            "float32")
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        return nd.NDArray(_t(src).to(torch.float32)
                          + torch.from_numpy(rgb.astype("float32")))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = onp.asarray(mean, "float32") if mean is not None \
            else None
        self.std = onp.asarray(std, "float32") if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = onp.array([[[0.299, 0.587, 0.114]]], "float32")

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            arr = _t(src).to(torch.float32)
            gray = (arr * torch.from_numpy(self._coef)).sum(dim=2,
                                                              keepdim=True)
            return nd.NDArray(gray.expand(arr.shape).contiguous())
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,  # noqa: N802
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference image.py:1025)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Pure-python image iterator over .rec files or .lst+directory
    (reference image.py ImageIter:1139)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imgrec=None, dtype="float32", last_batch_handle="pad",
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self._shuffle = shuffle
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError(
                f"last_batch_handle={last_batch_handle!r} not supported "
                "(pad | discard)")
        self._last_batch_handle = last_batch_handle
        self._records = []  # list of (label_array|None, payload | path)
        self._mm = None
        if path_imgrec:
            # mmap + frame once: records are memoryviews into the file
            # (no up-front copy of a possibly-huge .rec); labels are
            # unpacked lazily per sample
            import mmap as _mmap

            from .. import _native

            self._rec_file = open(path_imgrec, "rb")
            self._mm = _mmap.mmap(self._rec_file.fileno(), 0,
                                  access=_mmap.ACCESS_READ)
            if _native.get_lib() is not None:
                payloads = _native.parse_records(self._mm)
            else:
                reader = recordio.MXRecordIO(path_imgrec, "r")
                payloads = []
                while True:
                    s = reader.read()
                    if s is None:
                        break
                    payloads.append(s)
                reader.close()
            self._records = [(None, p) for p in payloads]
        elif path_imglist:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = onp.asarray([float(x) for x in parts[1:-1]],
                                        "float32")
                    self._records.append(
                        (label, os.path.join(path_root, parts[-1])))
        else:
            raise MXNetError("need path_imgrec or path_imglist")
        if num_parts > 1:  # sharding (kv.num_workers / rank)
            self._records = self._records[part_index::num_parts]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._order = list(range(len(self._records)))
        self.reset()

    @property
    def provide_data(self):
        from ..io.io import DataDesc

        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self.dtype)]

    @property
    def provide_label(self):
        from ..io.io import DataDesc

        return [DataDesc("softmax_label",
                         (self.batch_size, self.label_width)
                         if self.label_width > 1
                         else (self.batch_size,), "float32")]

    def reset(self):
        if self._shuffle:
            pyrandom.shuffle(self._order)
        self._cursor = 0

    def close(self):
        """Release the mmap/file handle (pair of the lazy .rec mmap)."""
        self._records = []
        if self._mm is not None:
            self._mm.close()
            self._rec_file.close()
            self._mm = None

    def next_sample(self):
        if self._cursor >= len(self._records):
            raise StopIteration
        label, src = self._records[self._order[self._cursor]]
        self._cursor += 1
        if isinstance(src, (bytes, memoryview)):
            if label is None:  # .rec payload: unpack header lazily
                header, img_bytes = recordio.unpack(bytes(src))
                label = onp.atleast_1d(onp.asarray(header.label,
                                                   "float32"))
                img = imdecode(img_bytes)
            else:
                img = imdecode(src)
        else:
            img = imread(src)
        return label, img

    def next(self):
        c, h, w = self.data_shape
        batch = onp.zeros((self.batch_size, h, w, c), "float32")
        labels = onp.zeros((self.batch_size, self.label_width), "float32")
        i = 0
        try:
            while i < self.batch_size:
                label, img = self.next_sample()
                for aug in self.auglist:
                    img = aug(img)
                arr = img.asnumpy()
                if arr.shape[:2] != (h, w):
                    arr = imresize(_host(arr.astype("uint8")), w,
                                   h).asnumpy()
                batch[i] = arr.astype("float32")
                labels[i, :len(label)] = label[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0 or (i < self.batch_size
                          and self._last_batch_handle == "discard"):
                raise
        pad = self.batch_size - i
        data = _host(batch.transpose(0, 3, 1, 2))  # NCHW
        lab = _host(labels[:, 0] if self.label_width == 1 else labels)
        return DataBatch(data=[data], label=[lab], pad=pad)
