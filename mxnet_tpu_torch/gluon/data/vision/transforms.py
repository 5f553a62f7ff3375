"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference
python/mxnet/gluon/data/vision/transforms.py).

Blocks over HWC images (``ToTensor`` makes CHW): ``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``Resize``, ``CenterCrop`` and the random
ones, ``RandomResizedCrop``, the flips, the colour jitters,
``RandomLighting`` and ``RandomGray``.  ``Resize`` is the reference's
``jax.image.resize``: bilinear with its antialiasing triangle kernel
when shrinking (the weights computed as there, in float32), or nearest.
Every random draw comes from the host's generator of ``mx.random``
(``mx.random.seed`` seeds it; a ``key_scope`` gives a step its own),
where the reference draws from numpy's global RNG: the two packages
draw the same distributions, not the same numbers.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .... import _rng
from ....dtype import normalize_dtype
from ... import nn
from ...block import Block, HybridBlock

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray"]

_GRAY = onp.array([0.299, 0.587, 0.114], dtype="float32")


def _gen():
    return _rng.take_key(torch.device("cpu"))


def _rand():
    """A uniform draw in [0, 1) (float64)."""
    return float(torch.rand((), dtype=torch.float64, generator=_gen()))


def _uniform(lo, hi):
    return lo + (hi - lo) * _rand()


class Compose(nn.Sequential):
    """Apply ``transforms`` in order; runs of hybrid ones are grouped in a
    ``HybridSequential``, as the reference does."""

    def __init__(self, transforms):
        super().__init__()
        transforms = list(transforms) + [None]
        hybrid = []
        for t in transforms:
            if isinstance(t, HybridBlock):
                hybrid.append(t)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                block = nn.HybridSequential()
                for h in hybrid:
                    block.add(h)
                self.add(block)
            hybrid = []
            if t is not None:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.to(normalize_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def forward(self, x):
        x = x.to(torch.float32) / 255.0
        return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    """``(x - mean) / std`` per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def forward(self, x):
        mean = torch.as_tensor(onp.asarray(self._mean, "float32").reshape(
            -1, 1, 1), device=x.device)
        std = torch.as_tensor(onp.asarray(self._std, "float32").reshape(
            -1, 1, 1), device=x.device)
        return (x - mean) / std


def _weight_mat(m, n):
    """``jax.image``'s weights of a linear resize of ``m`` samples to
    ``n`` (``compute_weight_mat``: the triangle kernel, widened by
    ``1/scale`` when shrinking), float32, shaped ``(m, n)``."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(m, dtype=torch.float32)[:, None]) \
        / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(onp.finfo(
        onp.float32).eps), w / torch.where(total != 0, total,
                                           torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_hwc(x, size, interp=1):
    """Resize an HWC image to ``size`` (``(width, height)``, or one side
    for both), keeping its dtype."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    H, W = x.shape[0], x.shape[1]
    data = x.to(torch.float32)
    if interp == 0:
        for axis, (m, n) in enumerate(((H, h), (W, w))):
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32)
                                   + 0.5) * m / n).to(torch.int64)
                data = data.index_select(axis, idx.to(data.device))
        return data.to(x.dtype)
    if H != h:
        data = torch.einsum("hwc,hH->Hwc", data,
                            _weight_mat(H, h).to(data.device))
    if W != w:
        data = torch.einsum("hwc,wW->hWc", data,
                            _weight_mat(W, w).to(data.device))
    return data.to(x.dtype)


class Resize(Block):
    """Resize to ``size`` (``(width, height)``); with ``keep_ratio`` and
    one side, the shorter side to it."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if self._keep and isinstance(self._size, int):
            h, w = x.shape[0], x.shape[1]
            if h > w:
                size = (self._size, int(h * self._size / w))
            else:
                size = (int(w * self._size / h), self._size)
        else:
            size = self._size
        return _resize_hwc(x, size, self._interpolation)


class CenterCrop(Block):
    """The centre ``size`` (``(width, height)``) crop, the image first
    enlarged where it is smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        if H < h or W < w:
            x = _resize_hwc(x, (max(w, W), max(h, H)), self._interpolation)
            H, W = x.shape[0], x.shape[1]
        y0 = (H - h) // 2
        x0 = (W - w) // 2
        return x[y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """A crop of a random area share (``scale``) and aspect ratio
    (``ratio``, drawn in log space), resized to ``size``; the centre crop
    after 10 misses."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _uniform(*self._scale) * area
            aspect = math.exp(_uniform(math.log(self._ratio[0]),
                                       math.log(self._ratio[1])))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = int(torch.randint(0, W - w + 1, (),
                                       generator=_gen()))
                y0 = int(torch.randint(0, H - h + 1, (),
                                       generator=_gen()))
                return _resize_hwc(x[y0:y0 + h, x0:x0 + w, :], self._size,
                                   self._interpolation)
        return CenterCrop(self._size, self._interpolation).forward(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        return torch.flip(x, (1,)) if _rand() < 0.5 else x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        return torch.flip(x, (0,)) if _rand() < 0.5 else x


class _RandomJitter(Block):
    """Brightness, contrast, saturation and hue jitter of an HWC image in
    [0, 255], float32 out (the reference's arithmetic, in float32)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
        super().__init__()
        self._args = (brightness, contrast, saturation, hue)

    def forward(self, x):
        img = x.detach().to("cpu", torch.float32).numpy().copy()
        b, c, s, h = self._args
        if b > 0:
            img *= 1.0 + _uniform(-b, b)
        if c > 0:
            alpha = 1.0 + _uniform(-c, c)
            gray_mean = (img * _GRAY).sum() / (img.size / 3)
            img = img * alpha + gray_mean * (1 - alpha)
        if s > 0:
            alpha = 1.0 + _uniform(-s, s)
            gray = (img * _GRAY).sum(axis=2, keepdims=True)
            img = img * alpha + gray * (1 - alpha)
        if h > 0:
            alpha = _uniform(-h, h)
            u = onp.cos(alpha * onp.pi)
            w = onp.sin(alpha * onp.pi)
            bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                           dtype="float32")
            t_yiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], dtype="float32")
            t_rgb = onp.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype="float32")
            img = img @ (t_rgb @ bt @ t_yiq).T
        return torch.from_numpy(onp.clip(img, 0, 255).astype(
            "float32")).to(x.device)


class RandomBrightness(_RandomJitter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)


class RandomContrast(_RandomJitter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)


class RandomSaturation(_RandomJitter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)


class RandomHue(_RandomJitter):
    def __init__(self, hue):
        super().__init__(hue=hue)


class RandomColorJitter(_RandomJitter):
    pass


class RandomLighting(Block):
    """AlexNet's PCA colour noise (``random_lighting``): the RGB shift
    ``eigvec @ (alpha * eigval)``, ``alpha ~ N(0, alpha_std)``."""

    _eigval = onp.array([55.46, 4.794, 1.148], dtype="float32")
    _eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype="float32")

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = (torch.randn(3, dtype=torch.float64, generator=_gen())
                 * self._alpha).numpy().astype("float32")
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x.to(torch.float32) + torch.from_numpy(rgb).to(x.device)


class RandomGray(Block):
    """With probability ``p``, the image's luma in every channel
    (float32)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _rand() < self._p:
            gray = (x.to(torch.float32) * torch.from_numpy(_GRAY).to(
                x.device)).sum(dim=2, keepdim=True)
            return gray.expand(x.shape).contiguous()
        return x
