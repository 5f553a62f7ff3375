"""The decoded-image augment of ``ImageRecordIter`` (the port's own
kernel, ``csrc/image_augment.cu``; no TPU counterpart).

Computes what ``src/recordio_native.cc decode_augment_batch`` computes
after its libjpeg decode: resize-short by ``ResizeBilinear``'s float
arithmetic with ``+0.5f`` truncation, the crop at the drawn origin (or a
resize of the whole frame when the image is smaller than the crop), the
mirror, and ``(v - mean) / std`` into NCHW float32.  Images come packed
in one uint8 buffer: image ``i`` at ``offs[i]``, ``(heights[i],
widths[i], 3)`` RGB HWC, as nvJPEG decodes them (``io/nvjpeg.py``).

``image_augment`` launches the kernel on a CUDA buffer (one launch per
batch, counted on ``image_augment.launches``) and takes
``image_augment_plain`` on a host buffer.  ``image_augment_plain`` is the
same function in plain PyTorch, operation for operation in float32, so
it equals the native library's output bit for bit; the tests and
``chip_smoke.py`` hold the kernel against it.  The geometry (the
resized side in double, the crop origin in float, as the C++ computes
them) is :func:`plan`, shared by both.
"""
from __future__ import annotations

import ctypes

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["plan", "image_augment", "image_augment_plain"]


def plan(heights, widths, out_h, out_w, crop_x, crop_y, resize_short=-1):
    """Per-image geometry as an int32 array (5, n): the resized height
    and width, whether the resize runs, and the crop origin ``x0, y0``
    in the resized image (-1, -1 when the image is smaller than the
    crop and its whole frame is resized instead)."""
    n = len(heights)
    g = onp.empty((5, n), onp.int32)
    for i in range(n):
        h, w = int(heights[i]), int(widths[i])
        if resize_short > 0:
            # recordio_native.cc :169-176, in double as there
            if h < w:
                nh = resize_short
                nw = int(1.0 * w * resize_short / h + 0.5)
            else:
                nw = resize_short
                nh = int(1.0 * h * resize_short / w + 0.5)
        else:
            nh, nw = h, w
        if nh >= out_h and nw >= out_w:
            # float * int in float, truncated (:181-182)
            x0 = int(onp.float32(crop_x[i]) * onp.float32(nw - out_w))
            y0 = int(onp.float32(crop_y[i]) * onp.float32(nh - out_h))
        else:
            x0 = y0 = -1
        g[:, i] = (nh, nw, 1 if resize_short > 0 else 0, x0, y0)
    return g


def _norm(v, default):
    if v is None:
        return onp.full(3, default, onp.float32)
    return onp.asarray(v, onp.float32).reshape(3)


def _bilinear(img, dh, dw):
    """``ResizeBilinear`` (recordio_native.cc :77-105) of an (h, w, 3)
    uint8 tensor to (dh, dw), in float32 operation for operation."""
    sh, sw = int(img.shape[0]), int(img.shape[1])
    f32 = dict(dtype=torch.float32, device=img.device)
    sy = onp.float32(sh - 1) / onp.float32(dh - 1) if dh > 1 \
        else onp.float32(0)
    sx = onp.float32(sw - 1) / onp.float32(dw - 1) if dw > 1 \
        else onp.float32(0)
    fy = torch.arange(dh, **f32) * torch.tensor(sy, **f32)
    fx = torch.arange(dw, **f32) * torch.tensor(sx, **f32)
    y0 = fy.to(torch.int64)
    x0 = fx.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=sh - 1)
    x1 = torch.clamp(x0 + 1, max=sw - 1)
    wy = (fy - y0.to(torch.float32))[:, None, None]
    wx = (fx - x0.to(torch.float32))[None, :, None]
    src = img.to(torch.float32)
    v00 = src[y0[:, None], x0[None, :]]
    v01 = src[y0[:, None], x1[None, :]]
    v10 = src[y1[:, None], x0[None, :]]
    v11 = src[y1[:, None], x1[None, :]]
    ay = 1.0 - wy
    ax = 1.0 - wx
    v = v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx
    return (v + 0.5).to(torch.uint8)


def image_augment_plain(src, offs, heights, widths, out_h, out_w, crop_x,
                        crop_y, mirror, mean=None, std=None,
                        resize_short=-1):
    """The augment in plain PyTorch, on ``src``'s device (the host, or
    the card when ``chip_smoke.py`` holds the kernel against it):
    (n, 3, out_h, out_w) float32, equal bit for bit to the native
    library's ``decode_augment_batch`` on the same decoded pixels."""
    n = len(heights)
    g = plan(heights, widths, out_h, out_w, crop_x, crop_y, resize_short)
    m = torch.from_numpy(_norm(mean, 0.0)).to(src.device)
    s = torch.from_numpy(_norm(std, 1.0)).to(src.device)
    out = torch.empty((n, 3, out_h, out_w), dtype=torch.float32,
                      device=src.device)
    flat = src.reshape(-1)
    for i in range(n):
        h, w = int(heights[i]), int(widths[i])
        o = int(offs[i])
        img = flat[o:o + h * w * 3].reshape(h, w, 3)
        nh, nw, rs, x0, y0 = (int(v) for v in g[:, i])
        if rs:
            img = _bilinear(img, nh, nw)
        if x0 >= 0:
            img = img[y0:y0 + out_h, x0:x0 + out_w]
        else:
            img = _bilinear(img, out_h, out_w)
        if mirror[i]:
            img = torch.flip(img, dims=[1])
        out[i] = ((img.to(torch.float32) - m) / s).permute(2, 0, 1)
    return out


def _kernel():
    from .. import _kernels

    fn = _kernels.load("image_augment").mxt_image_augment
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    return fn


def image_augment(src, offs, heights, widths, out_h, out_w, crop_x,
                  crop_y, mirror, mean=None, std=None, resize_short=-1):
    """The augment of a packed batch of decoded images: the kernel on a
    CUDA buffer (on the current stream), the plain version on a host
    one.  Returns (n, 3, out_h, out_w) float32 on ``src``'s device."""
    if src.device.type != "cuda":
        return image_augment_plain(src, offs, heights, widths, out_h,
                                   out_w, crop_x, crop_y, mirror, mean,
                                   std, resize_short)
    if src.dtype != torch.uint8 or not src.is_contiguous():
        raise MXNetError("image_augment takes a contiguous uint8 buffer")
    n = len(heights)
    dev = src.device
    out = torch.empty((n, 3, out_h, out_w), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    g = plan(heights, widths, out_h, out_w, crop_x, crop_y, resize_short)
    meta = onp.empty((8, n), onp.int32)
    meta[0] = onp.asarray(heights, onp.int32)
    meta[1] = onp.asarray(widths, onp.int32)
    meta[2:7] = g
    meta[7] = onp.asarray(mirror, onp.int32).reshape(n)
    # the same row order the kernel takes: sh sw rh rw resize x0 y0 mirror
    meta_d = torch.from_numpy(meta).pin_memory().to(dev, non_blocking=True)
    offs_d = torch.from_numpy(onp.asarray(offs, onp.int64)).pin_memory() \
        .to(dev, non_blocking=True)
    mm, ss = _norm(mean, 0.0), _norm(std, 1.0)
    rows = [meta_d[k] for k in range(8)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernel()(src.data_ptr(), offs_d.data_ptr(),
                       *(r.data_ptr() for r in rows), out.data_ptr(), n,
                       out_h, out_w, *(float(v) for v in mm),
                       *(float(v) for v in ss), stream)
    if rc != 0:
        raise MXNetError(f"image_augment kernel launch failed (CUDA "
                         f"error {rc})")
    image_augment.launches += 1
    return out


image_augment.launches = 0
