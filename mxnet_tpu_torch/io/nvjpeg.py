"""JPEG decode (and encode) on the card through nvJPEG (the binding
``csrc/jpeg_nvjpeg.cu``, linked with ``-lnvjpeg``).

:func:`decode_batch` is the decode half of ``ImageRecordIter``'s CUDA
target: a header pass per image on the host (an image that fails it is
reported, to be quarantined by its record id), one batched decode of
the rest into one device buffer of RGB uint8 HWC images, and, when the
batched call fails, a decode image by image so that the bad one is
named and never zero-filled.  Its output is what
``ops/image_augment.py`` takes.

:func:`require` raises an ``MXNetError`` naming ``nvjpeg.h`` and
``libnvjpeg`` when the toolkit lacks them or the binding does not
build: ``ImageRecordIter`` calls it at construction on a CUDA target,
and never falls back to decoding on the host.

A :class:`Decoder` holds nvJPEG state and serves one thread at a time;
:func:`decoder` gives each thread its own.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["require", "Decoder", "decoder", "decode_batch"]

_tls = threading.local()
_lib = None
_lib_lock = threading.Lock()


def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def require():
    """The binding's ctypes library, built on first use; raises naming
    ``nvjpeg.h``/``libnvjpeg`` where the toolkit lacks them."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        home = _cuda_home()
        header = os.path.join(home, "include", "nvjpeg.h")
        libs = glob.glob(os.path.join(home, "lib64", "libnvjpeg.so*"))
        if not os.path.exists(header) or not libs:
            raise MXNetError(
                f"ImageRecordIter on a CUDA target decodes with nvJPEG, "
                f"and this host's CUDA toolkit ({home}) lacks "
                f"{'nvjpeg.h' if not os.path.exists(header) else ''}"
                f"{' and ' if not libs and not os.path.exists(header) else ''}"
                f"{'libnvjpeg' if not libs else ''}; decode on the host "
                "with ctx=mx.cpu()")
        from .. import _kernels

        try:
            lib = _kernels.load("jpeg_nvjpeg")
        except MXNetError as exc:
            raise MXNetError(f"the nvJPEG binding (nvjpeg.h, libnvjpeg) "
                             f"did not build: {exc}") from exc
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        ip = ctypes.POINTER(ctypes.c_int)
        lib.mxt_nvj_create.argtypes = [ctypes.POINTER(vp)]
        lib.mxt_nvj_hardware.argtypes = [vp]
        lib.mxt_nvj_destroy.argtypes = [vp]
        lib.mxt_nvj_destroy.restype = None
        lib.mxt_nvj_info.argtypes = [vp, vp, i64, ip, ip, ip, ip]
        lib.mxt_nvj_decode_batched.argtypes = [vp, ctypes.c_int] + [vp] * 6
        lib.mxt_nvj_decode_one.argtypes = [vp, vp, i64, vp, ctypes.c_int,
                                           vp]
        lib.mxt_nvj_encode.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, vp,
                                       ctypes.POINTER(i64), vp]
        _lib = lib
        return lib


class Decoder:
    """nvJPEG handles and state for one thread on one card."""

    def __init__(self, device):
        self.lib = require()
        self.device = torch.device(device)
        h = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            rc = self.lib.mxt_nvj_create(ctypes.byref(h))
        if rc != 0:
            raise MXNetError(f"nvjpegCreate failed (status {rc})")
        self._h = h
        #: the batched decode's backend: "hardware", "gpu_hybrid" or
        #: "default"
        self.backend = ("default", "hardware", "gpu_hybrid")[
            self.lib.mxt_nvj_hardware(h)]

    def close(self):
        if self._h is not None:
            self.lib.mxt_nvj_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def info(self, jpeg):
        """(height, width) from the header, or None when nvJPEG cannot
        read it."""
        a = onp.frombuffer(jpeg, onp.uint8)
        h, w, c, s = (ctypes.c_int() for _ in range(4))
        rc = self.lib.mxt_nvj_info(self._h, a.ctypes.data, len(a),
                                   ctypes.byref(h), ctypes.byref(w),
                                   ctypes.byref(c), ctypes.byref(s))
        if rc != 0 or h.value <= 0 or w.value <= 0:
            return None
        return h.value, w.value

    def decode(self, jpegs, sizes, stream):
        """Decode ``jpegs`` (bytes, headers already read: ``sizes`` is
        their (h, w)) into one device buffer on ``stream`` (a
        ``torch.cuda.Stream``), which is synchronised before the host
        copy of the bitstreams is let go.  Returns
        ``(buffer, offsets, ok)``; ``ok[i]`` is False for an image that
        failed to decode on its own."""
        n = len(jpegs)
        offs = onp.zeros(n, onp.int64)
        nbytes = [h * w * 3 for h, w in sizes]
        if n > 1:
            onp.cumsum(nbytes[:-1], out=offs[1:])
        out = torch.empty(int(sum(nbytes)), dtype=torch.uint8,
                          device=self.device)
        ok = [True] * n
        if n == 0:
            return out, offs, ok
        lens = onp.array([len(j) for j in jpegs], onp.uint64)
        starts = onp.zeros(n, onp.uint64)
        if n > 1:
            onp.cumsum(lens[:-1], out=starts[1:])
        # the bitstreams in pinned memory: nvJPEG's copies of them to
        # the card are then asynchronous
        blob = torch.empty(int(lens.sum()), dtype=torch.uint8,
                           pin_memory=True)
        view = blob.numpy()
        for j, o, ln in zip(jpegs, starts, lens):
            view[int(o):int(o) + int(ln)] = onp.frombuffer(j, onp.uint8)
        ptrs = (starts + onp.uint64(blob.data_ptr())).astype(onp.uint64)
        widths = onp.array([w for _, w in sizes], onp.int32)
        sp = stream.cuda_stream
        rc = self.lib.mxt_nvj_decode_batched(
            self._h, n, ptrs.ctypes.data, lens.ctypes.data,
            out.data_ptr(), offs.ctypes.data, widths.ctypes.data, sp)
        if rc != 0:
            # one by one on the default backend: name the bad image
            for i in range(n):
                rc = self.lib.mxt_nvj_decode_one(
                    self._h, int(ptrs[i]), int(lens[i]),
                    out.data_ptr() + int(offs[i]), int(widths[i]), sp)
                ok[i] = rc == 0
        # the host bitstreams must outlive the decode's reads of them
        stream.synchronize()
        return out, offs, ok

    def encode(self, rgb, quality=90, subsampling=2):
        """JPEG bytes of an (h, w, 3) uint8 RGB tensor on the card
        (``subsampling`` is nvJPEG's chroma code: 0 4:4:4, 2 4:2:0,
        6 grayscale)."""
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        rgb = rgb.contiguous()
        cap = ctypes.c_int64(max(1 << 16, h * w * 3 + 4096))
        buf = onp.empty(cap.value, onp.uint8)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.lib.mxt_nvj_encode(self._h, rgb.data_ptr(), w, h,
                                     int(quality), int(subsampling),
                                     buf.ctypes.data, ctypes.byref(cap),
                                     stream)
        if rc != 0:
            raise MXNetError(f"nvjpegEncodeImage failed (status {rc})")
        return buf[:cap.value].tobytes()


def decoder(device):
    """This thread's :class:`Decoder` for ``device``."""
    cache = getattr(_tls, "decoders", None)
    if cache is None:
        cache = _tls.decoders = {}
    key = torch.device(device).index
    d = cache.get(key)
    if d is None:
        d = cache[key] = Decoder(device)
    return d


def decode_batch(jpegs, device):
    """Header pass and decode on the current stream.  Returns
    ``(buffer, offsets, heights, widths, bad, kept)``: the packed images
    that decoded, ``kept`` their positions in ``jpegs``, and ``bad`` the
    positions of those that did not, each with its reason."""
    dec = decoder(device)
    sizes, keep, bad = [], [], []
    for i, j in enumerate(jpegs):
        s = dec.info(j)
        if s is None:
            bad.append((i, "nvjpegGetImageInfo failed"))
        else:
            sizes.append(s)
            keep.append(i)
    stream = torch.cuda.current_stream(dec.device)
    buf, offs, ok = dec.decode([jpegs[i] for i in keep], sizes, stream)
    good = [k for k, o in enumerate(ok) if o]
    bad += [(keep[k], "nvjpegDecode failed")
            for k, o in enumerate(ok) if not o]
    return (buf, offs[good], [sizes[k][0] for k in good],
            [sizes[k][1] for k in good], sorted(bad), [keep[k]
                                                      for k in good])
