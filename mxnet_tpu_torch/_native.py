"""The host data plane's native library (counterpart of
``mxnet_tpu/_native.py``).

Builds the reference's ``src/recordio_native.cc`` (it is only read)
with ``g++ -ljpeg`` into ``mxnet_tpu_torch/_build/`` on first use and
binds it with ctypes: the record parser (``rec_parse``), the threaded
JPEG decode and augment of a batch (``decode_augment_batch``) and the
header read (``rec_jpeg_size``).  It is the same code as the
reference's, so host batches agree bit for bit.  Every call runs with
the GIL released (ctypes drops it).

``get_lib()`` returns None where ``g++`` or libjpeg's ``jpeglib.h`` is
missing (the card's host has neither); callers then take PIL and the
plain PyTorch augment on the host, or nvJPEG and the hand-written
augment kernel on the card (``io/gpu_decode.py``).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as onp

_lock = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "recordio_native.cc")
_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_build")


_JPEGLIB_DIRS = ("/usr/include", "/usr/local/include")


def toolchain_present():
    """Whether this host can build the library: ``g++`` on PATH and
    libjpeg's header."""
    return shutil.which("g++") is not None and any(
        os.path.exists(os.path.join(d, "jpeglib.h"))
        for d in _JPEGLIB_DIRS)


def build_native(src, out_name, ldflags=(), opt="-O3"):
    """Build ``src`` into ``_build/<out_name>`` and return the path.

    Atomic against concurrent builds (DataLoader workers may all
    find a cold cache): compile to a per-pid temp file, then
    ``os.replace`` onto the final name, so a reader sees either no
    file or a whole one."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    out = os.path.join(_OUT_DIR, out_name)
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", opt, "-shared", "-fPIC", "-std=c++17", src,
           "-o", tmp] + list(ldflags)
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _build():
    return build_native(_SRC, "librecordio_native.so",
                        ldflags=("-ljpeg", "-lpthread"))


def get_lib():
    """The loaded native library, building it on first call; None
    where the toolchain is missing or the build fails."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not toolchain_present():
            return None
        try:
            path = _build()
            lib = ctypes.CDLL(path)
        except Exception:
            _lib = None
            return None
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rec_parse.restype = i64
        lib.rec_parse.argtypes = [u8p, i64, i64p, i64p, u32p, i64]
        lib.decode_augment_batch.restype = i64
        lib.decode_augment_batch.argtypes = [
            u8p, i64p, i64p, i64, f32p, i64, i64, f32p, f32p, f32p,
            f32p, u8p, ctypes.c_int, ctypes.c_int]
        lib.rec_jpeg_size.restype = ctypes.c_int
        lib.rec_jpeg_size.argtypes = [u8p, i64, ctypes.POINTER(
            ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.rec_jpeg_decode.restype = ctypes.c_int
        lib.rec_jpeg_decode.argtypes = [u8p, i64, u8p, ctypes.c_int,
                                        ctypes.c_int]
        _lib = lib
        return _lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def parse_records(buf, return_offsets=False):
    """Split a raw .rec byte buffer into payload memoryviews using the
    native parser (dmlc framing incl. continuation flags).

    ``return_offsets=True`` also returns each LOGICAL record's
    frame-start byte offset (``(records, offsets)``) — the parser
    already computes them, and the data plane's quarantine manifest
    promises seekable offsets."""
    lib = get_lib()
    arr = onp.frombuffer(buf, dtype=onp.uint8)
    max_records = max(len(arr) // 8, 1)
    offsets = onp.empty(max_records, onp.int64)
    sizes = onp.empty(max_records, onp.int64)
    lflags = onp.empty(max_records, onp.uint32)
    n = lib.rec_parse(_ptr(arr, ctypes.c_uint8), len(arr),
                      _ptr(offsets, ctypes.c_int64),
                      _ptr(sizes, ctypes.c_int64),
                      _ptr(lflags, ctypes.c_uint32), max_records)
    if n < 0:
        raise IOError("invalid recordio framing")
    if n > 0 and int(offsets[n - 1] + sizes[n - 1]) > len(arr):
        raise IOError(
            "truncated recordio buffer: last record extends past EOF")
    records = []
    rec_offsets = []  # frame start of each logical record
    i = 0
    mv = memoryview(buf)
    magic = onp.uint32(0xCED7230A).tobytes()
    while i < n:
        rec_offsets.append(int(offsets[i]) - 8)  # payload - header
        if lflags[i] == 0:  # whole record in one part
            records.append(mv[offsets[i]:offsets[i] + sizes[i]])
            i += 1
        else:
            # multi-part record: the writer split the payload wherever
            # it contained the magic bytes, stripping them — rejoin
            # with the magic as separator (recordio.py MXRecordIO.read)
            parts = [bytes(mv[offsets[i]:offsets[i] + sizes[i]])]
            i += 1
            while i < n and lflags[i] in (2, 3):
                parts.append(bytes(mv[offsets[i]:offsets[i] + sizes[i]]))
                end = lflags[i] == 3
                i += 1
                if end:
                    break
            records.append(memoryview(magic.join(parts)))
    if return_offsets:
        return records, rec_offsets
    return records


def decode_augment_batch(jpeg_list, out_h, out_w, mean=None, std=None,
                         crop_x=None, crop_y=None, mirror=None,
                         resize_short=-1, num_threads=0):
    """Threaded decode+augment of a list of JPEG byte strings into an
    NCHW float32 batch.  Returns (batch, n_failed)."""
    lib = get_lib()
    n = len(jpeg_list)
    blob = b"".join(bytes(j) for j in jpeg_list)
    arr = onp.frombuffer(blob, dtype=onp.uint8)
    lens = onp.array([len(j) for j in jpeg_list], onp.int64)
    offs = onp.zeros(n, onp.int64)
    onp.cumsum(lens[:-1], out=offs[1:]) if n > 1 else None
    out = onp.empty((n, 3, out_h, out_w), onp.float32)
    meanp = (onp.asarray(mean, onp.float32) if mean is not None else None)
    stdp = (onp.asarray(std, onp.float32) if std is not None else None)
    cx = onp.asarray(crop_x if crop_x is not None else
                     onp.full(n, 0.5), onp.float32)
    cy = onp.asarray(crop_y if crop_y is not None else
                     onp.full(n, 0.5), onp.float32)
    mir = onp.asarray(mirror if mirror is not None else
                      onp.zeros(n), onp.uint8)
    fails = lib.decode_augment_batch(
        _ptr(arr, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), n, _ptr(out, ctypes.c_float),
        out_h, out_w,
        _ptr(meanp, ctypes.c_float) if meanp is not None else None,
        _ptr(stdp, ctypes.c_float) if stdp is not None else None,
        _ptr(cx, ctypes.c_float), _ptr(cy, ctypes.c_float),
        _ptr(mir, ctypes.c_uint8), resize_short, num_threads)
    return out, int(fails)
