"""RecordIO: pack/unpack and the (indexed) record file readers and
writers (counterpart of ``mxnet_tpu/recordio.py``).

Reference parity: python/mxnet/recordio.py (``MXRecordIO``,
``MXIndexedRecordIO``, ``IRHeader``, pack/unpack/pack_img/unpack_img)
and dmlc-core's framing (magic + cflag|length + payload + padding).
Pure Python, byte-compatible with the reference's files both ways.
``pack_img``/``unpack_img`` encode and decode through PIL (the
reference's first choice, cv2, is not a dependency); without PIL they
raise an ``MXNetError`` that names it.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as onp

from .base import MXNetError
from .resilience import faultsim

faultsim.register_point(
    "io.read", "MXRecordIO.read, per record — raise = a torn frame "
    "(resync readers skip to the next magic boundary)")

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "unpack_img", "pack_img"]

_kMagic = 0xCED7230A

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _pad_size(n):
    return ((n + 3) // 4) * 4 - n


class MXRecordIO:
    """Sequential .rec reader/writer (reference MXRecordIO; C++ framing
    dmlc-core src/recordio.cc).

    ``resync=True`` (readers only) arms resync-on-magic: a torn or
    garbled frame no longer raises mid-stream — the reader scans
    forward to the next plausible magic boundary and returns the next
    whole record, reporting each gap via ``on_skip(offset,
    bytes_skipped, reason)``.  The dmlc continuation framing exists
    precisely so this is possible (see :meth:`write`).  Strict mode
    (the default — what write-side verification wants) raises exactly
    as before."""

    def __init__(self, uri, flag, resync=False, on_skip=None):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.is_open = False
        self._resync = bool(resync)
        self.on_skip = on_skip
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag}")
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fp", None)
        d.pop("on_skip", None)  # callbacks don't pickle portably
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.fp = None
        self.on_skip = None
        self._resync = d.get("_resync", False)
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if self.is_open and self.fp is not None:
            self.fp.close()
            self.fp = None
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def _write_part(self, cflag, part):
        lrec = (cflag << 29) | len(part)
        self.fp.write(struct.pack("<II", _kMagic, lrec))
        self.fp.write(part)
        pad = _pad_size(len(part))
        if pad:
            self.fp.write(b"\x00" * pad)

    def write(self, buf):
        """Write one logical record.

        dmlc framing (dmlc-core src/recordio.cc): a payload containing
        the magic bytes is split at each occurrence into continuation
        parts — cflag 1=begin / 2=middle / 3=end, magic dropped from the
        parts and re-inserted by the reader — so the stream stays
        resynchronizable.
        """
        assert self.writable
        magic_bytes = struct.pack("<I", _kMagic)
        parts = []
        start = 0
        i = buf.find(magic_bytes)
        while i != -1:
            parts.append(buf[start:i])
            start = i + 4
            i = buf.find(magic_bytes, start)
        parts.append(buf[start:])
        if len(parts) == 1:
            self._write_part(0, parts[0])
        else:
            for j, part in enumerate(parts):
                cflag = 1 if j == 0 else (3 if j == len(parts) - 1 else 2)
                self._write_part(cflag, part)

    def _read_part(self):
        head = self.fp.read(8)
        if len(head) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", head)
        if magic != _kMagic:
            raise MXNetError("Invalid record magic number")
        cflag = (lrec >> 29) & 0x7
        length = lrec & 0x1FFFFFFF
        buf = self.fp.read(length)
        if len(buf) != length:
            raise MXNetError(
                f"truncated record: expected {length} payload bytes, "
                f"got {len(buf)}")
        pad = _pad_size(length)
        if pad:
            self.fp.read(pad)
        return cflag, buf

    def _read_logical(self, check_first=False):
        cflag, buf = self._read_part()
        if buf is None:
            return None
        if cflag == 0:
            return buf
        if check_first and cflag not in (0, 1):
            # a resync scan can land on a continuation MIDDLE/END part
            # of a chain whose begin frame was lost; reassembling from
            # here would return a silently-truncated record
            raise MXNetError(
                f"record starts with continuation cflag {cflag} "
                "(orphaned multi-part tail)")
        parts = [buf]
        while cflag != 3:
            cflag, nxt = self._read_part()
            if nxt is None:
                raise MXNetError(
                    "truncated multi-part record at end of file")
            parts.append(nxt)
        return struct.pack("<I", _kMagic).join(parts)

    def read(self):
        """Read one logical record, reassembling continuation parts.

        Strict mode (default): any framing damage — bad magic,
        truncated payload, broken continuation chain — raises
        :class:`MXNetError` exactly where it is found.

        Resync mode (``resync=True``): the damage is skipped — scan
        forward to the next plausible frame boundary (magic at a
        4-byte-aligned offset whose header describes a frame that fits
        the file and chains onto another magic or EOF) and return the
        next WHOLE record.  Every gap is reported through
        ``on_skip(offset, bytes_skipped, reason)`` and counted on the
        ``io_resyncs`` telemetry counter; reaching EOF mid-scan
        returns None like a clean end of stream.
        """
        assert not self.writable
        if not self._resync:
            faultsim.inject("io.read")  # an armed raise = a torn frame
            return self._read_logical()
        gap = None  # (start offset, first reason) of the current gap
        while True:
            start = self.fp.tell()
            try:
                faultsim.inject("io.read")
                rec = self._read_logical(check_first=True)
            except (MXNetError, faultsim.FaultInjected) as exc:
                # consecutive failures merge into ONE reported gap —
                # a torn multi-part chain or a long corrupt extent is
                # one region lost, not one skip event per bad frame
                if gap is None:
                    gap = (start, str(exc))
                if self._resync_scan(start + 4) is None:
                    self._report_skip(gap[0],
                                      self._file_size() - gap[0],
                                      gap[1])
                    return None
                continue
            if gap is not None:
                self._report_skip(gap[0], start - gap[0], gap[1])
            return rec

    def _file_size(self):
        return os.fstat(self.fp.fileno()).st_size

    def _report_skip(self, offset, nbytes, reason):
        try:
            from . import telemetry

            telemetry.count("io_resyncs")
            telemetry.event("io_resync", file=self.uri,
                            offset=int(offset),
                            bytes_skipped=int(nbytes), reason=reason)
        except Exception:
            pass  # telemetry must never break the read path
        if self.on_skip is not None:
            self.on_skip(int(offset), int(nbytes), reason)

    def _plausible_frame(self, pos, size):
        """Whether a frame starting at ``pos`` could be real: magic,
        sane cflag, a length that fits the file, and the frame's end
        landing on EOF or another magic (payloads can contain stray
        magic-looking bytes — chaining to the NEXT boundary rejects
        them)."""
        here = self.fp.tell()
        try:
            self.fp.seek(pos)
            head = self.fp.read(8)
            if len(head) < 8:
                return False
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                return False
            length = lrec & 0x1FFFFFFF
            end = pos + 8 + length + _pad_size(length)
            if end > size:
                return False
            if end == size:
                return True
            self.fp.seek(end)
            nxt = self.fp.read(4)
            return len(nxt) == 4 and \
                struct.unpack("<I", nxt)[0] == _kMagic
        finally:
            self.fp.seek(here)

    def _resync_scan(self, from_pos):
        """Scan forward from ``from_pos`` for the next plausible frame
        boundary (frames are 4-byte aligned by the writer's padding);
        position the fp there and return the offset, or None (fp at
        EOF) when no further record exists."""
        size = self._file_size()
        magic_bytes = struct.pack("<I", _kMagic)
        pos = max(0, int(from_pos))
        pos += (-pos) % 4  # align up
        chunk = 1 << 16
        while pos < size:
            self.fp.seek(pos)
            buf = self.fp.read(chunk + 8)
            i = buf.find(magic_bytes)
            while i != -1:
                cand = pos + i
                if cand % 4 == 0 and cand + 8 <= size \
                        and self._plausible_frame(cand, size):
                    self.fp.seek(cand)
                    return cand
                i = buf.find(magic_bytes, i + 1)
            pos += chunk
        self.fp.seek(size)
        return None

    def tell(self):
        return self.fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via a .idx sidecar (reference MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self.fp.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack an IRHeader + byte string (reference recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = onp.asarray(header.label, dtype=onp.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                    header.id2) + s
    return s


def unpack(s):
    """Unpack to (IRHeader, payload bytes) (reference recordio.py unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=onp.frombuffer(s, onp.float32, header.flag))
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack a packed image record to (header, BGR ndarray), as the
    reference's cv2 convention orders channels."""
    header, s = unpack(s)
    img = _imdecode(onp.frombuffer(s, dtype=onp.uint8), iscolor)
    return header, img


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError(
            "image encode/decode needs PIL (Pillow), which is not "
            "installed; pack pre-encoded bytes with pack() instead"
        ) from None
    return Image


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode a BGR image array (the cv2 convention) with PIL and pack
    it (reference recordio.py pack_img)."""
    import io as _io

    Image = _pil()
    arr = onp.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[..., ::-1]  # BGR -> RGB
    elif arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}.get(
        img_fmt.lower())
    if fmt is None:
        raise MXNetError(f"pack_img: unsupported format {img_fmt!r}")
    buf = _io.BytesIO()
    kw = {"quality": int(quality)} if fmt == "JPEG" else {}
    Image.fromarray(onp.ascontiguousarray(arr.astype(onp.uint8))).save(
        buf, format=fmt, **kw)
    return pack(header, buf.getvalue())


def _imdecode(buf, iscolor=-1):
    import io as _io

    Image = _pil()
    img = Image.open(_io.BytesIO(buf.tobytes()))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor > 0:
        img = img.convert("RGB")
    img = onp.asarray(img)
    if img.ndim == 3:
        img = img[..., ::-1]  # RGB -> BGR to match cv2 convention
    return img
