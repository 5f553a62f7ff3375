"""ImageRecordIter: the record -> decode -> augment -> batch pipeline
(counterpart of ``mxnet_tpu/io/image_record_iter.py``).

Reference parity: src/io/iter_image_recordio_2.cc:880 (ImageRecordIter2)
and its ``mx.io.ImageRecordIter`` keyword surface.

The ``.rec`` file is memory-mapped and framed once (the native parser,
or the resync reader).  Each batch's records, augmentation draws and
labels follow an index plan fixed per epoch; batches are made by a
producer thread, or by a pool of worker threads behind a
sequence-ordered emitter (``io_workers``), ``prefetch_buffer`` ahead of
the consumer.

Where a batch is decoded depends on its target, ``ctx`` (default: the
current context with the device feed on, ``MXNET_DEVICE_FEED``, else
the host):

* **on the card** (a CUDA target): the JPEG bytes go to nvJPEG
  (``io/nvjpeg.py``: a header pass, one batched decode), the hand-written
  kernel ``csrc/image_augment.cu`` (``ops/image_augment.py``) resizes,
  crops, mirrors and normalises the whole batch in one launch, and the
  colour jitter, where asked for, runs after it on the card.  All of it
  is queued on the feed's side stream in the worker; the consumer's
  stream waits on an event.  The host touches no pixel.  Without nvJPEG
  the iterator raises at construction: it never decodes on the host in
  silence.
* **on the host**: the native library (``_native``, libjpeg; the same
  code as the reference's) decodes and augments into NCHW float32
  batches, equal to the reference's bit for bit; without it, PIL decodes
  and ``image_augment_plain`` augments.

The fault-tolerant data plane is the reference's: a record that fails
framing, unpack or decode is quarantined (counted on
``data_records_skipped``, named by file, parsed-stream ordinal, byte
offset and reason in an atomically rewritten manifest, a ``data`` run-log
record) and dropped from every later batch, up to the
``MXNET_IO_MAX_SKIP_FRAC`` ceiling; a pool worker that dies holding a
batch (the ``io.worker`` fault point) or wedges past the per-batch
deadline has its batch re-dispatched and is replaced under the
``MXNET_IO_WORKER_RESPAWN`` budget; batches are assembled by index plan,
so worker count, respawns and stragglers never change the sample
stream.
"""
from __future__ import annotations

import heapq
import json
import mmap
import os
import queue
import threading
import time

import numpy as onp
import torch

from .. import recordio
from ..base import MXNetError
from ..context import cpu, current_context, resolve_device
from ..resilience import faultsim
from ..telemetry import tracing as _tracing
from .device_feed import Ready, side_stream_put
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter"]

faultsim.register_point(
    "io.decode", "record iterator, per record unpack+decode — raise = "
    "one undecodable record (quarantined, never fatal)")
faultsim.register_point(
    "io.worker", "data-plane worker pool, per claimed batch (probe "
    "semantics: crash kills the worker THREAD, not the process)")


class ImageRecordIter(DataIter):
    """mx.io.ImageRecordIter (reference C++ iterator surface).

    Supported kwargs mirror the reference's ImageRecordParam /
    augmenter params: path_imgrec, data_shape, batch_size, shuffle,
    rand_crop, rand_mirror, resize, mean_r/g/b, std_r/g/b,
    preprocess_threads, prefetch_buffer, label_width, round_batch,
    part_index/num_parts (sharding), seed — plus the data plane's
    knobs: io_workers (MXNET_IO_WORKERS), worker_respawn
    (MXNET_IO_WORKER_RESPAWN), max_skip_frac (MXNET_IO_MAX_SKIP_FRAC),
    quarantine_manifest (default ``<path_imgrec>.quarantine.json``)
    and worker_deadline_sec (default: MXNET_WATCHDOG_SEC when armed,
    else 30 s), and ``ctx``, the batches' device (see the module).
    """

    #: label value for all-quarantined placeholder pad rows (the det
    #: subclass overrides with its -1 "no object" convention)
    _label_fill_value = 0.0

    #: ImageNet PCA lighting basis (reference src/io/image_aug_default.cc
    #: — the AlexNet eigen decomposition, 0..255 pixel scale)
    _PCA_EIGVAL = onp.array([55.46, 4.794, 1.148], "float32")
    _PCA_EIGVEC = onp.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]], "float32")

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, resize=-1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0,
                 std_g=1.0, std_b=1.0, preprocess_threads=None,
                 prefetch_buffer=None, label_width=1, round_batch=True,
                 part_index=0, num_parts=1, seed=0, dtype="float32",
                 random_h=0, random_s=0, random_l=0, pca_noise=0.0,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 device_feed=None, io_workers=None, worker_respawn=None,
                 max_skip_frac=None, quarantine_manifest=None,
                 worker_deadline_sec=None, ctx=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (c, h, w)")
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = onp.array([mean_r, mean_g, mean_b], "float32")
        self._std = onp.array([std_r, std_g, std_b], "float32")
        # color-space augmenters (reference image_aug_default.cc:565
        # RandomHueSaturationLight): HSL jitter ranges follow the
        # reference's OpenCV-HLS units (H 0..180, S/L 0..255)
        self._random_h = float(random_h)
        self._random_s = float(random_s)
        self._random_l = float(random_l)
        self._pca_noise = float(pca_noise)
        self._max_contrast = float(max_random_contrast)
        self._max_illumination = float(max_random_illumination)
        self._color_jitter = any((self._random_h, self._random_s,
                                  self._random_l, self._pca_noise,
                                  self._max_contrast,
                                  self._max_illumination))
        from .. import config as _config

        self._threads = (preprocess_threads if preprocess_threads
                         is not None
                         else _config.get_env("MXNET_CPU_WORKER_NTHREADS"))
        self._prefetch = (prefetch_buffer if prefetch_buffer is not None
                          else _config.get_env("MXNET_TPU_PREFETCH_BUFFER"))
        self._round_batch = round_batch
        self._rng = onp.random.RandomState(seed)  # shuffle order only
        self._seed_base = int(seed)
        self._epoch = -1  # first reset() -> epoch 0 (per-batch rng key)
        self._dtype = dtype
        if device_feed is None:
            from .device_feed import device_feed_enabled

            device_feed = device_feed_enabled()
        # the target: with the device feed, the current context's device
        # (read here: contexts are per thread), where the producer makes
        # each batch prefetch_buffer batches ahead of the step
        self._device_feed = bool(device_feed)
        if ctx is None:
            ctx = current_context() if self._device_feed else cpu()
        self._dev = resolve_device(ctx)
        self._on_card = self._dev.type == "cuda"
        if self._on_card:
            from . import nvjpeg

            nvjpeg.require()  # raises naming nvjpeg.h/libnvjpeg
        self._feed_lock = threading.Lock()
        self._feed_stats = {"batches": 0, "consumer_wait_s": 0.0,
                            "producer_busy_s": 0.0, "h2d_bytes": 0}

        # -------- the data plane's knobs --------
        self._io_workers = int(
            io_workers if io_workers is not None
            else _config.get_env("MXNET_IO_WORKERS"))
        self._respawn_budget = int(
            worker_respawn if worker_respawn is not None
            else _config.get_env("MXNET_IO_WORKER_RESPAWN"))
        self._max_skip_frac = float(
            max_skip_frac if max_skip_frac is not None
            else _config.get_env("MXNET_IO_MAX_SKIP_FRAC"))
        if worker_deadline_sec is not None:
            self._worker_deadline = float(worker_deadline_sec)
        else:
            wd = float(_config.get_env("MXNET_WATCHDOG_SEC") or 0.0)
            # the per-batch deadline rides the watchdog heartbeat: a
            # pool wedged longer than the stall detector's period is
            # re-dispatched before the watchdog would dump stacks
            self._worker_deadline = wd if wd > 0 else 30.0
        self._path = os.fspath(path_imgrec)
        self._manifest_path = (os.fspath(quarantine_manifest)
                               if quarantine_manifest is not None
                               else self._path + ".quarantine.json")
        self._qlock = threading.RLock()
        self._quarantined = set()   # indices into self._records
        self._qentries = []         # manifest rows
        self._parse_skips = 0       # framing-level resync EVENTS
        self._parse_skip_bytes = 0  # total bytes the resyncs jumped
        self._respawns = 0         # cumulative spawns (stats, monotonic)
        self._respawn_charges = 0  # budget ledger (refundable: a slow
        #   worker that still DELIVERS hands its charge back)
        self._manifest_warned = False
        self._manifest_dirty = False

        # mmap + frame the record file once (host page cache does the
        # streaming; the reference reads chunks instead)
        self._file = open(path_imgrec, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            from .. import _native

            self._records = None
            if _native.get_lib() is not None:
                try:
                    self._records, self._offsets = \
                        _native.parse_records(self._mm,
                                              return_offsets=True)
                except Exception as exc:
                    # the native parser rejects the whole file on any
                    # framing damage — the resync python parser
                    # recovers every intact record and names the gaps
                    from .. import telemetry

                    telemetry.event(
                        "io_parse_fallback", file=self._path,
                        reason=f"{type(exc).__name__}: {exc}")
                    self._records = None
            if self._records is None:
                self._records = self._parse_python()
            self._rec_ids = list(range(len(self._records)))
            self._parsed_full = len(self._records)  # pre-shard count
            if num_parts > 1:
                self._records = self._records[part_index::num_parts]
                self._offsets = self._offsets[part_index::num_parts]
                self._rec_ids = self._rec_ids[part_index::num_parts]
            if not self._records:
                raise MXNetError(f"no records in {path_imgrec}")
            if not self._qentries \
                    and os.path.exists(self._manifest_path):
                # a repaired/replaced shard must not keep a previous
                # run's quarantine evidence: rewrite truthful (empty)
                self._manifest_dirty = True
            self._flush_manifest()
            self._check_ceiling()
        except BaseException:
            # a loud constructor failure (skip ceiling, unparseable
            # file) must not leak the fd + mapping: the operator loop
            # that catches it and rotates shards would bleed fds
            self._records = None
            try:
                if getattr(self, "_mm", None) is not None:
                    self._mm.close()
            except (BufferError, ValueError):
                pass
            self._file.close()
            raise
        self._order = onp.arange(len(self._records))
        self._queue = None
        self._worker = None
        self._emitter = None
        self._pool_threads = []
        self._pool = None
        self._stop = threading.Event()
        if not getattr(self, "_defer_start", False):
            # subclasses with extra config (ImageDetRecordIter) start
            # the producer themselves once fully constructed
            self.reset()

    def _parse_python(self):
        # pure-python fallback: ONE source of framing truth —
        # MXRecordIO.read with resync-on-magic armed, so a torn frame
        # is a named quarantine entry instead of a dead dataset
        records = []
        offsets = []
        recovered = {"pos": None}

        def on_skip(offset, nbytes, reason):
            # a record returned after a resync gap STARTS at the gap's
            # end, not at the pre-read position — track it so the
            # manifest names the record's true byte offset
            recovered["pos"] = offset + nbytes
            self._note_parse_skip(offset, nbytes, reason)

        reader = recordio.MXRecordIO(self._file.name, "r", resync=True,
                                     on_skip=on_skip)
        try:
            while True:
                recovered["pos"] = None
                pos = reader.tell()
                rec = reader.read()
                if rec is None:
                    break
                records.append(memoryview(rec))
                offsets.append(recovered["pos"]
                               if recovered["pos"] is not None else pos)
        finally:
            reader.close()
        self._offsets = offsets
        return records

    # ------------------------------------------------------- quarantine
    def _note_parse_skip(self, offset, nbytes, reason):
        """One resync gap from the framing reader: count + manifest
        row (record ordinal unknowable — the frame never parsed)."""
        with self._qlock:
            self._parse_skips += 1
            self._parse_skip_bytes += int(nbytes)
            self._manifest_dirty = True
            self._qentries.append({
                "file": self._path, "record": None,
                "offset": int(offset), "bytes_skipped": int(nbytes),
                "stage": "read", "reason": str(reason)[:400]})
        from .. import telemetry

        telemetry.count("data_records_skipped")
        rl = telemetry.current()
        if rl is not None:
            rl.data_plane("quarantine", workers=self._io_workers,
                          file=self._path, stage="read",
                          offset=int(offset))

    def _quarantine(self, j, stage, exc):
        """Quarantine record ``j`` (index into this shard): once per
        record — wrap-fill duplicates and later epochs re-encounter it
        and drop the row silently instead of recounting."""
        with self._qlock:
            if j in self._quarantined:
                return
            self._quarantined.add(j)
            self._manifest_dirty = True
            entry = {"file": self._path, "record": self._rec_ids[j],
                     "offset": self._offsets[j], "stage": stage,
                     "reason": f"{type(exc).__name__}: {exc}"[:400]}
            self._qentries.append(entry)
        from .. import telemetry

        telemetry.count("data_records_skipped")
        rl = telemetry.current()
        if rl is not None:
            rl.data_plane("quarantine", workers=self._io_workers,
                          file=self._path, stage=stage,
                          record=self._rec_ids[j])
        self._check_ceiling()

    def _flush_manifest(self):
        """Atomically rewrite the quarantine manifest — the artifact a
        loud failure (skip ceiling, respawn exhaustion) points the
        operator at.  Rows are sorted so the manifest is byte-stable
        regardless of worker count or arrival order.  DEBOUNCED: skips
        mark it dirty and the flush happens at epoch end, on every
        loud-failure path, and at close() — a heavily corrupt shard
        must not pay one fsync+rename per quarantined record on the
        decode hot path."""
        with self._qlock:
            if not self._manifest_dirty:
                return
            self._manifest_dirty = False
            entries = sorted(
                self._qentries,
                key=lambda e: (e["record"] is None,
                               e["record"] if e["record"] is not None
                               else -1,
                               e["offset"] if e["offset"] is not None
                               else -1))
            doc = {"file": self._path,
                   "records": len(self._records),
                   "skipped": self._parse_skips + len(self._quarantined),
                   # "record" ordinals number the PARSED stream (a
                   # framing gap shifts everything after it); "offset"
                   # is the exact byte position — repair by offset
                   "ordinal_space": "parsed_stream",
                   "entries": entries}
        try:
            from ..resilience.checkpoint import atomic_write_bytes

            atomic_write_bytes(self._manifest_path,
                               json.dumps(doc, indent=1).encode(),
                               inject_point=None)
        except OSError:
            if not self._manifest_warned:
                self._manifest_warned = True
                import logging

                logging.warning(
                    "ImageRecordIter: cannot write quarantine "
                    "manifest %s (skips still counted)",
                    self._manifest_path)

    def _parse_records_lost(self):
        """Estimated RECORDS lost to framing damage: one resync event
        can jump a whole corrupt extent (thousands of records), so the
        ceiling must weigh bytes skipped against the mean record size,
        not count events."""
        if not self._parse_skips:
            return 0
        good_bytes = max(1, len(self._mm) - self._parse_skip_bytes)
        mean = good_bytes / max(1, self._parsed_full)
        est = int(round(self._parse_skip_bytes / max(mean, 1.0)))
        return max(self._parse_skips, est)

    def _check_ceiling(self):
        # parse skips are FILE-level (counted before the num_parts
        # slice) while decode quarantines are SHARD-level — measure
        # each against its own population and bound the sum, so a
        # sharded read cannot overstate corruption by ~num_parts
        with self._qlock:
            lost = self._parse_records_lost()
            skipped = self._parse_skips + len(self._quarantined)
            parse_frac = lost / max(1, self._parsed_full + lost)
            decode_frac = len(self._quarantined) / max(
                1, len(self._records) if self._records else 1)
        frac = parse_frac + decode_frac
        if skipped and frac > self._max_skip_frac:
            self._flush_manifest()  # the error names it: make it fresh
            raise MXNetError(
                f"data quarantine ceiling exceeded: {skipped} records "
                f"skipped (fraction {frac:.3f} > "
                f"MXNET_IO_MAX_SKIP_FRAC={self._max_skip_frac}) — "
                f"refusing to silently train on a shrunken dataset.  "
                f"Quarantine manifest: {self._manifest_path}")

    def data_plane_stats(self):
        """Snapshot of the data plane's counters for this
        iterator: records in the shard, cumulative skips (framing
        resyncs + decode quarantines), worker respawns, pool size and
        the manifest path."""
        with self._qlock:
            return {"workers": self._io_workers,
                    "records": len(self._records),
                    "skipped": self._parse_skips + len(self._quarantined),
                    "parse_skips": self._parse_skips,
                    "quarantined": len(self._quarantined),
                    "respawns": self._respawns,
                    "manifest": self._manifest_path}

    # ----------------------------------------------------------- pipeline
    def _batch_rng(self, seq):
        """Per-batch RandomState keyed on (seed, epoch, batch seq) so
        augmentation draws are a pure function of the index plan —
        identical at any worker count, after any respawn, and on a
        re-dispatched batch.  Seeded with the TUPLE (array-seed form),
        so distinct (epoch, seq) pairs can never collide the way an
        arithmetic mix would past 8191 batches/epoch."""
        return onp.random.RandomState(
            [self._seed_base & 0xFFFFFFFF,
             self._epoch & 0xFFFFFFFF, int(seq) & 0xFFFFFFFF])

    def _build_plan(self):
        """The epoch's index plan: batch ``seq`` always covers the same
        order rows, quarantines notwithstanding — the determinism
        contract batches, cursors and host re-slices all lean on."""
        bs = self.batch_size
        order = self._order
        n = len(order)
        plan = []
        i = 0
        seq = 0
        while i < n:
            take = min(bs, n - i)
            idx = order[i:i + take]
            i += take
            pad = bs - take
            if pad and self._round_batch:
                # wrap around to fill, report pad; onp.resize cycles
                # when the dataset/shard is smaller than a batch
                idx = onp.concatenate([idx, onp.resize(order, pad)])
            # round_batch=False: final batch is genuinely smaller
            plan.append((seq, idx, take))
            seq += 1
        return plan

    @staticmethod
    def _put(q, stop, item):
        """Stop-aware bounded put: a producer blocked against a consumer
        that stopped draining (abandoned iterator) exits within one
        timeout of ``close()``/``reset()`` instead of leaking a thread
        wedged in ``queue.put`` forever.  Delegates to the ONE
        shutdown-critical loop (``device_feed._q_put``) so the two
        pipelines cannot drift.  ``q``/``stop`` are the THREAD'S OWN
        epoch's objects — an abandoned thread from a previous reset can
        never touch the new epoch's queue."""
        from .device_feed import _q_put

        return _q_put(q, stop, item)

    def _producer(self, q, stop, plan):
        try:
            self._producer_impl(q, stop, plan)
        except Exception as exc:  # surface in next(), don't hang it
            self._flush_manifest()
            if not stop.is_set():
                self._put(q, stop, ("error", exc))

    def _produce_one(self, seq, idx, take):
        """One planned batch: ``(batch, labels, pad)`` on the host, or a
        :class:`Ready` device batch made on the feed's side stream."""
        t0 = time.perf_counter()
        if self._on_card:
            out = side_stream_put(
                lambda: self._emit(*self._assemble(seq, idx, take)),
                self._dev)
        else:
            out = self._assemble(seq, idx, take)
        with self._feed_lock:
            self._feed_stats["producer_busy_s"] += time.perf_counter() - t0
        return out

    def _queue_item(self, payload):
        return ("ready", payload) if isinstance(payload, Ready) \
            else payload

    def _producer_impl(self, q, stop, plan):
        for seq, idx, take in plan:
            if stop.is_set():
                return
            payload = self._produce_one(seq, idx, take)
            if stop.is_set():
                return
            if not self._put(q, stop, self._queue_item(payload)):
                return
        self._flush_manifest()  # epoch end: debounced quarantine rows
        self._put(q, stop, None)

    def _assemble(self, seq, idx, n_real):
        """Decode+augment one planned index batch.  Quarantined rows
        compact out; the tail refills by repeating the last survivor so
        the batch shape stays static (no retrace), and every refilled
        or surviving-wrap row is accounted as pad.  Returns
        ``(batch, labels, pad)``."""
        batch, labels, kept = self._make_batch(idx, self._batch_rng(seq))
        want = len(idx)
        n_ok = len(kept)
        real_ok = sum(1 for k in kept if k < n_real)
        if n_ok < want:
            card = isinstance(batch, torch.Tensor)
            if n_ok:
                fill_b, fill_l = batch[-1:], labels[-1:]
            elif card:
                fill_b = torch.zeros((1,) + tuple(batch.shape[1:]),
                                     dtype=batch.dtype,
                                     device=batch.device)
            else:  # every row quarantined: an all-pad placeholder batch
                fill_b = onp.zeros((1,) + tuple(batch.shape[1:]),
                                   batch.dtype)
            if not n_ok:
                fill_l = onp.full((1,) + tuple(labels.shape[1:]),
                                  self._label_fill_value, labels.dtype)
            reps = want - n_ok
            cat = torch.cat if card else onp.concatenate
            batch = cat([batch] + [fill_b] * reps)
            labels = onp.concatenate([labels] + [fill_l] * reps)
        return batch, labels, want - real_ok

    def _emit(self, batch, labels, pad):
        """A batch -> ``DataBatch`` of NDArrays on the target: host
        arrays on the host; on the card the batch is already there (the
        worker runs this on the feed's side stream) and only the labels
        cross."""
        from .. import ndarray as nd

        lab = labels[:, 0] if (self.label_width == 1
                               and labels.ndim == 2) else labels
        if not isinstance(batch, torch.Tensor):
            data = nd.array(batch.astype(self._dtype)
                            if self._dtype != "float32" else batch,
                            ctx=cpu(), dtype=self._dtype)
            return DataBatch(data=[data], label=[nd.array(lab, ctx=cpu())],
                             pad=pad)
        from .device_feed import _put_tensor

        lab_t = _put_tensor(torch.from_numpy(
            onp.ascontiguousarray(lab, onp.float32)), self._dev)
        with self._feed_lock:
            self._feed_stats["h2d_bytes"] += int(lab_t.numel()) * 4
        from ..dtype import normalize_dtype

        data = nd.NDArray(batch if self._dtype == "float32"
                          else batch.to(normalize_dtype(self._dtype)))
        return DataBatch(data=[data], label=[nd.NDArray(lab_t)], pad=pad)

    def _load_record(self, j):
        """Unpack record ``j`` with quarantine: (header, payload), or
        None when the record is (or just became) quarantined."""
        from ..resilience import faultsim

        recs = self._records
        if recs is None:
            # the iterator was closed under an abandoned (join-timed-
            # out) worker: abort the batch, never fabricate quarantine
            # rows from a torn-down object
            raise MXNetError("ImageRecordIter is closed")
        with self._qlock:
            if j in self._quarantined:
                return None
        try:
            faultsim.inject("io.decode")
            return recordio.unpack(bytes(recs[j]))
        except Exception as exc:
            self._quarantine(j, "unpack", exc)
            return None

    def _draw_aug(self, n, rng):
        """Draw EVERY augmentation parameter for all ``n`` PLANNED
        rows up front — draws are indexed by plan position, so the
        quarantine set's state at assembly time (which varies with
        assembly order, resumes and re-dispatches) can never shift the
        crop/mirror/jitter of a surviving row."""
        d = {"crop_x": (rng.rand(n).astype("float32") if self._rand_crop
                        else onp.full(n, 0.5, "float32")),
             "crop_y": (rng.rand(n).astype("float32") if self._rand_crop
                        else onp.full(n, 0.5, "float32")),
             "mirror": ((rng.rand(n) < 0.5).astype("uint8")
                        if self._rand_mirror
                        else onp.zeros(n, "uint8"))}
        if self._max_contrast > 0:
            d["contrast"] = (1.0 + rng.uniform(
                -self._max_contrast, self._max_contrast, n)) \
                .astype("float32")
        if self._max_illumination > 0:
            d["illum"] = rng.uniform(-self._max_illumination,
                                     self._max_illumination, n) \
                .astype("float32")
        if self._random_h:
            d["dh"] = rng.uniform(-self._random_h, self._random_h, n)
        if self._random_s:
            d["ds"] = rng.uniform(-self._random_s, self._random_s, n)
        if self._random_l:
            d["dl"] = rng.uniform(-self._random_l, self._random_l, n)
        if self._pca_noise > 0:
            d["pca"] = rng.normal(0.0, self._pca_noise, (n, 3)) \
                .astype("float32")
        return d

    def _make_batch(self, idx, rng):
        """Decode+augment one index batch with per-record quarantine;
        returns compacted ``(batch, labels, kept_positions)`` where
        ``kept_positions`` are the surviving positions within ``idx``
        (plan order preserved).  Subclasses override for different
        label/augment semantics (ImageDetRecordIter)."""
        c, h, w = self.data_shape
        draws = self._draw_aug(len(idx), rng)
        jpegs, labs, kept = [], [], []
        for pos, j in enumerate(idx):
            payload = self._load_record(int(j))
            if payload is None:
                continue
            header, img = payload
            lab = onp.atleast_1d(onp.asarray(header.label, "float32"))
            jpegs.append(img)
            labs.append(lab[:self.label_width])
            kept.append(pos)
        rec_ids = [int(idx[k]) for k in kept]
        sel = onp.asarray(kept, dtype=int)
        sub = {k: v[sel] for k, v in draws.items()}
        batch, ok = self._decode_batch(jpegs, h, w, sub, rec_ids)
        labs = [la for la, o in zip(labs, ok) if o]
        kept = [k for k, o in zip(kept, ok) if o]
        lab_arr = onp.zeros((len(kept), self.label_width), "float32")
        for kk, lab in enumerate(labs):
            lab_arr[kk, :len(lab)] = lab
        return batch, lab_arr, kept

    def _decode_native(self, jpegs, h, w, crop_x, crop_y, mirror,
                       draws):
        from .. import _native

        if self._color_jitter:
            # decode raw 0..255 (native normalization off), jitter
            # in color space, then normalize here — the reference
            # default-aug chain orders it the same way
            # (image_aug_default.cc: hsl/pca before mean subtract)
            raw, failed = _native.decode_augment_batch(
                jpegs, h, w,
                mean=onp.zeros(3, "float32"),
                std=onp.ones(3, "float32"),
                crop_x=crop_x, crop_y=crop_y, mirror=mirror,
                resize_short=self._resize,
                num_threads=self._threads)
            if failed:
                # fall back to the per-image path: a silently-zeroed
                # row must become a NAMED quarantine entry instead
                raise MXNetError(
                    f"native decode failed {failed} record(s)")
            raw = self._apply_color_jitter(raw, draws)
            return ((raw - self._mean[None, :, None, None])
                    / self._std[None, :, None, None])
        batch, failed = _native.decode_augment_batch(
            jpegs, h, w, mean=self._mean, std=self._std,
            crop_x=crop_x, crop_y=crop_y, mirror=mirror,
            resize_short=self._resize, num_threads=self._threads)
        if failed:
            raise MXNetError(
                f"native decode failed {failed} record(s)")
        return batch

    def _decode_one(self, jpeg, h, w, crop_x, crop_y, mirror,
                    native=True):
        """One image off the batched native path; normalisation applies
        here unless colour jitter defers it.  Beside the native library
        (a batch it failed) this is the reference's PIL chain, so the
        surviving rows equal the reference's; without the library PIL
        decodes and the plain augment (the library's arithmetic) does
        the rest."""
        from .. import image as img_mod

        jit = self._color_jitter
        if not native:
            from ..ops.image_augment import image_augment_plain

            im = img_mod.imdecode(jpeg)._data.contiguous()
            zero, one = onp.zeros(3, "float32"), onp.ones(3, "float32")
            out = image_augment_plain(
                im.reshape(-1), [0], [im.shape[0]], [im.shape[1]], h, w,
                [crop_x], [crop_y], [mirror],
                zero if jit else self._mean, one if jit else self._std,
                self._resize)
            return out[0].numpy()
        im = img_mod.imdecode(jpeg)
        if self._resize > 0:
            im = img_mod.resize_short(im, self._resize)
        ih, iw = im.shape[:2]
        if ih >= h and iw >= w:
            x0 = int(crop_x * (iw - w))
            y0 = int(crop_y * (ih - h))
            im = img_mod.fixed_crop(im, x0, y0, w, h)
        else:
            im = img_mod.imresize(im, w, h)
        arr = im.asnumpy().astype("float32")
        if mirror:
            arr = arr[:, ::-1]
        if not jit:
            arr = (arr - self._mean) / self._std
        return arr.transpose(2, 0, 1)

    def _decode_card(self, jpegs, h, w, draws, rec_ids):
        """nvJPEG and the augment kernel, on the current (side) stream:
        ``(batch, ok)`` with the batch on the card, compacted to the
        images that decoded; the others are quarantined by record id."""
        from ..ops.image_augment import image_augment
        from . import nvjpeg

        with self._feed_lock:
            self._feed_stats["h2d_bytes"] += sum(len(j) for j in jpegs)
        buf, offs, hs, ws, bad, kept = nvjpeg.decode_batch(jpegs,
                                                           self._dev)
        for pos, reason in bad:
            self._quarantine(rec_ids[pos], "decode", MXNetError(reason))
        ok = onp.zeros(len(jpegs), bool)
        ok[kept] = True
        sub = {k: v[kept] for k, v in draws.items()}
        jit = self._color_jitter
        zero, one = onp.zeros(3, "float32"), onp.ones(3, "float32")
        batch = image_augment(
            buf, offs, hs, ws, h, w, sub["crop_x"], sub["crop_y"],
            sub["mirror"], zero if jit else self._mean,
            one if jit else self._std, self._resize)
        if jit:
            # after the kernel, on the card, as the reference orders it
            batch = self._jitter_torch(batch, sub)
            m = torch.as_tensor(self._mean, device=batch.device)
            sd = torch.as_tensor(self._std, device=batch.device)
            batch = (batch - m[None, :, None, None]) \
                / sd[None, :, None, None]
        return batch, ok

    def _decode_batch(self, jpegs, h, w, draws, rec_ids):
        """Decode+augment; returns ``(batch, ok_mask)`` with the batch
        compacted to the rows that decoded — a row that fails to decode
        is quarantined (named by ``rec_ids``) rather than raised through
        the pipeline.  ``draws`` carries the per-row augmentation
        parameters (already position-aligned by the caller)."""
        from .. import _native

        nimg = len(jpegs)
        crop_x, crop_y = draws["crop_x"], draws["crop_y"]
        mirror = draws["mirror"]
        if self._on_card:
            return self._decode_card(jpegs, h, w, draws, rec_ids)
        native = _native.get_lib() is not None
        if nimg and native:
            try:
                return (self._decode_native(jpegs, h, w, crop_x,
                                            crop_y, mirror, draws),
                        onp.ones(nimg, bool))
            except Exception as exc:
                # the per-image path below names the bad record — but
                # say so: a systemic native failure falling back every
                # batch would be a large invisible slowdown
                from .. import telemetry

                telemetry.event(
                    "io_decode_fallback", records=nimg,
                    reason=f"{type(exc).__name__}: {exc}"[:200])
        out = onp.zeros((nimg, 3, h, w), "float32")
        ok = onp.zeros(nimg, bool)
        for k in range(nimg):
            try:
                out[k] = self._decode_one(jpegs[k], h, w,
                                          float(crop_x[k]),
                                          float(crop_y[k]),
                                          bool(mirror[k]), native)
                ok[k] = True
            except Exception as exc:
                self._quarantine(rec_ids[k], "decode", exc)
        out = out[ok]
        if self._color_jitter:
            sub = {k: v[ok] for k, v in draws.items()}
            out = self._apply_color_jitter(out, sub)
            out = ((out - self._mean[None, :, None, None])
                   / self._std[None, :, None, None])
        return out, ok

    # ------------------------------------------- color-space augmenters
    @staticmethod
    def _rgb_to_hsl(rgb):
        """Vectorized RGB(0..1) -> (H deg 0..360, S 0..1, L 0..1)."""
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = onp.max(rgb, axis=-1)
        minc = onp.min(rgb, axis=-1)
        delta = maxc - minc
        lum = (maxc + minc) / 2.0
        denom = 1.0 - onp.abs(2.0 * lum - 1.0)
        sat = onp.where(delta > 0, delta / onp.maximum(denom, 1e-12), 0.0)
        safe = onp.maximum(delta, 1e-12)
        hr = onp.where(maxc == r, ((g - b) / safe) % 6.0, 0.0)
        hg = onp.where(maxc == g, (b - r) / safe + 2.0, 0.0)
        hb = onp.where(maxc == b, (r - g) / safe + 4.0, 0.0)
        # priority r > g > b on ties, like colorsys
        hue = onp.where(maxc == r, hr, onp.where(maxc == g, hg, hb))
        hue = onp.where(delta > 0, hue * 60.0, 0.0)
        return hue, sat, lum

    @staticmethod
    def _hsl_to_rgb(hue, sat, lum):
        c = (1.0 - onp.abs(2.0 * lum - 1.0)) * sat
        hp = (hue % 360.0) / 60.0
        x = c * (1.0 - onp.abs(hp % 2.0 - 1.0))
        z = onp.zeros_like(c)
        conds = [(hp < 1), (hp < 2), (hp < 3), (hp < 4), (hp < 5)]
        r = onp.select(conds, [c, x, z, z, x], c)
        g = onp.select(conds, [x, c, c, x, z], z)
        b = onp.select(conds, [z, z, x, c, c], x)
        m = lum - c / 2.0
        return onp.stack([r + m, g + m, b + m], axis=-1)

    def _apply_color_jitter(self, batch, draws):
        """contrast -> illumination -> HSL jitter -> PCA noise on a raw
        (N, 3, H, W) 0..255 batch (reference image_aug_default.cc
        DefaultImageAugmenter order; HSL ranges in OpenCV-HLS units:
        H 0..180 half-degrees, S/L 0..255).  The per-row parameters
        come pre-drawn in ``draws`` (plan-position aligned)."""
        if "contrast" in draws:
            batch = batch * draws["contrast"][:, None, None, None]
        if "illum" in draws:
            batch = batch + draws["illum"][:, None, None, None]
        if self._random_h or self._random_s or self._random_l:
            img = onp.clip(batch, 0, 255).transpose(0, 2, 3, 1) / 255.0
            hue, sat, lum = self._rgb_to_hsl(img)
            if "dh" in draws:
                hue = hue + 2.0 * draws["dh"][:, None, None]  # ->deg
            if "ds" in draws:
                sat = onp.clip(sat + draws["ds"][:, None, None]
                               / 255.0, 0.0, 1.0)
            if "dl" in draws:
                lum = onp.clip(lum + draws["dl"][:, None, None]
                               / 255.0, 0.0, 1.0)
            batch = (self._hsl_to_rgb(hue, sat, lum) * 255.0) \
                .transpose(0, 3, 1, 2).astype("float32")
        if "pca" in draws:
            shift = (draws["pca"] * self._PCA_EIGVAL) \
                @ self._PCA_EIGVEC.T
            batch = batch + shift[:, :, None, None]
        return onp.clip(batch, 0.0, 255.0)

    def _jitter_torch(self, batch, draws):
        """:meth:`_apply_color_jitter` on a batch on the card, in float32
        (the same order: contrast, illumination, HSL, PCA noise, clip)."""
        dev = batch.device

        def col(key):
            return torch.as_tensor(onp.asarray(draws[key], "float32"),
                                   device=dev)

        if "contrast" in draws:
            batch = batch * col("contrast")[:, None, None, None]
        if "illum" in draws:
            batch = batch + col("illum")[:, None, None, None]
        if self._random_h or self._random_s or self._random_l:
            img = batch.clamp(0, 255).permute(0, 2, 3, 1) / 255.0
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
            maxc = img.amax(-1)
            minc = img.amin(-1)
            delta = maxc - minc
            lum = (maxc + minc) / 2.0
            denom = 1.0 - (2.0 * lum - 1.0).abs()
            sat = torch.where(delta > 0,
                              delta / denom.clamp_min(1e-12),
                              torch.zeros_like(delta))
            safe = delta.clamp_min(1e-12)
            hr = torch.remainder((g - b) / safe, 6.0)
            hg = (b - r) / safe + 2.0
            hb = (r - g) / safe + 4.0
            hue = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
            hue = torch.where(delta > 0, hue * 60.0, torch.zeros_like(hue))
            if "dh" in draws:
                hue = hue + 2.0 * col("dh")[:, None, None]
            if "ds" in draws:
                sat = (sat + col("ds")[:, None, None] / 255.0).clamp(0, 1)
            if "dl" in draws:
                lum = (lum + col("dl")[:, None, None] / 255.0).clamp(0, 1)
            c = (1.0 - (2.0 * lum - 1.0).abs()) * sat
            hp = torch.remainder(hue, 360.0) / 60.0
            x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
            z = torch.zeros_like(c)
            sector = hp.clamp(0, 5.999).to(torch.int64)
            table = torch.stack([
                torch.stack([c, x, z], -1), torch.stack([x, c, z], -1),
                torch.stack([z, c, x], -1), torch.stack([z, x, c], -1),
                torch.stack([x, z, c], -1), torch.stack([c, z, x], -1)])
            rgb = torch.gather(table, 0, sector[None, ..., None].expand(
                1, *sector.shape, 3))[0]
            batch = ((rgb + (lum - c / 2.0)[..., None]) * 255.0) \
                .permute(0, 3, 1, 2)
        if "pca" in draws:
            shift = (col("pca") * torch.from_numpy(self._PCA_EIGVAL)
                     .to(dev)) @ torch.from_numpy(self._PCA_EIGVEC).to(dev).T
            batch = batch + shift[:, :, None, None]
        return batch.clamp(0.0, 255.0).contiguous()

    # --------------------------------------------------- worker pool
    def _start_pool(self, q, stop, plan):
        cv = threading.Condition()
        # bounded working state: "todo" is a heap of pending seqs,
        # "running" holds only in-flight claims (<= workers + a few
        # re-dispatches), and "plan" entries are pruned once emitted —
        # per-claim cost stays O(log batches), not O(batches)
        state = {"plan": {seq: (idx, take) for seq, idx, take in plan},
                 "todo": [seq for seq, _, _ in plan],
                 "running": {}, "results": {}, "next_emit": 0,
                 "poisoned": set(), "buried": set(), "charged": set(),
                 "aborts": {}, "fatal": None, "finished": False,
                 "last_progress": time.monotonic(),
                 "window": max(self._prefetch, 2 * self._io_workers)}
        heapq.heapify(state["todo"])
        self._pool = (state, cv)
        self._pool_threads = []
        for _ in range(self._io_workers):
            self._spawn_worker(state, cv, stop)
        self._emitter = threading.Thread(
            target=self._pool_emitter,
            args=(state, cv, stop, q, plan,
                  _tracing.current_context()),
            name="ImageRecordIter-emitter", daemon=True)
        self._emitter.start()

    def _spawn_worker(self, state, cv, stop):
        # data workers are THREADS: trace context propagates by
        # capture-at-spawn (tracing's stack is thread-local), not by
        # env stamp — a respawned worker inherits the respawner's
        # context so its records stay on the fit's causal timeline
        t = threading.Thread(target=self._pool_worker,
                             args=(state, cv, stop,
                                   _tracing.current_context()),
                             name="ImageRecordIter-worker", daemon=True)
        self._pool_threads.append(t)
        t.start()
        return t

    def _pool_worker(self, state, cv, stop, trace_ctx=None):
        from ..resilience import faultsim

        if trace_ctx is not None:
            # thread-lifetime bind: the TLS stack dies with the thread
            _tracing.use(trace_ctx).__enter__()
        me = threading.current_thread()
        while not stop.is_set():
            with cv:
                if state["finished"] or me in state["poisoned"]:
                    return
                seq = None
                if state["todo"] and state["todo"][0] \
                        < state["next_emit"] + state["window"]:
                    seq = heapq.heappop(state["todo"])
                    task = state["plan"].get(seq)
                    if task is None:  # stale re-dispatch of an
                        continue      # already-emitted batch
                    state["running"][seq] = {
                        "worker": me, "claimed_at": time.monotonic()}
                if seq is None:
                    cv.wait(0.1)
                    continue
            idx, take = task
            # probe, not inject: an io.worker 'crash' must kill THIS
            # worker (the SIGKILL analog the pool survives), never the
            # training process; 'delay' (slept inside probe) is the
            # straggler the per-batch deadline re-dispatches around
            act = faultsim.probe("io.worker")
            if act == "crash":
                return  # sudden death, batch held — emitter detects
            if act == "raise":
                # one aborted claim, absorbed: hand the batch back —
                # but BOUNDED per batch, or an open-ended raise spec
                # (io.worker:raise@1+) would re-dispatch forever and
                # hang the consumer instead of failing loudly
                with cv:
                    ent = state["running"].get(seq)
                    if ent is not None and ent["worker"] is me:
                        state["running"].pop(seq)
                        n_ab = state["aborts"].get(seq, 0) + 1
                        state["aborts"][seq] = n_ab
                        if n_ab > self._respawn_budget + 2:
                            state["results"].setdefault(
                                seq, ("fatal", MXNetError(
                                    f"io worker claim for batch {seq} "
                                    f"aborted {n_ab} times — refusing "
                                    f"to spin.  Quarantine manifest: "
                                    f"{self._manifest_path}")))
                        else:
                            heapq.heappush(state["todo"], seq)
                    cv.notify_all()
                continue
            try:
                payload = self._produce_one(seq, idx, take)
                item = ("ok", payload)
            except Exception as exc:
                item = ("fatal", exc)
            recovered = False
            with cv:
                # first result wins: a re-dispatched twin computes the
                # identical payload, so dropping the loser is lossless
                # (a twin of an ALREADY-emitted seq is discarded — the
                # results dict must not accumulate dead entries)
                accepted = False
                if seq >= state["next_emit"]:
                    stored = state["results"].setdefault(seq, item)
                    accepted = stored is item
                    if accepted:
                        state["last_progress"] = time.monotonic()
                ent = state["running"].get(seq)
                if ent is not None and ent["worker"] is me:
                    state["running"].pop(seq)
                if accepted and me in state["poisoned"]:
                    # it delivered: slow, not dead — refund the
                    # replacement charge so a healthy-but-slow
                    # pipeline can never burn the death budget; rejoin
                    # the pool ONLY if it is below its configured size
                    # (the replacement otherwise carries on and this
                    # worker retires — the pool must not grow)
                    if me in state["charged"]:
                        state["charged"].discard(me)
                        self._respawn_charges = max(
                            0, self._respawn_charges - 1)
                    others = sum(
                        1 for t in self._pool_threads
                        if t.is_alive() and t is not me
                        and t not in state["poisoned"])
                    if others < self._io_workers:
                        state["poisoned"].discard(me)
                    recovered = True
                cv.notify_all()
            if recovered:
                from .. import telemetry

                telemetry.event("io_worker_recovered", seq=int(seq),
                                worker=me.name)

    def _police_pool(self, state, cv, stop):
        """Called under ``cv`` by the emitter: detect dead or wedged
        workers, re-dispatch the batches they hold, and respawn under
        the MXNET_IO_WORKER_RESPAWN budget.  Budget exhaustion is a
        loud structured failure carrying the quarantine manifest."""
        now = time.monotonic()
        needs_respawn = 0
        for seq in list(state["running"]):
            ent = state["running"][seq]
            w = ent["worker"]
            dead = not w.is_alive()
            wedged = now - ent["claimed_at"] > self._worker_deadline
            if not dead and not wedged:
                continue
            state["running"].pop(seq)
            if seq < state["next_emit"] or seq in state["results"]:
                # its batch is already covered (emitted, or a twin
                # delivered): nothing is lost, so a merely-slow worker
                # here must not be poisoned or charged — only reap the
                # stale claim (a DEAD one still counts: it can never
                # claim again, so the pool genuinely shrank)
                if dead and w not in state["buried"]:
                    state["buried"].add(w)
                    needs_respawn += 1
                continue
            heapq.heappush(state["todo"], seq)
            if dead:
                if w not in state["buried"]:
                    state["buried"].add(w)
                    needs_respawn += 1
            else:
                # wedged but alive: poison it (no new claims; a late
                # result is still accepted first-wins, un-poisoning it
                # and refunding the charge) and replace it
                if w not in state["poisoned"]:
                    state["poisoned"].add(w)
                    state["charged"].add(w)
                    needs_respawn += 1
            from .. import telemetry

            telemetry.event("io_worker_lost", seq=int(seq),
                            dead=bool(dead),
                            worker=getattr(w, "name", None))
        # all workers gone with work left: also a respawn case (covers
        # a crash wave that emptied the pool between claims)
        alive = [t for t in self._pool_threads
                 if t.is_alive() and t not in state["poisoned"]]
        work_left = bool(state["todo"]) or bool(state["running"])
        if not alive and work_left and not needs_respawn:
            needs_respawn = 1
        # never grow the pool past its configured size: with enough
        # healthy workers left, the re-dispatch alone is the recovery
        needs_respawn = min(needs_respawn,
                            max(0, self._io_workers - len(alive)))
        for _ in range(needs_respawn):
            if self._respawn_charges >= self._respawn_budget:
                # soft exhaustion first: poisoned-but-alive workers
                # may still DELIVER (slow is not dead — an accepted
                # late result refunds its charge).  Fatal only when
                # nothing is alive, or nothing has progressed for a
                # full stall window — bounded, never a hang
                alive_any = any(t.is_alive()
                                for t in self._pool_threads)
                stall = time.monotonic() - state["last_progress"]
                grace = max(2.0 * self._worker_deadline, 1.0)
                if alive_any and stall <= grace:
                    return  # hold: a late delivery may free budget
                self._flush_manifest()  # the error names it
                state["fatal"] = MXNetError(
                    f"io worker respawn budget exhausted "
                    f"({self._respawn_budget}) with no pool progress "
                    f"for {stall:.1f}s — the decode pool keeps dying "
                    f"or is wedged; refusing to continue.  Quarantine "
                    f"manifest: {self._manifest_path}")
                cv.notify_all()
                return
            self._respawns += 1
            self._respawn_charges += 1
            self._spawn_worker(state, cv, stop)
            from .. import telemetry

            telemetry.count("io_worker_respawns")
            rl = telemetry.current()
            if rl is not None:
                rl.data_plane("respawn", workers=self._io_workers,
                              respawn=self._respawns,
                              budget=self._respawn_budget)

    def _pool_emitter(self, state, cv, stop, q, plan, trace_ctx=None):
        """Emit results strictly in plan order (sequence-ordered batch
        assembly): the consumer sees the same stream at any worker
        count."""
        if trace_ctx is not None:
            # thread-lifetime bind (matches _pool_worker): respawn
            # records the emitter writes stay on the caller's trace
            _tracing.use(trace_ctx).__enter__()
        n = len(plan)
        try:
            while not stop.is_set() and state["next_emit"] < n:
                with cv:
                    seq = state["next_emit"]
                    item = state["results"].pop(seq, None)
                    if item is None:
                        if state["fatal"] is not None:
                            item = ("fatal", state["fatal"])
                        else:
                            cv.wait(0.1)
                            self._police_pool(state, cv, stop)
                            continue
                    else:
                        state["plan"].pop(seq, None)  # prune: emitted
                        state["next_emit"] = seq + 1
                        cv.notify_all()
                if item[0] == "fatal":
                    with cv:
                        state["finished"] = True
                        cv.notify_all()
                    self._flush_manifest()
                    self._put(q, stop, ("error", item[1]))
                    return
                if not self._put(q, stop, self._queue_item(item[1])):
                    return
            if not stop.is_set():
                self._flush_manifest()  # epoch end: debounced rows
                self._put(q, stop, None)
        except Exception as exc:
            self._flush_manifest()
            if not stop.is_set():
                self._put(q, stop, ("error", exc))
        finally:
            with cv:
                state["finished"] = True
                cv.notify_all()

    # ---------------------------------------------------------- iterator
    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape, "float32")]

    def _stop_pipeline(self):
        """Stop producer/pool threads with bounded joins: puts are
        stop-aware, so every thread exits within one put timeout of
        the stop event even against a consumer that never drained."""
        self._stop.set()
        if self._pool is not None:
            _, cv = self._pool
            with cv:
                cv.notify_all()
        threads = [t for t in ([self._worker, self._emitter]
                               + self._pool_threads) if t is not None]
        if not threads:
            return
        from .. import config as _config

        budget = float(_config.get_env("MXNET_FEED_JOIN_TIMEOUT_SEC"))
        deadline = time.monotonic() + budget
        for t in threads:
            while t.is_alive() and time.monotonic() < deadline:
                if self._queue is not None:
                    try:
                        while True:
                            self._queue.get_nowait()
                    except queue.Empty:
                        pass
                t.join(timeout=0.1)
            if t.is_alive():
                import logging

                logging.warning(
                    "ImageRecordIter: %s did not join within %.1fs; "
                    "abandoning daemon thread", t.name, budget)
        self._worker = None
        self._emitter = None
        self._pool_threads = []
        self._pool = None

    def reset(self):
        self._stop_pipeline()
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._epoch += 1
        self._stop = threading.Event()
        self._done = False
        self._queue = queue.Queue(maxsize=self._prefetch)
        self._plan = self._build_plan()
        if self._io_workers > 0:
            self._start_pool(self._queue, self._stop, self._plan)
        else:
            self._worker = threading.Thread(
                target=self._producer,
                args=(self._queue, self._stop, self._plan),
                name="ImageRecordIter-producer", daemon=True)
            self._worker.start()

    def next(self):
        if self._done:  # exhausted epoch: don't block on a dead producer
            raise StopIteration
        t0 = time.perf_counter()
        item = self._queue.get()
        with self._feed_lock:
            self._feed_stats["consumer_wait_s"] += time.perf_counter() - t0
            self._feed_stats["batches"] += 1
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] == "error":
            self._done = True
            raise item[1]
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] == "ready":  # on the card: wait on its event
            return item[1].take()
        batch, labels, pad = item
        return self._emit(batch, labels, pad)

    def stats(self):
        """The feed's counters (``DeviceFeedIter.stats``'s keys): how
        long the consumer waited, the producer's busy time, the bytes
        that crossed to the card (the JPEG bitstreams and the labels on
        a CUDA target; 0 on the host) and the batches handed out; what
        ``FitSession(feed=...)`` reads."""
        with self._feed_lock:
            return dict(self._feed_stats)

    @property
    def ctx(self):
        """The batches' device."""
        from ..context import from_torch_device

        return from_torch_device(self._dev)

    def close(self):
        self._stop_pipeline()
        self._flush_manifest()  # a killed epoch still names its skips
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        self._records = None  # release memoryviews into the mmap
        try:
            self._mm.close()
        except BufferError:
            # an abandoned (join-timed-out) worker still holds a view
            # into the mmap: leave it to the GC rather than raise out
            # of close() — the stop event keeps the thread from ever
            # touching the queue again
            import logging

            logging.warning("ImageRecordIter: mmap still referenced "
                            "by an abandoned worker; deferring close")
        self._file.close()
