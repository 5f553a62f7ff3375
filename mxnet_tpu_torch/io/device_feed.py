"""The asynchronous device feed (counterpart of
``mxnet_tpu/io/device_feed.py``).

``DeviceFeedIter`` wraps any batch source: a thread pulls host batches
and puts them on the card ahead of the consumer, so up to ``depth``
batches are resident while the current step runs.  On a CUDA target each
array goes through a pinned host buffer and an asynchronous copy on one
side stream of the feed; the producer records an event after the copy,
the consumer's stream waits on that event in ``next()`` (no host
synchronisation) and ``record_stream`` ties each device tensor to the
consumer's stream, so the caching allocator cannot hand its memory out
again while the step still reads it.  On a host target batches pass
through (moved to the host where they are not).

Wired in where the reference wires it (``MXNET_DEVICE_FEED``, on by
default): ``gluon.data.DataLoader`` wraps its epoch's iterator,
``Module.fit`` wraps ``train_data``, ``PrefetchingIter(device_feed=True)``
feeds the device.  Any source works: ``DataIter`` subclasses
(``DataBatch`` items), ``DataLoader`` iterators (lists of NDArrays) or
generators of numpy arrays or tensors.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as onp
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..resilience import faultsim
from .io import DataBatch, DataIter

__all__ = ["DeviceFeedIter", "as_device_batch", "batch_nbytes",
           "device_feed_enabled"]

faultsim.register_point(
    "feed.h2d", "device-feed producer, before each H2D transfer")

_END = object()


class _Err:
    def __init__(self, exc):
        self.exc = exc


def _q_put(q, stop, item):
    """Stop-aware bounded put: a producer blocked against a consumer
    that stopped draining exits within one timeout of the stop event."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def device_feed_enabled():
    from ..config import get_env

    return bool(get_env("MXNET_DEVICE_FEED"))


def _target(device=None, mesh=None):
    """The feed's ``torch.device``: the mesh's card, ``device``, or the
    calling thread's current context (read once: contexts are per
    thread, and the producer runs in its own)."""
    from ..context import current_context, resolve_device

    if mesh is not None:
        return resolve_device(mesh.devices[0])
    return resolve_device(current_context() if device is None else device)


def _put_tensor(t, device):
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def _rows(t, rows):
    """Process ``rank``'s contiguous rows of a global batch array, for
    ``rows = (rank, world)`` (None: all of it)."""
    if rows is None or t.dim() == 0:
        return t
    rank, world = rows
    if t.shape[0] % world:
        raise MXNetError(
            f"batch axis ({t.shape[0]}) must divide the {world}-process "
            "data mesh")
    k = t.shape[0] // world
    return t[rank * k:(rank + 1) * k]


def as_device_batch(item, device, rows=None):
    """Recursively move a batch's arrays to ``device`` (a
    ``torch.device``): NDArrays stay NDArrays, numpy arrays become
    NDArrays, tensors stay tensors; ``DataBatch`` structure, pad and
    index are kept.  A CUDA copy is asynchronous on the current stream,
    from pinned memory.  ``rows = (rank, world)`` moves only process
    ``rank``'s rows of each array (a mesh of ``world`` processes); the
    ``DataBatch`` then carries them as ``rows_of``."""
    if item is None:
        return None
    if isinstance(item, DataBatch):
        out = DataBatch(
            data=as_device_batch(item.data, device, rows),
            label=as_device_batch(item.label, device, rows),
            pad=item.pad, index=item.index, bucket_key=item.bucket_key,
            provide_data=item.provide_data,
            provide_label=item.provide_label)
        if rows is not None:
            out.rows_of = tuple(rows)
        return out
    if isinstance(item, (list, tuple)):
        mapped = [as_device_batch(x, device, rows) for x in item]
        return type(item)(mapped) if isinstance(item, tuple) else mapped
    if isinstance(item, nd.NDArray):
        return nd.NDArray(_put_tensor(_rows(item._data, rows), device))
    if isinstance(item, onp.ndarray):
        return nd.NDArray(_put_tensor(_rows(
            nd.array(item, ctx=_cpu())._data, rows), device))
    if isinstance(item, torch.Tensor):
        return _put_tensor(_rows(item, rows), device)
    return item


def _cpu():
    from ..context import cpu

    return cpu()


def _tensors(item):
    """Every tensor of a (device) batch."""
    if isinstance(item, DataBatch):
        return _tensors(item.data) + _tensors(item.label)
    if isinstance(item, (list, tuple)):
        return [t for x in item for t in _tensors(x)]
    if isinstance(item, nd.NDArray):
        return [item._data]
    if isinstance(item, torch.Tensor):
        return [item]
    return []


def batch_nbytes(item):
    """Total array bytes of a batch: the host-to-device volume that
    ``stats()['h2d_bytes']`` accumulates and the step records report
    as deltas."""
    if item is None:
        return 0
    if isinstance(item, DataBatch):
        return batch_nbytes(item.data) + batch_nbytes(item.label)
    if isinstance(item, (list, tuple)):
        return sum(batch_nbytes(x) for x in item)
    if isinstance(item, nd.NDArray):
        item = item._data
    if isinstance(item, torch.Tensor):
        return int(item.numel() * item.element_size())
    nbytes = getattr(item, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


class Ready:
    """A batch already on the card with the event its producer recorded
    after the work that made it, on the producer's stream."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device=None):
        self.batch = batch
        self.event = event
        self.device = device

    def take(self):
        """Hand the batch to the calling thread's current stream: wait
        on the event there and tie every tensor to that stream."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(self.event)
            for t in _tensors(self.batch):
                if t.is_cuda:
                    t.record_stream(cur)
        return self.batch


def side_stream_put(fn, device):
    """Run ``fn()`` (which builds a batch on ``device``) on a side
    stream of the card and return a :class:`Ready`; on the host, run it
    and return the batch in a :class:`Ready` without an event."""
    if device.type != "cuda":
        return Ready(fn(), None)
    stream = _side_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = fn()
        ev = torch.cuda.Event()
        ev.record(stream)
    return Ready(out, ev, device)


_streams = {}
_streams_lock = threading.Lock()


def _side_stream(device):
    """The feed's one side stream on a card: producers' copies and
    decodes queue there, apart from the consumer's stream."""
    key = device.index
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device=device)
        return s


def _produce(base, q, stop, stats, device, rows=None):
    """Producer loop (module-level on purpose: it holds no reference to
    the DeviceFeedIter, so an abandoned iterator can be collected and
    its finalizer stop this thread)."""
    from ..resilience.retry import retry_call

    try:
        src = iter(base)
        while not stop.is_set():
            try:
                item = next(src)
            except StopIteration:
                _q_put(q, stop, _END)
                return
            t0 = time.perf_counter()

            def put_batch(it=item):
                # feed.h2d: the injection point for transfer faults;
                # transient failures retry with bounded backoff
                faultsim.inject("feed.h2d")
                return side_stream_put(
                    lambda: as_device_batch(it, device, rows), device)

            out = retry_call(
                put_batch,
                retry_on=(faultsim.FaultInjected, OSError),
                attempts=3, base_delay=0.02, max_delay=0.5)
            stats["producer_busy_s"] += time.perf_counter() - t0
            stats["h2d_bytes"] += batch_nbytes(out.batch)
            if not _q_put(q, stop, out):
                return
    except BaseException as e:  # noqa: BLE001 — surfaced on next()
        _q_put(q, stop, _Err(e))


class DeviceFeedIter(DataIter):
    """Wrap any batch iterator; keep ``depth`` batches on the card ahead
    of the consumer.

    ``device`` (default: the current context when the feed is built),
    or a ``mesh``'s card; under a mesh of several processes only this
    process's rows of each global batch are moved (``rows_of`` on the
    batch).  ``reset()`` restarts the producer and resets
    the wrapped source, so the wrapper drops into ``Module.fit``'s epoch
    loop in place of the raw iterator.  ``stats()`` reports how long the
    consumer waited, how long the producer spent assembling and
    transferring, and the bytes it moved.
    """

    def __init__(self, base, depth=None, mesh=None, data_axis="data",
                 device=None):
        from ..config import get_env

        super().__init__(getattr(base, "batch_size", 0))
        self._base = base
        self._depth = max(1, int(depth if depth is not None
                                 else get_env("MXNET_DEVICE_FEED_DEPTH")))
        self._device = _target(device, mesh)
        self._rows = None if mesh is None or mesh.size == 1 else \
            (mesh.rank, mesh.size)
        self._stats = {"batches": 0, "epochs": 0,
                       "consumer_wait_s": 0.0, "producer_busy_s": 0.0,
                       "h2d_bytes": 0}
        self._thread = None
        self._done = False
        self._closed = False
        self._start()

    # --------------------------------------------------------- producer
    def _start(self):
        import weakref

        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self._depth)
        # the thread closes over the queue, event and stats, not self
        self._thread = threading.Thread(
            target=_produce,
            args=(self._base, self._q, self._stop, self._stats,
                  self._device, self._rows),
            name="DeviceFeedIter", daemon=True)
        self._finalizer = weakref.finalize(self, self._stop.set)
        self._thread.start()

    def _halt(self, timeout=None):
        """Stop the producer with a bounded join (a wedged producer is
        abandoned as a daemon after ``MXNET_FEED_JOIN_TIMEOUT_SEC``).
        Returns True when the thread exited."""
        if self._thread is None:
            return True
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if timeout is None:
            from ..config import get_env

            timeout = float(get_env("MXNET_FEED_JOIN_TIMEOUT_SEC"))
        t = self._thread
        t.join(timeout=timeout)
        joined = not t.is_alive()
        if not joined:
            import logging

            logging.warning(
                "DeviceFeedIter: producer did not join within %.1fs; "
                "abandoning daemon thread", timeout)
        self._thread = None
        return joined

    # --------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __len__(self):
        if getattr(type(self._base), "__len__", None) is None:
            raise TypeError(
                "DeviceFeedIter: wrapped source has no length")
        return len(self._base)

    def next(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    raise MXNetError(
                        "DeviceFeedIter: producer thread died without "
                        "a sentinel")
        self._stats["consumer_wait_s"] += time.perf_counter() - t0
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, _Err):
            self._done = True
            raise item.exc
        self._stats["batches"] += 1
        return item.take()

    def reset(self):
        self._halt()
        if hasattr(self._base, "reset"):
            self._base.reset()
        self._stats["epochs"] += 1
        self._done = False
        self._closed = False
        self._start()

    def close(self):
        """Stop the producer without touching the wrapped source
        (idempotent; the join is bounded).  After ``close()``, ``next()``
        raises StopIteration until ``reset()``."""
        if self._closed:
            return
        self._closed = True
        self._done = True
        self._halt()

    @property
    def base(self):
        return self._base

    @property
    def device(self):
        return self._device

    def stats(self):
        return dict(self._stats)

    @property
    def provide_data(self):
        return getattr(self._base, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._base, "provide_label", None)
