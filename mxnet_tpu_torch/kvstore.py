"""KVStore (counterpart of ``mxnet_tpu/kvstore.py``).

Reference parity: include/mxnet/kvstore.h + python/mxnet/kvstore.py
(init/push/pull/pushpull, the optimizer on the store, rank/num_workers/
barrier, 2-bit gradient compression) with the ``local`` and ``device``
backends (src/kvstore/comm.h) and ``dist_sync``/``dist_async``
(kvstore_dist.h / kvstore_dist_server.h).

Every value is an NDArray on the device it was initialised on (the
card, by default); pushing a list of gradients sums them there, in list
order, and the optimizer (``set_optimizer``) updates the stored value in
place, as the reference's updater does.  Gradient compression quantises
to {-t, 0, +t} with an error-feedback residual kept per key on the
device.

The ``dist_*`` stores (:class:`DistKVStore`) span the worker processes
of a job that ``mxnet_tpu_torch/tools/launch.py`` starts:
:func:`init_distributed` reads its ``DMLC_*`` variables, opens the
job's rendezvous store (a ``torch.distributed.TCPStore`` at
``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, rank 0 serving it) and a gloo
process group over it.  Uncompressed ``dist_sync`` sums a push over the
workers with one all-reduce of the group; ``dist_async`` and compressed
``dist_sync`` go over the TCP parameter server (:mod:`._ps`), whose
shards apply the store's optimizer.  Gloo all-reduces CUDA tensors
itself, through the host; NCCL refuses two ranks on one card, which is
how a one-card machine runs two workers.  The group is the default one,
so ``parallel.get_mesh()`` after ``mx.kv.create("dist_sync")`` is the
mesh of the same workers.  ``row_sparse_pull`` waits for the sparse
storage (ROADMAP §A 3) and raises.
"""
from __future__ import annotations

import datetime
import os

import torch

from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError

__all__ = ["KVStore", "DistKVStore", "create", "init_distributed",
           "quantize_2bit", "GradientCompression", "rendezvous_store"]

_VALID = ("local", "device", "local_allreduce_cpu",
          "local_allreduce_device", "nccl", "dist_sync", "dist_async",
          "dist_sync_device", "dist_device_sync", "dist")

_rendezvous = None


def init_distributed(coordinator=None, num_workers=None, rank=None):
    """Join this process to the job's worker group.

    Reads the reference's bootstrap variables (``DMLC_NUM_WORKER``,
    ``DMLC_WORKER_ID``, ``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``; under
    ``launch.py --launcher mpi`` the rank comes from
    ``OMPI_COMM_WORLD_RANK``/``PMI_RANK``), opens the rendezvous store at
    ``coordinator`` (``host:port``; rank 0 serves it) and a gloo group
    over it.  One worker is a no-op that latches nothing, so a later
    call with a real group still takes effect.  Safe to call twice."""
    import torch.distributed as dist

    global _rendezvous
    if _rendezvous is not None or dist.is_initialized():
        return
    if num_workers is None:
        num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if num_workers <= 1:
        return
    if coordinator is None:
        coordinator = (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1") + ":"
                       + os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    if rank is None:
        rank = int(os.environ.get(
            "DMLC_WORKER_ID", os.environ.get(
                "OMPI_COMM_WORLD_RANK", os.environ.get("PMI_RANK", "0"))))
    from .config import get_env

    host, _, port = coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=get_env("MXNET_PS_DEADLINE_SEC"))
    store = dist.TCPStore(host, int(port), num_workers, rank == 0,
                          timeout=timeout)
    dist.init_process_group("gloo", store=dist.PrefixStore("group", store),
                            rank=rank, world_size=num_workers,
                            timeout=timeout)
    _rendezvous = store


def rendezvous_store():
    """The job's ``TCPStore`` (None outside a launched job)."""
    return _rendezvous


def _key_list(key):
    single = not isinstance(key, (list, tuple))
    return ([key] if single else list(key)), single


def quantize_2bit(acc, threshold):
    """The 2-bit quantisation rule (reference gradient_compression-inl.h
    quantize_2bit): ``acc`` (gradient + carried residual) maps to
    {-t, 0, +t}; the new residual is what quantisation dropped."""
    t = torch.tensor(threshold, dtype=acc.dtype, device=acc.device)
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    q = torch.where(acc >= t, t, torch.where(acc <= -t, -t, zero))
    return q, acc - q


class GradientCompression:
    """2-bit gradient compression with an error-feedback residual
    (reference src/kvstore/gradient_compression.h:38-121).

    Wire format: each value quantises to a 2-bit code (0 -> 0, 1 -> +t,
    2 -> -t), four codes a byte.  The residual stays on the device and is
    added into the next round's gradient of the same key.
    """

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residual = {}

    def _quantize(self, key, grad_v, shard=None):
        rk = key if shard is None else (key, shard)
        r = self._residual.get(rk)
        if r is None:
            r = torch.zeros_like(grad_v)
        q, resid = quantize_2bit(grad_v + r, self.threshold)
        self._residual[rk] = resid
        return q

    def compress(self, key, grad_v, shard=None):
        """Local quantize-dequantize (single-process stores: no wire)."""
        return self._quantize(key, grad_v, shard=shard)

    def compress_packed(self, key, grad_v, shard=None):
        """Quantize and pack to the 2-bit wire payload (uint8)."""
        q = self._quantize(key, grad_v, shard=shard)
        u8 = torch.uint8
        one = torch.ones((), dtype=u8, device=q.device)
        codes = torch.where(q > 0, one, torch.where(q < 0, one * 2,
                                                    one * 0))
        flat = codes.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, torch.zeros(pad, dtype=u8,
                                                device=flat.device)])
        flat = flat.reshape(-1, 4)
        return (flat[:, 0] | (flat[:, 1] << 2) | (flat[:, 2] << 4)
                | (flat[:, 3] << 6)).to(u8)

    def _codes_to_values(self, codes, dtype):
        t = torch.tensor(self.threshold, dtype=dtype, device=codes.device)
        zero = torch.zeros((), dtype=dtype, device=codes.device)
        return torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))

    @staticmethod
    def _unpack(p):
        p = p.to(torch.uint8)
        return torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3,
                            (p >> 6) & 3], dim=-1)

    def decompress(self, payload, shape, dtype=torch.float32):
        """Unpack a 2-bit payload back to {-t, 0, +t} floats."""
        codes = self._unpack(payload).reshape(-1)
        n = 1
        for d in shape:
            n *= d
        return self._codes_to_values(codes[:n].reshape(shape), dtype)


class KVStore:
    """The single-process store: ``local`` and ``device`` semantics."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._rank, self._size = 0, 1

    # ------------------------------------------------------------ basics
    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = value if isinstance(value, (list, tuple)) else [value]
        if len(keys) != len(vals):
            raise MXNetError("key/value length mismatch")
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            self._store[k] = v.copy() if isinstance(v, nd.NDArray) else (
                nd.array(v))

    def push(self, key, value, priority=0):
        keys, single = _key_list(key)
        if single:
            grouped = [value if isinstance(value, list) else [value]]
        else:
            grouped = [v if isinstance(v, list) else [v] for v in value]
        for k, vlist in zip(keys, grouped):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            dev = self._store[k]._data.device
            # device aggregation: the sum of the per-device gradients,
            # in list order, on the stored value's device
            agg = vlist[0]._data.to(dev)
            for v in vlist[1:]:
                agg = agg + v._data.to(dev)
            agg = self._reduce(k, agg)
            if self._updater is not None:
                self._updater(self._key_index(k), nd.NDArray(agg),
                              self._store[k])
            else:
                # no updater: the stored value becomes the pushed sum
                self._store[k]._adopt(agg.to(self._store[k]._data.dtype))

    def _reduce(self, key, agg):
        """The local compression round trip (no wire exists)."""
        if self._compression is not None:
            agg = self._compression.compress(key, agg)
        return agg

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, single = _key_list(key)
        if single:
            outs = [out if isinstance(out, list) else [out]]
        else:
            outs = [o if isinstance(o, list) else [o] for o in out]
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            src = self._store[k]._data
            for o in olist:
                o._adopt(src.to(device=o._data.device, dtype=o._data.dtype,
                                copy=True))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Not ported yet: sparse pulls wait for the sparse storage
        (ROADMAP §A 3)."""
        raise MXNetError(
            "row_sparse_pull is not ported yet: it waits for the sparse "
            "storage (ROADMAP §A 3)")

    def set_gradient_compression(self, compression_params):
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError(f"unsupported compression {ctype}")
        self._compression = GradientCompression(
            compression_params.get("threshold", 0.5))
        # a fresh compressor carries no residual: keys re-pin their
        # slice step at the current MXNET_KVSTORE_BIGARRAY_BOUND
        getattr(self, "_comp_slice_step", {}).clear()

    # --------------------------------------------------------- optimizer
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _key_index(self, k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def barrier(self):
        """One worker: nothing to wait for."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("updater is not initialized")
        from .resilience.checkpoint import atomic_write_bytes

        atomic_write_bytes(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("updater is not initialized")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _set_updater(self, updater):
        self._updater = updater

    def _send_command_to_servers(self, head, body):
        raise MXNetError(
            "_send_command_to_servers needs a dist KVStore (the local "
            "store has no server processes)")


class DistKVStore(KVStore):
    """The multi-process store: push and pull cross workers
    (KVStoreDist, src/kvstore/kvstore_dist.h:44).

    ``init`` takes rank 0's value everywhere.  Uncompressed
    ``dist_sync`` is the group's all-reduce, and an optimizer on the
    store then runs identically on every worker against its replica;
    ``dist_async`` and compressed ``dist_sync`` push to the key's owner
    shard of the parameter server (:meth:`_ps_active`), which merges
    (sync) or applies (async) and runs the store's optimizer.
    :attr:`backend` names the group's backend, :attr:`shard` which
    parameter-server shard serves in this process."""

    _ps_counter = 0

    def __init__(self, kv_type="dist_sync"):
        init_distributed()
        super().__init__(kv_type)
        import torch.distributed as dist

        self._group = dist.is_available() and dist.is_initialized()
        if self._group:
            self._rank, self._size = dist.get_rank(), dist.get_world_size()
        self._ps = None
        # every rank creates its stores in the same order: the counter
        # names each store's keys on the shared shards
        self._ps_ns = f"s{DistKVStore._ps_counter}"
        DistKVStore._ps_counter += 1
        self._bare = {}
        #: bytes the last push put on the wire, what it would have taken
        #: uncompressed, and the wire bytes of every push so far
        self.last_wire_bytes = 0
        self.last_uncompressed_bytes = 0
        self.total_wire_bytes = 0
        # each key's compression slice step, pinned at its first push
        self._comp_slice_step = {}

    @property
    def backend(self):
        """The process group's backend (``gloo``), None for one
        worker."""
        if not self._group:
            return None
        import torch.distributed as dist

        return dist.get_backend()

    @property
    def shard(self):
        """``native`` or ``python``: the parameter-server shard of this
        process, None before the store used it."""
        return None if self._ps is None else self._ps.shard

    # ------------------------------------------------ the PS backend
    def _ps_active(self):
        if self._size <= 1:
            return False
        return self.type == "dist_async" or self._compression is not None

    def _ps_key(self, k):
        self._bare[str(k)] = k
        return f"{self._ps_ns}/{k}"

    def _ps_backend(self):
        if self._ps is None:
            from ._ps import PSBackend

            self._ps = PSBackend.get(self._rank, self._size,
                                     rendezvous_store())
            if self._updater is not None:
                self._ps.set_updater(self._ps_ns, self._ps_updater())
        return self._ps

    def _ps_updater(self):
        """The shard's rule: the store's updater on this worker's device,
        the stored value and gradient moved there and back."""
        updater = self._updater

        def apply(key, grad, value):
            k = self._bare.get(key, key)
            dev = self._store[k]._data.device if k in self._store \
                else value.device
            stored = nd.NDArray(value.to(dev))
            updater(self._key_index(k), nd.NDArray(grad.to(dev)), stored)
            return stored._data.detach().to("cpu", value.dtype)

        return apply

    def _push_mode(self):
        return "async" if self.type == "dist_async" else "sync"

    def _ps_op(self, k, fn):
        """Run a PS operation; a restarted shard comes back empty, so on
        'uninitialized key' every worker refills it from its last-known
        value (set-if-absent: the first refill wins) and retries."""
        try:
            return fn()
        except MXNetError as e:
            if "uninitialized key" not in str(e):
                raise
            self._ps_backend().init(self._ps_key(k), self._store[k]._data,
                                    refill=True)
            return fn()

    def _send_command_to_servers(self, head, body):
        """Send a command to every server shard (head 0: the server
        profiler, ``profile:start|stop|dump:<path>``)."""
        self._ps_backend().command(head, body)

    def num_dead_node(self, node_id=0, timeout_sec=60.0):
        """Workers whose heartbeat is older than ``timeout_sec``; none in
        a group of one."""
        if self._size <= 1:
            return 0
        return self._ps_backend().num_dead_node(timeout_sec)

    # ------------------------------------------------------- the API
    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = value if isinstance(value, (list, tuple)) else [value]
        if len(keys) != len(vals):
            raise MXNetError("key/value length mismatch")
        if self._ps_active():
            ps = self._ps_backend()
            for k, v in zip(keys, vals):
                if k in self._store:
                    raise MXNetError(f"key {k} already initialized")
                arr = v if isinstance(v, nd.NDArray) else nd.array(v)
                self._store[k] = arr.copy()
                ps.init(self._ps_key(k), arr._data)
            self.barrier()  # rank 0's value stands on the owners
            return
        super().init(keys, vals)
        for k in keys:
            # rank 0's value everywhere (the server owns the weights)
            self._store[k]._adopt(self._broadcast0(self._store[k]._data))

    def _compress_packed_bigarray(self, k, a32):
        """The 2-bit payload of one push; an array above
        ``MXNET_KVSTORE_BIGARRAY_BOUND`` is sliced into bound-sized
        shards first, each quantised with its own residual.  Slice
        edges are 4-aligned, so the payload equals whole-array packing.
        The step is pinned per key at its first push."""
        from .config import get_env

        flat = a32.reshape(-1)
        step = self._comp_slice_step.get(k)
        if step is None:
            bound = int(get_env("MXNET_KVSTORE_BIGARRAY_BOUND"))
            step = self._comp_slice_step[k] = max(4, (bound // 4) * 4)
        if flat.numel() <= step:
            return self._compression.compress_packed(k, a32)
        return torch.cat([
            self._compression.compress_packed(k, flat[o:o + step], shard=i)
            for i, o in enumerate(range(0, flat.numel(), step))])

    def push(self, key, value, priority=0):
        if not self._ps_active():
            return super().push(key, value, priority)
        keys, single = _key_list(key)
        if single:
            grouped = [value if isinstance(value, list) else [value]]
        else:
            grouped = [v if isinstance(v, list) else [v] for v in value]
        ps = self._ps_backend()
        mode = self._push_mode()
        for k, vlist in zip(keys, grouped):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            agg = vlist[0]._data
            for v in vlist[1:]:
                agg = agg + v._data.to(agg.device)
            nbytes = agg.numel() * agg.element_size()
            self.last_uncompressed_bytes = nbytes
            if self._compression is not None:
                a32 = agg.to(torch.float32)
                payload = self._compress_packed_bigarray(k, a32).cpu()
                self.last_wire_bytes = payload.numel()
                self.total_wire_bytes += payload.numel()
                meta = {"shape": tuple(a32.shape),
                        "threshold": self._compression.threshold}
                self._ps_op(k, lambda: ps.push(
                    self._ps_key(k), None, mode,
                    compressed_payload=payload.numpy().tobytes(),
                    meta=meta))
            else:
                # the native dtype on the wire
                self.last_wire_bytes = nbytes
                self.total_wire_bytes += nbytes
                self._ps_op(k, lambda: ps.push(self._ps_key(k), agg, mode))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if not self._ps_active():
            return super().pull(key, out, priority, ignore_sparse)
        keys, single = _key_list(key)
        if single:
            outs = [out if isinstance(out, list) else [out]]
        else:
            outs = [o if isinstance(o, list) else [o] for o in out]
        ps = self._ps_backend()
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            val = self._ps_op(k, lambda: ps.pull(self._ps_key(k)))
            # the native shard returns flat values
            stored = self._store[k]
            val = val.reshape(stored.shape).to(device=stored._data.device,
                                               dtype=stored._data.dtype)
            stored._adopt(val)
            for o in olist:
                o._adopt(val.to(device=o._data.device, dtype=o._data.dtype,
                                copy=True))

    def _set_updater(self, updater):
        super()._set_updater(updater)
        if self._ps is not None and updater is not None:
            self._ps.set_updater(self._ps_ns, self._ps_updater())

    def set_optimizer(self, optimizer):
        super().set_optimizer(optimizer)
        if self._ps_active():
            # this process's shard gets the rule; every worker runs the
            # same program, so every shard gets the same one
            self._ps_backend().set_updater(self._ps_ns, self._ps_updater())

    def barrier(self):
        if self._size > 1:
            import torch.distributed as dist

            dist.barrier()

    @staticmethod
    def _widen(arr):
        # half types cross the group in float32; the rest as they are
        if arr.dtype in (torch.float16, torch.bfloat16):
            return arr.to(torch.float32), arr.dtype
        return arr.contiguous().clone(), None

    def _allreduce(self, arr):
        """The sum of ``arr`` over the workers (identical on each)."""
        if self._size == 1:
            return arr
        import torch.distributed as dist

        a, narrow = self._widen(arr)
        dist.all_reduce(a)
        return a.to(narrow) if narrow is not None else a

    def _broadcast0(self, arr):
        """Rank 0's ``arr`` on every worker."""
        if self._size == 1:
            return arr
        import torch.distributed as dist

        a, narrow = self._widen(arr)
        dist.broadcast(a, src=0)
        return a.to(narrow) if narrow is not None else a

    def _reduce(self, key, agg):
        # with compression in a group the push goes to the PS shard
        # (_ps_active); here only one worker's local round trip is left
        if self._compression is not None:
            narrow = agg.dtype if agg.dtype in (torch.float16,
                                                torch.bfloat16) else None
            a32 = agg.to(torch.float32) if narrow is not None else agg
            payload = self._compress_packed_bigarray(key, a32)
            self.last_wire_bytes = payload.numel()
            self.total_wire_bytes += payload.numel()
            self.last_uncompressed_bytes = agg.numel() * agg.element_size()
            out = self._compression.decompress(payload, a32.shape,
                                               a32.dtype)
            return out.to(narrow) if narrow is not None else out
        self.last_wire_bytes = agg.numel() * agg.element_size()
        self.last_uncompressed_bytes = self.last_wire_bytes
        self.total_wire_bytes += self.last_wire_bytes
        return self._allreduce(agg)


def create(name="local"):
    """Factory (reference src/kvstore/kvstore.cc:40-70): ``dist_*``
    gives a :class:`DistKVStore`; outside a launched job it is a group
    of one worker (rank 0 of 1), as the reference's."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name not in _VALID:
        raise MXNetError(f"unknown KVStore type {name}")
    if name.startswith("dist"):
        return DistKVStore(name)
    return KVStore(name)
