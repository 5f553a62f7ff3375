"""KVStore: the single-process stores (counterpart of
``mxnet_tpu/kvstore.py``).

Reference parity: include/mxnet/kvstore.h + python/mxnet/kvstore.py
(init/push/pull/pushpull, the optimizer on the store, rank/num_workers,
2-bit gradient compression) with the ``local`` and ``device`` backends
(src/kvstore/comm.h).  One process: ``rank`` 0 of ``num_workers`` 1.
Every value is an NDArray on the device it was initialised on (the
card, by default); pushing a list of gradients sums them there, in list
order, and the optimizer (``set_optimizer``) updates the stored value in
place, as the reference's updater does.  Gradient compression quantises
to {-t, 0, +t} with an error-feedback residual kept per key on the
device.

Not ported yet: the ``dist_*`` stores and ``init_distributed`` (ROADMAP
§A 11: ``torch.distributed`` process groups and the parameter server)
and ``row_sparse_pull`` (§A 11, with the sparse storage of §A 3); they
raise.
"""
from __future__ import annotations

import torch

from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError

__all__ = ["KVStore", "create", "init_distributed", "quantize_2bit",
           "GradientCompression"]

_VALID = ("local", "device", "local_allreduce_cpu",
          "local_allreduce_device", "nccl", "dist_sync", "dist_async",
          "dist_sync_device", "dist_device_sync", "dist")


def _unported(what):
    return MXNetError(
        f"{what} is not ported yet: the port's KVStore is the "
        "single-process 'local'/'device' store (ROADMAP §A 11)")


def init_distributed(coordinator=None, num_workers=None, rank=None):
    """The multi-process runtime's bootstrap: not ported (§A 11)."""
    raise _unported("init_distributed")


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
        if kv_type.startswith("dist"):
            raise _unported(f"KVStore {kv_type!r}")
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
        (ROADMAP §A 3) and the distributed stores (§A 11)."""
        raise MXNetError(
            "row_sparse_pull is not ported yet: it waits for the sparse "
            "storage (ROADMAP §A 3) and the distributed stores (§A 11)")

    def set_gradient_compression(self, compression_params):
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError(f"unsupported compression {ctype}")
        self._compression = GradientCompression(
            compression_params.get("threshold", 0.5))

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


def create(name="local"):
    """Factory (reference src/kvstore/kvstore.cc:40-70): the
    single-process store; ``dist_*`` raises (§A 11)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name not in _VALID:
        raise MXNetError(f"unknown KVStore type {name}")
    return KVStore(name)
