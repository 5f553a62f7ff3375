"""Collective exchange operators and the train step's exchange
(counterpart of ``mxnet_tpu/ops/collective_ops.py``).

A mesh of the port spans worker processes, one device each
(``parallel.Mesh``), and its collectives are ``torch.distributed``'s
over the default group: gloo, which takes CUDA tensors itself and moves
them through the host (the only transport on a card shared by two
ranks; NCCL refuses that).

- ``reduce_scatter`` and ``all_gather``, registered ops as in the
  reference: one flat bucket whose length divides the world.  A rank
  passes its whole bucket to ``reduce_scatter`` and gets its shard of
  the sum; it passes its shard to ``all_gather`` and gets the whole
  bucket.  Concatenated over the ranks, the outputs are the
  reference's on a mesh of as many devices; at world 1 both are the
  identity (a copy).
- :class:`Exchange`: the train step's collectives, one call per bucket
  for each of all-reduce, reduce-scatter and all-gather, with the
  launches and the bytes handed to ``torch.distributed`` counted by
  kind, in the reference's accounting (``zero.collective_bytes``: the
  bytes each rank receives, i.e. the output of each launch).  The
  bucket exchange is counted by kind; BatchNorm's statistics, LARS's
  norms, the fp8 rung's input amax and the step's loss-and-verdict
  exchange are counted apart
  (``roles``), so the bucket bytes compare with
  ``zero.analytic_exchange_bytes``.
"""
from __future__ import annotations

import threading
import time

from ..base import MXNetError
from .registry import register_op

__all__ = ["Exchange", "reduce_scatter", "all_gather", "all_reduce_sum"]

#: the bucket exchange's kinds, in the reference's names
KINDS = ("all-reduce", "reduce-scatter", "all-gather")


def _default_mesh(t):
    """The job's mesh, on the device of ``t``."""
    from ..parallel import get_mesh

    return get_mesh(devices=[t.device])


def _check_divisible(flat, n):
    if flat.dim() != 1 or flat.shape[0] % n:
        raise MXNetError(
            "collective ops take one FLAT bucket whose length divides "
            f"the world (got shape {tuple(flat.shape)} over {n} "
            "processes) — pad with zero.plan_buckets' padded size")


class Exchange:
    """The collectives of one train step over ``mesh``'s processes (the
    default group), counted.

    Every call is synchronous unless ``async_op`` asks otherwise; every
    rank must make the same calls in the same order.  :meth:`reset`
    zeroes the counts, :meth:`counts` reads them:
    ``{kind: {"launches", "bytes"}}`` for the bucket exchange,
    ``{"roles": {role: {"launches", "bytes"}}}`` for the rest, and
    ``"host_s"``, the host's seconds inside the calls (a synchronous
    call waits there for its peers and, on a card, for the work that
    produced its input)."""

    def __init__(self, mesh):
        # None: the one-card world
        self.world, self.rank = (1, 0) if mesh is None \
            else (mesh.size, mesh.rank)
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._kinds = {k: [0, 0] for k in KINDS}
            self._roles = {}
            self._host_s = 0.0

    def counts(self):
        with self._lock:
            out = {k: {"launches": n, "bytes": b}
                   for k, (n, b) in self._kinds.items()}
            out["roles"] = {r: {"launches": n, "bytes": b}
                            for r, (n, b) in self._roles.items()}
            out["host_s"] = self._host_s
        return out

    def _count(self, kind, role, t, t0):
        nbytes = t.numel() * t.element_size()
        with self._lock:
            slot = self._kinds[kind] if role == "bucket" else \
                self._roles.setdefault(role, [0, 0])
            slot[0] += 1
            slot[1] += nbytes
            self._host_s += time.perf_counter() - t0

    def all_reduce(self, t, role="bucket", op="sum"):
        """Reduce ``t`` over the group in place (``op`` "sum" or "max");
        returns ``t``."""
        if self.world > 1:
            import torch.distributed as dist

            t0 = time.perf_counter()
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op])
            self._count("all-reduce", role, t, t0)
        return t

    def reduce_scatter(self, full, role="bucket"):
        """This rank's shard of the sum of ``full`` (at world 1, ``full``
        itself)."""
        _check_divisible(full, self.world)
        if self.world == 1:
            return full
        import torch.distributed as dist

        out = full.new_empty((full.numel() // self.world,))
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(out, full.contiguous())
        self._count("reduce-scatter", role, out, t0)
        return out

    def all_gather(self, shard, out=None, role="bucket", async_op=False):
        """The whole bucket from every rank's ``shard``, written into
        ``out`` (new when None); with ``async_op`` returns ``(out,
        work)``, the caller waits on ``work`` (None at world 1) before
        reading ``out``."""
        if out is None:
            out = shard.new_empty((shard.numel() * self.world,))
        work = None
        if self.world == 1:
            out.copy_(shard)
        else:
            import torch.distributed as dist

            t0 = time.perf_counter()
            work = dist.all_gather_into_tensor(
                out, shard.contiguous(),
                async_op=async_op)
            self._count("all-gather", role, out, t0)
        return (out, work) if async_op else out

    def broadcast(self, t, src=0, role="control"):
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.world > 1:
            import torch.distributed as dist

            t0 = time.perf_counter()
            dist.broadcast(t, src=src)
            self._count("all-gather", role, t, t0)
        return t


def all_reduce_sum(t, axis):
    """``t`` summed over ``axis`` in place: an :class:`Exchange` (counted
    under its role ``lars``) or an axis name (the job's mesh).  None:
    ``t`` itself."""
    if axis is None:
        return t
    if isinstance(axis, str):
        axis = Exchange(_default_mesh(t))
    return axis.all_reduce(t, role="lars")


@register_op("reduce_scatter", differentiable=False)
def reduce_scatter(data):
    """Flat-bucket gradient reduce-scatter over the default mesh (the
    stage-2/3 backward exchange): each rank contributes its whole
    bucket and keeps its shard of the sum, in ``zero.shard_slice``
    order."""
    return Exchange(_default_mesh(data)).reduce_scatter(data.clone())


@register_op("all_gather", differentiable=False)
def all_gather(data):
    """Flat-bucket parameter all-gather over the default mesh (the
    stage-3 forward prefetch, the stage-1/2 gather-back): each rank
    holds its shard, and every rank gets the whole bucket (tiled, as
    ``zero.gather_bucket``)."""
    return Exchange(_default_mesh(data)).all_gather(data)
