"""Flat-bucket layout of the sharded-server exchange (counterpart of
``mxnet_tpu/parallel/zero.py``).

Parameters pack into dtype-homogeneous flat buckets
(:func:`plan_buckets`, split at ``MXNET_KVSTORE_BIGARRAY_BOUND``
elements), and the optimizer updates each bucket in one pass
(:func:`bucket_shard_update`).  The port runs this at one shard: the
collectives of a one-card mesh are the identity, and
``torch.distributed`` comes with the multi-card slice (ROADMAP §A
item 9), as do ZeRO stages 1 and 3 and the Module-side updater.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..base import MXNetError

__all__ = ["Bucket", "plan_buckets", "flatten_bucket", "unflatten_bucket",
           "shard_slice", "bucket_shard_update", "check_bucket_rule",
           "resolve_bucket_variant", "stage3_param_keys", "bucket_segments"]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One dtype-homogeneous flat bucket of whole parameters."""

    dtype: str
    names: tuple          # parameter names, in packing order
    shapes: tuple         # per-name shapes
    offsets: tuple        # per-name start offset in the flat layout
    size: int             # total elements (unpadded)
    padded: int           # size rounded up to a multiple of n_shards
    group: object = None

    @property
    def pad(self):
        return self.padded - self.size


def _dtype_name(v):
    return str(getattr(v, "dtype", torch.float32)).replace("torch.", "")


def plan_buckets(params, n_shards, capacity=None, group_key=None):
    """Pack ``{name: tensor}`` into dtype-homogeneous flat buckets, in
    the order given: a bucket closes once the next parameter would
    push it past ``capacity`` elements (default
    ``MXNET_KVSTORE_BIGARRAY_BOUND``); a parameter is never split, and
    one larger than the bound gets a bucket of its own.  Each bucket is
    padded to a multiple of ``n_shards``; ``group_key`` ({name:
    hashable}) keeps different groups apart.  The reference's rule
    (``plan_buckets``), verbatim."""
    if capacity is None:
        from ..config import get_env

        capacity = get_env("MXNET_KVSTORE_BIGARRAY_BOUND")
    cap = max(1, int(capacity))
    n_shards = max(1, int(n_shards))
    per_part, order = {}, []
    for name, v in params.items():
        part = (_dtype_name(v),
                None if group_key is None else group_key.get(name))
        if part not in per_part:
            per_part[part] = []
            order.append(part)
        per_part[part].append((name, tuple(v.shape)))
    buckets = []
    for dt, grp in order:
        names, shapes, offsets, size = [], [], [], 0
        for name, shape in per_part[(dt, grp)] + [(None, None)]:
            n = 0 if name is None else math.prod(shape)
            if names and (name is None or size + n > cap):
                padded = -(-size // n_shards) * n_shards
                buckets.append(Bucket(dt, tuple(names), tuple(shapes),
                                      tuple(offsets), size, padded, grp))
                names, shapes, offsets, size = [], [], [], 0
            if name is not None:
                names.append(name)
                shapes.append(shape)
                offsets.append(size)
                size += n
    return buckets


def flatten_bucket(bucket, tree):
    """The bucket's parameters (plan order) from ``{name: tensor}`` as
    one new flat padded tensor."""
    parts = [tree[n].reshape(-1) for n in bucket.names]
    if bucket.pad:
        parts.append(parts[0].new_zeros((bucket.pad,)))
    return torch.cat(parts)


def unflatten_bucket(bucket, flat):
    """``{name: view of flat}``, the inverse of :func:`flatten_bucket`
    (padding dropped).  The values are views: writing ``flat`` in place
    updates them."""
    return {name: flat[off:off + math.prod(shape)].view(shape)
            for name, shape, off in zip(bucket.names, bucket.shapes,
                                        bucket.offsets)}


def bucket_segments(bucket):
    """Per-element segment ids of a bucket, for rules that reduce per
    tensor (LARS): element ``i`` gets the index of its tensor in
    ``bucket.names``, and the padding an inert extra segment.  Returns
    ``(ids, num_segments)``: an int32 CPU tensor of length ``padded``
    and ``len(names) + 1``."""
    sizes = [math.prod(shape) for shape in bucket.shapes] + [bucket.pad]
    ids = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32), torch.tensor(sizes))
    return ids, len(bucket.names) + 1


def shard_slice(flat, n_shards, idx):
    """Shard ``idx``'s slice of a flat padded bucket."""
    return flat.view(n_shards, -1)[idx]


def check_bucket_rule(optimizer):
    """A bucket slices through many parameters, so the rule must be
    elementwise or provide its own bucket-aware ``fused_bucket_update``
    (LARS)."""
    from ..optimizer.optimizer import Optimizer

    if getattr(optimizer, "fused_elementwise", True):
        return
    if type(optimizer).fused_bucket_update is Optimizer.fused_bucket_update:
        raise MXNetError(
            f"optimizer {type(optimizer).__name__} is not elementwise and "
            "provides no fused_bucket_update — it cannot run on flat "
            "bucket shards (optimizer_sharding='ps')")


def bucket_shard_update(bucket, opt, params, g_sh, state, t, *, n_shards,
                        idx, seg=None, pallas=None, want_finite=False,
                        w_sh=None, out=None):
    """The per-bucket update: ``(w_sh, new_w_sh, new_state[, finite])``.

    ``w_sh`` is this shard of the flat parameter bucket (sliced from
    ``params`` when None); ``g_sh`` the gradient shard, cast to the
    bucket's dtype here.  ``seg`` = ``(ids, num_segments)`` of the whole
    bucket (:func:`bucket_segments`), for a rule that reduces per
    tensor; the shard's ids are sliced here.  ``pallas``: True runs the
    fused kernel arm (:func:`ops.pallas_opt.bucket_update`), False the
    plain ``opt.fused_bucket_update``, None asks
    :func:`resolve_bucket_variant`.  A kernel arm that cannot run this
    bucket raises — the port never falls back.  ``want_finite`` adds
    the verdict of the raw gradient: the kernel's fused count, or None
    on the plain arm (the caller checks).  ``out`` (tensors like
    ``(w_sh, *state)``) asks the kernel arm to write its results
    there."""
    if n_shards != 1:
        raise MXNetError("bucket shards over more than one card are not "
                         "ported yet (ROADMAP §A 11)")
    if w_sh is None:
        w_sh = shard_slice(flatten_bucket(bucket, params), n_shards, idx)
    seg_sh = None
    if seg is not None:
        ids, nseg = seg
        seg_sh = (shard_slice(ids, n_shards, idx), nseg)
    if pallas is None:
        pallas = resolve_bucket_variant()
    if pallas:
        from ..ops import pallas_opt

        res = pallas_opt.bucket_update(opt, w_sh, g_sh, state, t,
                                       seg=seg_sh, with_finite=want_finite,
                                       out=out)
        if res is None:
            nseg = None if seg is None else seg[1]
            raise MXNetError(
                "the fused_bucket_opt kernel arm cannot run this bucket: "
                + (pallas_opt.supported(opt, w_sh.dtype, nseg)
                   or "the rule needs the bucket's segment ids"))
        uw, us, finite = res
        return (w_sh, uw, us, finite) if want_finite else (w_sh, uw, us)
    kwargs = {} if seg_sh is None else dict(seg_ids=seg_sh[0],
                                            num_segments=seg_sh[1])
    uw, us = opt.fused_bucket_update(w_sh, g_sh.to(w_sh.dtype), state, t,
                                     **kwargs)
    return (w_sh, uw, us, None) if want_finite else (w_sh, uw, us)


def resolve_bucket_variant():
    """The ``fused_bucket_opt`` lowering, at build time: a force scope
    or ``MXNET_PALLAS_OPT`` picks the kernel (True) or the plain
    ``fused_bucket_update`` (False); unset, the plain arm.  The
    reference's third source, a winner of the in-step race cached in
    ``autotune.json``, comes with that race (ROADMAP §A)."""
    from ..autotune import variant_choice

    return bool(variant_choice("fused_bucket_opt", False))


def stage3_param_keys(plan):
    """The optimizer-state keys of the buckets: ``_bucket<i>``."""
    return [f"_bucket{i}" for i in range(len(plan))]
