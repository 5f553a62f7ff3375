"""Flat-bucket layout of the sharded-server exchange (counterpart of
``mxnet_tpu/parallel/zero.py``).

Parameters pack into dtype-homogeneous flat buckets
(:func:`plan_buckets`, split at ``MXNET_KVSTORE_BIGARRAY_BOUND``
elements), and the optimizer updates each bucket in one pass
(:func:`bucket_shard_update`), each worker process of a mesh updating
the shard it owns (``parallel.Mesh``: one device a process; the
collectives are ``ops.collective_ops.Exchange``'s).  Stage 3 keeps the
parameters as flat bucket shards (:func:`shard_stage3_params`,
:func:`gather_stage3_params`); :func:`analytic_exchange_bytes` is the
plan's wire floor, which the step's counted bytes equal.  The HLO
readers of the reference (``collective_bytes``, ``overlap_report``,
``export_overlap_trace``) have no counterpart: the port counts its own
launches and bytes (ROADMAP §C).  :class:`ShardedBucketUpdater` is the
Module's: its optimizer state sharded over the process mesh, each
process updating its own shard of every bucket.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..base import MXNetError
from ..resilience import faultsim

faultsim.register_point("dist.collective", "before the elastic barrier's "
                        "all-reduce and the sharded updater's exchange")

__all__ = ["Bucket", "plan_buckets", "flatten_bucket", "unflatten_bucket",
           "shard_slice", "bucket_shard_update", "check_bucket_rule",
           "resolve_bucket_variant", "flat_variant_key",
           "stage3_param_keys", "bucket_segments",
           "plan_fingerprint", "resolve_sharding_env",
           "resolve_zero_stage", "gather_bucket", "shard_stage3_params",
           "gather_stage3_params", "analytic_exchange_bytes",
           "mark_shard", "shard_mesh", "named_bucket_state",
           "shard_bucket_state", "sharding_rule_reasons",
           "ShardedBucketUpdater"]


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
                        idx, axis=None, seg=None, pallas=None,
                        want_finite=False, w_sh=None, out=None):
    """The per-bucket update: ``(w_sh, new_w_sh, new_state[, finite])``.

    ``w_sh`` is shard ``idx`` of ``n_shards`` of the flat parameter
    bucket (sliced from ``params`` when None); ``g_sh`` the gradient
    shard, cast to the bucket's dtype here.  ``seg`` = ``(ids,
    num_segments)`` of the whole bucket (:func:`bucket_segments`), for a
    rule that reduces per tensor; the shard's ids are sliced here, and
    its per-segment sums add up over ``axis`` (an ``Exchange`` of the
    shards' processes) when there is more than one shard.  ``pallas``:
    True runs the fused kernel arm
    (:func:`ops.pallas_opt.bucket_update`), False the plain
    ``opt.fused_bucket_update``, None consults the ``fused_bucket_opt``
    variant now (force > ``MXNET_PALLAS_OPT`` > a winner of
    ``program_scope`` > the plain arm), what
    :func:`resolve_bucket_variant` leaves undecided on the host.  A
    kernel arm that cannot run this bucket raises — the port never
    falls back.  ``want_finite`` adds the verdict of the raw gradient:
    the kernel's fused count, or None on the plain arm (the caller
    checks).  ``out`` (tensors like ``(w_sh, *state)``) asks the kernel
    arm to write its results there."""
    if n_shards == 1:
        axis = None  # nothing to sum over: the one-shard launches
    if w_sh is None:
        w_sh = shard_slice(flatten_bucket(bucket, params), n_shards, idx)
    seg_sh = None
    if seg is not None:
        ids, nseg = seg
        seg_sh = (shard_slice(ids, n_shards, idx), nseg)
    if pallas is None:
        from ..autotune import variant_choice

        pallas = bool(variant_choice("fused_bucket_opt"))
    if pallas:
        from ..ops import pallas_opt

        res = pallas_opt.bucket_update(opt, w_sh, g_sh, state, t,
                                       seg=seg_sh, axis_name=axis,
                                       with_finite=want_finite, out=out)
        if res is None:
            nseg = None if seg is None else seg[1]
            raise MXNetError(
                "the fused_bucket_opt kernel arm cannot run this bucket: "
                + (pallas_opt.supported(opt, w_sh.dtype, nseg)
                   or "the rule needs the bucket's segment ids"))
        uw, us, finite = res
        return (w_sh, uw, us, finite) if want_finite else (w_sh, uw, us)
    kwargs = {} if seg_sh is None else dict(
        seg_ids=seg_sh[0], num_segments=seg_sh[1], axis_name=axis)
    uw, us = opt.fused_bucket_update(w_sh, g_sh.to(w_sh.dtype), state, t,
                                     **kwargs)
    return (w_sh, uw, us, None) if want_finite else (w_sh, uw, us)


def gather_bucket(bucket, w_sh, axis):
    """All-gather an updated shard back to the whole flat bucket over
    ``axis`` (an ``Exchange``) and split it per parameter (tiled, in
    :func:`shard_slice`'s order)."""
    return unflatten_bucket(bucket, axis.all_gather(w_sh))


def flat_variant_key(plan, stage=None):
    """The ``fused_bucket_opt`` autotune key of a bucket plan (reference
    ``flat_variant_key``, ``mxnet_tpu/parallel/zero.py:268``): the total
    padded element count and the lead dtype — what the kernels stream —
    so that a winner measured on one consumer of the plan reaches the
    others.  Stages None/2 share the key; stages 1 and 3 wrap the
    kernel in another exchange and add their own dimension."""
    shape = (sum(b.padded for b in plan),)
    if stage not in (None, 2):
        shape = shape + (int(stage),)
    return (shape, plan[0].dtype if plan else "float32")


def resolve_bucket_variant(optimizer, plan, mesh=None, stage=None,
                           platform=None):
    """The ``fused_bucket_opt`` lowering of a bucket plan, at build time
    (reference ``resolve_bucket_variant``,
    ``mxnet_tpu/parallel/zero.py:287``): a force scope or
    ``MXNET_PALLAS_OPT`` first, then whether the kernels take the rule
    and the bucket dtype (False where they do not: the rule's own
    ``fused_bucket_update``, which is no kernel's twin), then — on the
    host, with autotune on — the cached winner under
    :func:`flat_variant_key` and the mesh.

    ``platform`` (default: the mesh's card, else the current context's)
    decides what stays undecided: on ``cuda`` the kernel (True), the
    card's roster having that arm alone (ROADMAP §C); on the CPU None,
    so that the call-time ``variant_choice`` still applies (a force
    scope or a winner of ``program_scope``), the plain arm by default,
    as in the reference off the TPU.  Returns True, False or None."""
    from .. import autotune as _at
    from ..ops import pallas_opt

    choice = _at.variant_choice("fused_bucket_opt")
    if choice is not None:
        return bool(choice)
    shape, dtype = flat_variant_key(plan, stage)
    if pallas_opt.supported(optimizer, getattr(torch, dtype)) is not None:
        return False
    if platform is None:
        platform = mesh.devices[0].type if mesh is not None \
            else _at._current_platform()
    if platform == "cuda":
        return True
    if not _at.enabled():
        return False
    cached = _at.lookup("fused_bucket_opt", shape, dtype,
                        platform=platform, mesh=_at.mesh_desc(mesh))
    if cached is not None:
        return bool(_at.VARIANT_OPS["fused_bucket_opt"].get(cached,
                                                            False))
    return None


def plan_fingerprint(plan, n_shards, stage=None):
    """Stable fingerprint of a bucket plan at a shard count — the
    checkpoint manifest's ``topology.plan_fingerprint``
    (``resilience.elastic``), equal to the reference's for the same
    plan.  Two runs share a fingerprint iff their flat layouts are
    interchangeable: same buckets in the same order with the same
    member names/shapes/dtypes/padding, sharded the same number of
    ways.  Stages None/1/2 hash alike (their checkpoints hold the
    replicated named tree); stage 3 is tagged, since it persists
    parameter shards in the flat-bucket layout."""
    import hashlib

    h = hashlib.sha256()
    h.update(f"shards={int(n_shards)}".encode())
    if stage == 3:
        h.update(b"stage=3")
    for b in plan:
        h.update(repr((b.dtype, b.names, b.shapes, b.offsets,
                       b.size, b.padded, b.group)).encode())
    return h.hexdigest()[:16]


def resolve_sharding_env():
    """The ``MXNET_OPTIMIZER_SHARDING`` tri-state: "ps" forced on, False
    forced off, None unset (the caller decides).  Unknown values raise,
    as the reference's."""
    from ..config import get_env

    raw = str(get_env("MXNET_OPTIMIZER_SHARDING")).strip().lower()
    if raw in ("ps", "1", "on", "true", "yes"):
        return "ps"
    if raw in ("0", "off", "false", "no"):
        return False
    if raw:
        raise MXNetError(
            f"MXNET_OPTIMIZER_SHARDING={raw!r} is not a recognized "
            "value (use 'ps' to force sharding on, '0' to force it "
            "off, or unset)")
    return None


def resolve_zero_stage():
    """The ``MXNET_ZERO_STAGE`` knob: 1/2/3, or None when unset.
    Unknown values raise, as the reference's."""
    from ..config import get_env

    raw = str(get_env("MXNET_ZERO_STAGE")).strip()
    if not raw:
        return None
    if raw in ("1", "2", "3"):
        return int(raw)
    raise MXNetError(
        f"MXNET_ZERO_STAGE={raw!r} is not a recognized stage (use 1, "
        "2 or 3, or unset)")


def stage3_param_keys(plan):
    """The keys of the buckets, in the optimizer state and in the
    stage-3 parameter layout: ``_bucket<i>``."""
    return [f"_bucket{i}" for i in range(len(plan))]


def mark_shard(t, mesh):
    """Tag ``t`` as this process's shard of a flat bucket split over
    ``mesh``'s processes, so that ``resilience.elastic.host_gather``
    all-gathers it; untagged (one shard) at world 1.  Returns ``t``."""
    if mesh is not None and mesh.size > 1:
        t._mxt_shard_mesh = mesh
    return t


def shard_mesh(t):
    """The mesh whose processes hold ``t``'s bucket (None: whole)."""
    return getattr(t, "_mxt_shard_mesh", None)


def named_bucket_state(plan, opt_state, gather=None):
    """The optimizer state of whole buckets (``{"_bucket<i>": tuple of
    flat tensors}``) as the per-parameter layout ``{name: tuple}``, the
    world-size-free one a checkpoint keeps; ``gather`` (e.g.
    ``host_gather``) first maps each sharded tensor to its whole
    bucket."""
    named = {}
    for bk, b in zip(stage3_param_keys(plan), plan):
        leaves = [torch.as_tensor(t if gather is None else gather(t))
                  for t in opt_state[bk]]
        for name, shape, off in zip(b.names, b.shapes, b.offsets):
            n = math.prod(shape)
            named[name] = tuple(x[off:off + n].reshape(shape)
                                for x in leaves)
    return named


def shard_bucket_state(plan, named, mesh=None):
    """The inverse of :func:`named_bucket_state` under a (new) plan: each
    bucket's state flattened from ``{name: tuple}`` and, under a mesh,
    this process's shard of it (tagged, on its device) — the re-slice of
    a resume whose ``reshard_verdict`` says reshard."""
    out = {}
    for bk, b in zip(stage3_param_keys(plan), plan):
        slots = len(named[b.names[0]])
        state = []
        for k in range(slots):
            flat = flatten_bucket(b, {n: torch.as_tensor(named[n][k])
                                      for n in b.names})
            if mesh is not None:
                flat = mark_shard(shard_slice(flat, mesh.size, mesh.rank)
                                  .clone().to(mesh.devices[0]), mesh)
            state.append(flat)
        out[bk] = tuple(state)
    return out


def shard_stage3_params(plan, named, mesh=None):
    """Named ``{name: tensor}`` parameters -> the stage-3 layout
    ``{"_bucket<i>": flat padded bucket}``.  With a mesh of several
    processes each keeps only its own shard (``padded / N`` elements, a
    tensor of its own), on its device."""
    out = {}
    for k, b in zip(stage3_param_keys(plan), plan):
        flat = flatten_bucket(b, {n: torch.as_tensor(named[n])
                                  for n in b.names})
        if mesh is not None:
            flat = mark_shard(shard_slice(flat, mesh.size, mesh.rank)
                              .clone().to(mesh.devices[0]), mesh)
        out[k] = flat
    return out


def gather_stage3_params(plan, pshards):
    """The inverse of :func:`shard_stage3_params` over whole buckets:
    the named ``{name: tensor}`` tree from ``{"_bucket<i>": flat
    padded bucket}`` (a process mesh's shards go through
    ``resilience.elastic.host_gather`` first)."""
    named = {}
    for k, b in zip(stage3_param_keys(plan), plan):
        named.update(unflatten_bucket(b, torch.as_tensor(pshards[k])))
    return named


def analytic_exchange_bytes(plan, n_shards, stage):
    """The plan's least wire bytes a step, as each rank receives them
    (the output of each launch; reference ``analytic_exchange_bytes``,
    ``mxnet_tpu/parallel/zero.py:418``): stage 1, one all-reduce and one
    gather-back all-gather a bucket; stages 2 and 3, one reduce-scatter
    (``padded / N`` out) and one all-gather (``padded`` out) a bucket.
    The step's counted bucket bytes (``step_fn.exchange``) equal it."""
    rs = ag = ar = 0
    for b in plan:
        full = b.padded * torch.empty((), dtype=getattr(
            torch, b.dtype)).element_size()
        if stage == 1:
            ar += full
            ag += full
        else:
            rs += full // int(n_shards)
            ag += full
    return {"reduce-scatter": rs, "all-gather": ag, "all-reduce": ar}


def sharding_rule_reasons(optimizer):
    """Semantics the flat-bucket sharded updater cannot reproduce, as
    reasons (empty: eligible; reference ``sharding_rule_reasons``,
    ``mxnet_tpu/parallel/zero.py:573``).  The Module falls back to the
    per-parameter updater on them, with the reasons logged;
    :meth:`ShardedBucketUpdater.set_states` refuses a resumed pickle
    whose optimizer has any."""
    reasons = []
    try:
        check_bucket_rule(optimizer)
    except MXNetError as e:
        reasons.append(str(e))
    if getattr(optimizer, "needs_key", False):
        reasons.append("stochastic rule (needs per-step PRNG keys)")
    if getattr(optimizer, "multi_precision", False):
        reasons.append("multi_precision master weights")
    if getattr(optimizer, "lr_scheduler", None) is not None:
        reasons.append("lr_scheduler (evaluated per update only in "
                       "the eager path)")
    if not reasons:
        # the legacy .states interchange needs identical fused and eager
        # state layouts (Nadam's fused rule carries a schedule scalar)
        from ..ndarray import NDArray

        probe = torch.zeros((2,), dtype=torch.float32)
        try:
            if len(optimizer.fused_state(probe)) != \
                    len(optimizer.create_state(0, NDArray(probe))):
                reasons.append("fused/eager state layouts differ")
        except Exception as e:
            reasons.append(f"state probe failed: {e!r}")
    return reasons


# hyper-parameters a live change of which does not re-bake the bucket
# optimizers: lr/wd ride the bucket group, the multipliers feed
# _get_lr/_get_wd, schedulers take the eager path, the counters advance
_HYPER_SIG_SKIP = frozenset((
    "lr", "wd", "lr_mult", "wd_mult", "param_dict", "idx2name",
    "lr_scheduler", "num_update", "begin_num_update",
    "_index_update_count", "_all_index_update_counts",
))


class ShardedBucketUpdater:
    """The Module's sharded updater (reference ``ShardedBucketUpdater``,
    ``mxnet_tpu/parallel/zero.py:669``): the optimizer state of every
    trained parameter lives in flat buckets sharded over ``mesh``'s
    processes, each process updating only the shard it owns through
    :func:`bucket_shard_update` (the bucket kernels, or the rule's plain
    form), then all-gathering every bucket back into the parameters —
    copied in place, so the executor's arrays stay the arrays it holds.

    The gradients arrive fully reduced (the Module sums them over the
    mesh after its backward); the owned shard is a slice of them.  The
    buckets are partitioned by each parameter's effective ``(lr, wd)``,
    so per-parameter multipliers hold, and a live change of ``lr``,
    ``wd`` or any other scalar hyper-parameter is followed.

    ``get_states`` gathers the shards into the per-parameter
    ``{name: state}`` pickle of :class:`~mxnet_tpu_torch.optimizer.Updater`
    (a collective: every process calls it), ``set_states`` re-shards
    one on the live plan: the port's ``.states`` files pass between the
    two updaters and across world sizes."""

    def __init__(self, optimizer, mesh, params, capacity=None,
                 exchange=None):
        from ..ops.collective_ops import Exchange

        check_bucket_rule(optimizer)
        self.optimizer = optimizer
        self.mesh = mesh
        self.n_shards = int(mesh.size)
        self.rank = int(mesh.rank)
        self._ex = exchange if exchange is not None else Exchange(mesh)
        self._device = mesh.devices[0]
        self._capacity = capacity
        self._shapes = {n: tuple(v.shape) for n, v in params.items()}
        self._dtypes = {n: v.dtype for n, v in params.items()}
        self._groups = self._current_groups(params)
        self.plan = plan_buckets(params, self.n_shards, capacity=capacity,
                                 group_key=self._groups)
        self._rebuild_bucket_opts()
        self._hyper_sig = self._current_hyper_sig()
        # the step clock continues the optimizer's (begin_num_update
        # seeds a resumed run; Adam's bias correction takes t = _t + 1)
        self._t = int(getattr(optimizer, "num_update", 0) or 0)
        #: the lowering of the shard update: True the bucket kernels,
        #: False the rule's plain form, None not decided yet
        self._pallas = None
        self._states = [tuple(optimizer.fused_state(
            shard_slice(flatten_bucket(b, params), self.n_shards,
                        self.rank).to(self._device, copy=True)))
            for b in self.plan]

    def _current_groups(self, names):
        return {n: (float(self.optimizer._get_lr(n)),
                    float(self.optimizer._get_wd(n))) for n in names}

    def _current_hyper_sig(self):
        """Every scalar hyper-parameter the bucket optimizers copy but
        lr and wd (momentum, the betas, rescale_grad, clip_gradient...):
        a live change re-bakes them."""
        return tuple(sorted(
            (k, v) for k, v in vars(self.optimizer).items()
            if k not in _HYPER_SIG_SKIP
            and isinstance(v, (int, float, bool, str, bytes, type(None)))))

    def _rebuild_bucket_opts(self):
        """One shallow copy of the optimizer a bucket, its effective lr
        and wd set (the multipliers live in the group key)."""
        import copy

        self._bucket_opts = []
        for b in self.plan:
            o = copy.copy(self.optimizer)
            o.lr_mult, o.wd_mult, o.param_dict = {}, {}, {}
            o.lr_scheduler = None
            if b.group is not None:
                o.lr, o.wd = b.group
            self._bucket_opts.append(o)
        self._segs = None if getattr(self.optimizer, "fused_elementwise",
                                     True) else \
            [(ids.to(self._device), nseg)
             for ids, nseg in map(bucket_segments, self.plan)]

    def _sync_hyper_params(self):
        """Follow a live change of the optimizer: a scalar
        hyper-parameter re-bakes the bucket optimizers; new (lr, wd)
        values that keep the partition swap the groups; a change that
        re-partitions the parameters gathers the states, re-plans the
        buckets and re-shards them (and re-decides the lowering: a new
        plan is a new variant key)."""
        sig = self._current_hyper_sig()
        if sig != self._hyper_sig:
            self._hyper_sig = sig
            self._rebuild_bucket_opts()
        groups = self._current_groups(self._shapes)
        if groups == self._groups:
            return
        if all(len({groups[n] for n in b.names}) == 1 for b in self.plan):
            self._groups = groups
            self.plan = [dataclasses.replace(b, group=groups[b.names[0]])
                         for b in self.plan]
            self._rebuild_bucket_opts()
            return
        per_param = self._gather_per_param()
        self._groups = groups
        specs = {n: torch.empty(self._shapes[n], dtype=self._dtypes[n],
                                device="meta") for n in self._shapes}
        self.plan = plan_buckets(specs, self.n_shards,
                                 capacity=self._capacity, group_key=groups)
        self._rebuild_bucket_opts()
        self._states = self._flatten_to_plan(per_param)
        self._pallas = None

    # ------------------------------------------------------------ update
    def _variant_key(self):
        """The ``fused_bucket_opt`` key of this updater: the plan's flat
        key (:func:`flat_variant_key`) and the mesh's, the key the
        sharded train step consults."""
        from .. import autotune as _at

        shape, dtype = flat_variant_key(self.plan)
        return shape, dtype, _at.mesh_desc(self.mesh)

    def _decide_variant(self):
        """The ``fused_bucket_opt`` lowering (reference
        ``_decide_variant``, ``mxnet_tpu/parallel/zero.py:819``):
        :func:`resolve_bucket_variant` first (a force scope or
        ``MXNET_PALLAS_OPT``, the kernels' reach, a cached winner under
        the shared key); on the host with none of them the plain rule,
        as the reference's answer off the TPU.  On the card the answer
        is the kernel, whose roster there is that arm alone (ROADMAP §C);
        with autotune on and no winner cached, the updater races that
        roster on its own exchange (:meth:`_time_update`) and records
        the winner under the shared key.  Every process decides alike:
        the race's exchanges are collectives."""
        from .. import autotune as _at

        decided = resolve_bucket_variant(self.optimizer, self.plan,
                                         self.mesh)
        if not decided:
            return False
        if (self._device.type == "cuda" and _at.enabled()
                and _at.variant_choice("fused_bucket_opt") is None):
            shape, dtype, mesh_d = self._variant_key()
            if _at.lookup("fused_bucket_opt", shape, dtype,
                          platform="cuda", mesh=mesh_d) is None:
                _at.tune("fused_bucket_opt", shape, dtype,
                         _at.op_variants("fused_bucket_opt", "cuda"),
                         lambda v: self._time_update(bool(v)),
                         platform="cuda", mesh=mesh_d)
        return True

    def _time_update(self, pallas):
        """Marginal seconds of one update of this updater's exchange
        under a lowering (reference ``_time_update``): the shared
        :func:`autotune.chain_time` over the real bucket plan on copies
        of the state and synthetic gradients of 1e-3; the live
        parameters and state are not touched."""
        from .. import autotune as _at

        w = [torch.zeros((b.padded,), dtype=getattr(torch, b.dtype),
                         device=self._device) for b in self.plan]
        g = [torch.full_like(x, 1e-3) for x in w]
        states = [tuple(s.clone() for s in st) for st in self._states]

        def body(carry, i):
            self._exchange(carry, g, states, i + 1, pallas)
            return carry

        return _at.chain_time(body, w)

    def _exchange(self, w_flats, g_flats, states, t, pallas):
        """One update of every bucket on flat padded buffers: this
        process's shard of each through :func:`bucket_shard_update`, its
        state updated in place, then the all-gather of the updated
        shards back into ``w_flats``."""
        for i, b in enumerate(self.plan):
            w_sh = shard_slice(w_flats[i], self.n_shards, self.rank)
            g_sh = shard_slice(g_flats[i], self.n_shards, self.rank)
            state = states[i]
            out = (torch.empty_like(w_sh), *state) if pallas else None
            _, uw, us = bucket_shard_update(
                b, self._bucket_opts[i], None, g_sh, state, t,
                n_shards=self.n_shards, idx=self.rank, axis=self._ex,
                seg=None if self._segs is None else self._segs[i],
                pallas=pallas, w_sh=w_sh, out=out)
            for u, o in zip(us, state):
                if u is not o:
                    o.copy_(u)
            self._ex.all_gather(uw, out=w_flats[i])

    def update_all(self, triplets):
        """One step of every ``(name, grad, weight)`` NDArray triplet at
        once (``Module.update`` collects them)."""
        if self._states is None:
            self._gather_per_param()  # raises the state-lost error
        self._sync_hyper_params()
        if self._pallas is None:
            self._pallas = self._decide_variant()
        trip = {n: (g, w) for n, g, w in triplets}
        plan_names = [n for b in self.plan for n in b.names]
        missing = [n for n in plan_names if n not in trip]
        extra = [n for n in trip if n not in set(plan_names)]
        if missing or extra:
            raise MXNetError(
                "sharded update param set diverged from the bucket plan "
                f"(missing {missing[:4]}, unplanned {extra[:4]})")
        weights = {n: trip[n][1] for n in plan_names}
        # a lost collective (resilience.faultsim dist.collective) fires
        # before any bucket is touched: the state stays whole and the
        # drain checkpoint that follows can gather it
        faultsim.inject("dist.collective")
        w_flats = [flatten_bucket(b, {n: weights[n]._data for n in b.names})
                   for b in self.plan]
        g_flats = [flatten_bucket(b, {n: trip[n][0]._data.to(
            self._device) for n in b.names}) for b in self.plan]
        try:
            with torch.no_grad():
                self._exchange(w_flats, g_flats, self._states, self._t + 1,
                               self._pallas)
        except Exception:
            # the buckets before the failure were updated in place: the
            # state no longer matches any step.  _t holds: the step did
            # not happen.
            self._states = None
            raise
        self._t += 1
        # the eager Updater advances num_update on every call; callbacks
        # reading it (decay every K updates) see the same clock
        self.optimizer.num_update = max(
            self._t, int(getattr(self.optimizer, "num_update", 0)))
        with torch.no_grad():
            for b, flat in zip(self.plan, w_flats):
                for n, v in unflatten_bucket(b, flat).items():
                    weights[n]._data.copy_(v)

    def topology(self):
        """This updater's part of the checkpoint ``topology`` block."""
        return {"world_size": self.n_shards,
                "plan_fingerprint": plan_fingerprint(self.plan,
                                                     self.n_shards),
                "n_buckets": len(self.plan)}

    # ---------------------------------------------- checkpoint (legacy)
    def _gather_per_param(self):
        """The sharded states gathered whole (a collective) and split per
        parameter on the host: ``{name: tuple of CPU tensors}``."""
        if self._states is None:
            raise MXNetError(
                "sharded optimizer state was lost when a step failed "
                "mid-exchange (its buckets are updated in place); "
                "restore from the last checkpoint via set_states before "
                "saving or updating again")
        per_param = {}
        for b, st in zip(self.plan, self._states):
            leaves = [self._ex.all_gather(s, role="state").cpu()
                      if s.dim() else s.cpu() for s in st]
            for name, shape, off in zip(b.names, b.shapes, b.offsets):
                n = math.prod(shape)
                per_param[name] = tuple(
                    s[off:off + n].reshape(shape) if s.dim() else s
                    for s in leaves)
        return per_param

    def _flatten_to_plan(self, per_param):
        """The inverse of :meth:`_gather_per_param` on the live plan:
        each bucket's leaves flattened and this process's shard kept,
        on its device."""
        new_states = []
        for b in self.plan:
            ref = per_param[b.names[0]]
            flat = []
            for li in range(len(ref)):
                if torch.as_tensor(ref[li]).dim():
                    whole = flatten_bucket(b, {
                        n: torch.as_tensor(per_param[n][li])
                        for n in b.names})
                    flat.append(shard_slice(whole, self.n_shards, self.rank)
                                .to(self._device, copy=True))
                else:
                    # a replicated scalar, alike across the parameters
                    flat.append(torch.as_tensor(ref[li]).to(self._device))
            new_states.append(tuple(flat))
        return new_states

    def get_states(self, dump_optimizer=False):
        """The states gathered into the per-parameter pickle of the
        eager Updater (``{name: tuple of NDArrays}``), with the step
        count under ``"__step"``; with ``dump_optimizer`` the optimizer
        too, its counters seeded with the step count so an eager resume
        continues Adam's bias correction."""
        import copy
        import pickle

        from ..ndarray import NDArray

        states = {name: tuple(NDArray(leaf.clone()) for leaf in leaves)
                  for name, leaves in self._gather_per_param().items()}
        states["__step"] = (NDArray(torch.tensor([self._t],
                                                 dtype=torch.int64)),)
        if dump_optimizer:
            opt = copy.copy(self.optimizer)
            opt.param_dict = {}
            opt.num_update = opt.begin_num_update = self._t
            opt._index_update_count = {}
            return pickle.dumps((states, opt))
        return pickle.dumps(states)

    def set_states(self, states):
        """Re-shard a per-parameter states pickle on the live plan (the
        inverse of :meth:`get_states`; an eager Updater's file loads the
        same way).  A pickled optimizer the sharded updater cannot run
        is refused, the live one kept."""
        import pickle

        loaded = pickle.loads(states)
        have_opt = isinstance(loaded, tuple) and len(loaded) == 2
        if have_opt:
            loaded, new_opt = loaded
            bad = sharding_rule_reasons(new_opt)
            if bad:
                raise MXNetError(
                    "resumed optimizer states carry an optimizer the "
                    "sharded updater cannot run ({}); resume this "
                    "checkpoint with kvstore='local' (the eager "
                    "updater) instead".format("; ".join(bad)))
            new_opt.param_dict = getattr(self.optimizer, "param_dict", {})
            self.optimizer = new_opt
            self._rebuild_bucket_opts()
            self._hyper_sig = self._current_hyper_sig()
            self._pallas = None  # the kernels' reach may differ
            # the dump's counter is fresher than a "__step" entry an
            # eager run carried along inert
            self._t = int(getattr(new_opt, "num_update", self._t))
        loaded = dict(loaded)
        stp = loaded.pop("__step", None)
        if stp is not None and not have_opt:
            v = stp[0]
            self._t = int(torch.as_tensor(getattr(v, "_data", v))
                          .reshape(-1)[0])
        per_param = {}
        for b in self.plan:
            for name in b.names:
                st = loaded.get(name)
                if st is None:
                    raise MXNetError(
                        f"optimizer states missing parameter {name!r}")
                per_param[name] = tuple(
                    getattr(s, "_data", s) for s in st)
        self._states = self._flatten_to_plan(per_param)
