"""The fused train step (counterpart of ``mxnet_tpu/parallel/__init__.py``).

:func:`functionalize` turns a Gluon block into ``(params, apply_fn)``
over ``torch.func.functional_call``; :func:`make_train_step` builds
``step_fn(params, opt_state, x, y, key, t) -> (loss, params,
opt_state)`` with the reference's contract:

- the replicated arm: the optimizer's per-tensor rule on every
  parameter;
- the ``optimizer_sharding="ps"`` arm under a :class:`Mesh`: the
  parameters live in flat buckets (``parallel.zero``), each process
  updating the shard it owns in one pass — the ``fused_bucket_opt``
  kernel arm runs the hand-written bucket kernels (SGD, Adam, LARS),
  whose fused non-finite count is the dynamic loss scale's verdict; a
  rule that reduces per tensor (LARS) gets each bucket's segment ids.
  ZeRO stage 1 all-reduces each gradient bucket, stage 2 (the default)
  reduce-scatters it, and both gather the updated shards back; stage 3
  keeps the parameters as ``{"_bucket<i>": this process's shard}``, the
  forward all-gathers each bucket (all gathers issued up front) and its
  backward reduce-scatters.  ``gradient_compression={"type": "2bit",
  "threshold": t}`` quantizes the scattered fp32 shard with an
  error-feedback residual ``_residual<i>`` in the optimizer state;
- ``compute_dtype="bfloat16"`` casts every parameter but the norm
  affine/statistics (``NORM_STAT_SUFFIXES``) and the input;
- dynamic or static loss scaling, and ``nan_guard`` (skip the update
  and count consecutive bad steps);
- donation: with ``donate=True`` (the default) the ps arm updates its
  flat buckets in place, and the returned parameters are views into
  them — the input ``params``/``opt_state`` are dead after the call, as
  in the reference.  ``donate=False`` leaves the inputs untouched.

As in the reference, a step leaves BatchNorm running statistics
unchanged: they ride the buckets with a zero gradient, and the layer's
running-average write inside the functional forward is dropped
(``gluon.block.drop_state_writes``; ROADMAP §C).

Telemetry, as in the reference: with ``MXNET_RUNLOG`` set the step
writes a ``compile`` record for each new ``(shape, dtype)`` of its
batch (the retrace causes diffed from the fingerprint) and, on a miss,
runs that call under :func:`~mxnet_tpu_torch.telemetry.describe_call`
for its ``program_report``; ``MXNET_NUMERICS`` puts per-gradient
summaries into the replicated arm's optimizer state under
``_numerics`` (sampled readback; the ps arm warns and runs without,
as the reference's does); ``MXNET_FAULT_SPEC`` naming
``step.loss_nan`` poisons the batch with NaN on the armed hits.

In-step variant tuning, as in the reference: ``sample_data=(x, y)``
races each op of ``variant_ops`` inside chained runs of this step
(``autotune.tune_train_step``), the winners persist in
``autotune.json`` keyed on (op, batch shape, dtype, platform, mesh),
and every call of the returned step enters ``autotune.program_scope``
for its batch, so cached winners apply with or without a race.  The
dtype ladder (``MXNET_DTYPE_LADDER``) adds the compute dtype to the
race: fp32, bf16 (``amp_cast_params``) and, where the knob names it,
the fp8 rung (matmul/conv weights and the input through
``ops.pallas_opt.fp8_qdq`` at delayed per-tensor scales kept in
``opt_state['_fp8']``).

A mesh spans worker processes, one device each (:func:`get_mesh`; ROADMAP
§C): under a mesh of several, ``x`` and ``y`` are this process's rows of
the global batch and the returned loss is the global mean.  The
replicated arm all-reduces each flat gradient bucket and normalizes
BatchNorm with the global batch's statistics, and the fp8 rung scales
the input by the global batch's largest magnitude (an all-reduce of the
max); the ps arm's BatchNorm sees its own rows, as in the reference.
In both arms each process's random layers draw from ``fold_in(key,
rank)``, so no two processes' rows share a mask.  Every process issues
the same collectives in the same order (``ops.collective_ops.Exchange``),
counted per call as ``step_fn.exchange``; the loss-scale and nan-guard
verdicts are global (one all-reduce of the loss and the bad count).

Not ported yet (it raises): tensor parallelism (``param_spec``, ROADMAP
§A 8).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import warnings

import numpy as onp
import torch

from .. import _rng
from ..base import MXNetError
from ..context import resolve_device
from . import zero

__all__ = ["Mesh", "get_mesh", "process_device", "functionalize",
           "make_train_step",
           "DataParallelTrainer", "load_jax_params", "NORM_STAT_SUFFIXES",
           "amp_cast_params", "zero"]

#: parameter-name suffixes that stay fp32 under mixed precision (norm
#: affine and statistics)
NORM_STAT_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                      "moving_mean", "moving_var")


def _is_norm_stat(name):
    return name.endswith(NORM_STAT_SUFFIXES)


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch,
                                                                str(dtype))


def amp_cast_params(params, compute_dtype):
    """Cast ``{name: tensor}`` to ``compute_dtype``, keeping norm
    affine/statistics parameters in their own dtype."""
    if compute_dtype is None:
        return params
    dt = _torch_dtype(compute_dtype)
    return {n: (v if _is_norm_stat(n) else v.to(dt))
            for n, v in params.items()}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``data`` mesh of worker processes, one device each (PyTorch's
    idiom; the reference's mesh spans the devices of its processes).
    ``devices`` holds this process's device; the mesh spans the ``size``
    processes of ``torch.distributed``'s default group, this one being
    ``rank``.  Size 1 is the one-card mesh."""

    devices: tuple
    axis_names: tuple = ("data",)
    size: int = 1
    rank: int = 0

    @property
    def shape(self):
        return {self.axis_names[0]: self.size}


def _world():
    """``(world size, rank)`` of this process's job (``(1, 0)`` outside
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_device(rank=None, device_type=None):
    """This worker's device: on a card (``device_type``, default the
    current context's) ``cuda:{local rank % cards}`` — two ranks on a
    one-card machine both take ``cuda:0`` — else the host."""
    import os

    from ..context import current_context

    kind = device_type or (
        "cuda" if current_context().device_type == "gpu" else "cpu")
    if kind != "cuda":
        return torch.device("cpu")
    if rank is None:
        rank = _world()[1]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return resolve_device(torch.device(
        "cuda", local % max(1, torch.cuda.device_count())))


def get_mesh(shape=None, axis_names=("data",), devices=None):
    """The ``data`` mesh of this job: every worker process of a launched
    job (``tools/launch.py``, ``kvstore.init_distributed``), on this
    process's device (``devices[0]``, default :func:`process_device`);
    outside a job, the one-card mesh.  ``shape``, when given, must be
    the world size.  A mesh over several devices within one process
    raises (ROADMAP §C, the process mesh): launch one process per
    device instead."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise MXNetError("a mesh of more than one axis (tensor "
                         "parallelism) is not ported yet (ROADMAP §A 8)")
    if devices is not None and len(devices) > 1:
        raise MXNetError(
            f"a mesh over {len(devices)} devices within one process is "
            "not how the port spans devices: its mesh spans worker "
            "processes, one device each (ROADMAP §C, the process mesh); "
            "launch one process per device (tools/launch.py)")
    world, rank = _world()
    if shape is not None and math.prod(shape) != world:
        raise MXNetError(
            f"a mesh of shape {tuple(shape)} in a job of {world} worker "
            "processes: the port's mesh spans the job's processes, one "
            "device each (ROADMAP §C, the process mesh)")
    dev = resolve_device(devices[0]) if devices else process_device(rank)
    return Mesh((dev,), axis_names, world, rank)


# ------------------------------------------------------------ functionalize
def functionalize(block, train=False):
    """``(params, apply_fn)`` of a Gluon block.

    params: ``{full name: tensor}`` in the reference's order (the
    block's own tensors, detached).  ``apply_fn(param_dict, *inputs,
    key=None)`` runs the block's forward on ``param_dict`` through
    ``torch.func.functional_call``, in training mode when ``train``;
    layers' state writes (BatchNorm running averages) are dropped, as
    the reference drops them.  Random layers (Dropout) draw from
    generators derived from ``key`` (``_rng.key_scope``; None: the
    reference's fixed key 0), so the same key gives the same masks."""
    from ..gluon.block import _collect_all_params, drop_state_writes

    module_path = {id(m): p for p, m in block.named_modules()}
    paths, params = {}, {}
    for p in _collect_all_params(block):
        owner = module_path[id(p._block)]
        paths.setdefault(p.name, f"{owner}.{p._attr}" if owner else p._attr)
        params.setdefault(p.name, _shaped(p).detach())

    def apply_fn(param_dict, *inputs, key=None):
        tensors = {paths[n]: param_dict[n] for n in paths}
        prev = block.training
        block.train(train)
        try:
            with drop_state_writes(), _rng.key_scope(key):
                return torch.func.functional_call(block, tensors, inputs)
        finally:
            block.train(prev)

    return params, apply_fn


def load_jax_params(net_or_params, arrays):
    """Copy the JAX package's parameters ``{name: array}`` into a port
    block (or a ``{name: tensor}`` dict), matched by name; the block's
    parameters count as initialized after it (a deferred shape must be
    resolved first).  Both packages
    lay convolution weights out alike (``OIHW`` in a channel-first net,
    ``O*kI`` in a channel-last one), so every array copies as it is.
    Any missing, extra or mis-shaped entry raises."""
    if isinstance(net_or_params, torch.nn.Module):
        records = net_or_params.collect_params()
        targets = {n: _shaped(p) for n, p in records.items()}
    else:
        records, targets = {}, dict(net_or_params)
    missing = sorted(set(targets) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing[:5]} "
                         f"({len(missing)}), extra {extra[:5]} "
                         f"({len(extra)})")
    with torch.no_grad():
        for name, t in targets.items():
            a = onp.array(arrays[name], dtype=onp.float32)
            if tuple(a.shape) != tuple(t.shape):
                raise MXNetError(f"load_jax_params: {name} has shape "
                                 f"{tuple(a.shape)}, the port's "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(a).to(t.dtype))
    for p in records.values():
        p._initialized = True
    return net_or_params


def _shaped(param):
    """A parameter's registered tensor; a shape still deferred raises
    (a forward, or ``infer_shape``, resolves it)."""
    from ..gluon.parameter import DeferredInitializationError

    t = param._tensor()
    if t is None:
        raise DeferredInitializationError(
            f"Parameter {param.name} has a deferred shape "
            f"{param._shape}: run a forward (or infer_shape) first")
    return t


# ------------------------------------------------------------ train step
def _build_optimizer(optimizer, learning_rate, momentum, wd, beta1, beta2,
                     epsilon, opt_kwargs):
    """An Optimizer instance from an instance or a registry name, with
    the convenience kwargs filtered to what its constructor takes."""
    from .. import optimizer as opt_mod

    if isinstance(optimizer, opt_mod.Optimizer):
        if opt_kwargs:
            raise MXNetError(
                "optimizer kwargs must not be given when optimizer is an "
                f"Optimizer instance (got {sorted(opt_kwargs)})")
        return optimizer
    klass = opt_mod.Optimizer.opt_registry.get(str(optimizer).lower())
    if klass is None:
        raise MXNetError(f"unknown optimizer {optimizer!r} (ported: "
                         f"{sorted(opt_mod.Optimizer.opt_registry)})")
    accepted = set(inspect.signature(klass.__init__).parameters) | set(
        inspect.signature(opt_mod.Optimizer.__init__).parameters)
    unknown = set(opt_kwargs) - accepted
    if unknown:
        raise MXNetError(
            f"optimizer {optimizer!r} does not accept {sorted(unknown)}")
    kwargs = dict(learning_rate=learning_rate, wd=wd, momentum=momentum,
                  beta1=beta1, beta2=beta2, epsilon=epsilon)
    kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    kwargs.update(opt_kwargs)
    return klass(**kwargs)


def _refuse_unported(param_spec):
    if param_spec:
        raise MXNetError("make_train_step: tensor parallelism (param_spec) "
                         "is not ported yet (ROADMAP §A 8)")


def _zero_stage(zero_stage):
    """``MXNET_ZERO_STAGE`` over the argument (None: unset)."""
    env_stage = zero.resolve_zero_stage()
    stage = env_stage if env_stage is not None else zero_stage
    if stage not in (None, 1, 2, 3):
        raise MXNetError(
            f"unknown zero_stage {stage!r} (use 1, 2 or 3)")
    return stage


def _resolve_ps_mode(optimizer_sharding, zero_stage, mesh):
    """Does the step run the sharded-bucket arm?  The reference's
    precedence: ``MXNET_OPTIMIZER_SHARDING=0`` vetoes even an explicit
    opt-in and ``ps`` opts in when the argument is None;
    ``MXNET_ZERO_STAGE`` overrides ``zero_stage``, and a stage implies
    the arm unless the env vetoed it."""
    ps_mode = optimizer_sharding
    env_ps = zero.resolve_sharding_env()
    if env_ps is False:
        ps_mode = None
    elif ps_mode is None and env_ps == "ps":
        ps_mode = "ps"
    if ps_mode not in (None, False, "", "ps"):
        raise MXNetError(
            f"unknown optimizer_sharding {ps_mode!r} (only 'ps')")
    stage = _zero_stage(zero_stage)
    ps_mode = ps_mode == "ps" or (stage is not None
                                  and env_ps is not False)
    if ps_mode and mesh is None:
        warnings.warn(
            "optimizer_sharding='ps' needs a mesh (nothing to shard over "
            "on one device) — step stays replicated", stacklevel=3)
        ps_mode = False
    return ps_mode


def _compression_threshold(gradient_compression, ps_mode):
    """The 2-bit threshold of ``gradient_compression`` (None: off); it
    needs the sharded arm, as in the reference."""
    if gradient_compression is None:
        return None
    if not ps_mode:
        raise MXNetError(
            "gradient_compression in make_train_step requires "
            "optimizer_sharding='ps' (the replicated step has no "
            "bucketed wire to compress)")
    ctype = gradient_compression.get("type", "2bit")
    if ctype != "2bit":
        raise MXNetError(f"unsupported compression {ctype}")
    return float(gradient_compression.get("threshold", 0.5))


class _GatherBucket(torch.autograd.Function):
    """Stage 3's parameter gather: forward, the whole bucket of a gather
    issued ahead (``pending``: ``[out, work]``), waited on here; backward,
    the reduce-scatter of its gradient to this process's shard."""

    @staticmethod
    def forward(ctx, shard, pending, ex):
        full, work = pending
        if work is not None:
            work.wait()
        ctx.ex = ex
        return full

    @staticmethod
    def backward(ctx, g_full):
        return ctx.ex.reduce_scatter(g_full.contiguous()), None, None


def _bucket_flat(bucket, params):
    """The flat view over ``bucket``'s parameters when they already are
    consecutive views of one storage (the layout the ps step returns),
    else None."""
    first = params[bucket.names[0]]
    ptr = first.untyped_storage().data_ptr()
    start = first.storage_offset()
    for name, off in zip(bucket.names, bucket.offsets):
        t = params[name]
        if (t.untyped_storage().data_ptr() != ptr or t.dtype != first.dtype
                or t.storage_offset() != start + off
                or not t.is_contiguous()):
            return None
    if (start + bucket.padded) * first.element_size() > \
            first.untyped_storage().nbytes():
        return None
    return first.as_strided((bucket.padded,), (1,), start)


def _all_finite(tensors):
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def make_train_step(block, loss_fn, optimizer="sgd", learning_rate=0.01,
                    momentum=0.9, wd=0.0, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, mesh=None, data_axis="data",
                    param_spec=None, donate=True, compute_dtype=None,
                    loss_scale=None, sample_data=None, autotune=None,
                    nan_guard=None, optimizer_sharding=None,
                    bucket_bound=None, zero_stage=None,
                    gradient_compression=None, device=None,
                    variant_ops=None, **opt_kwargs):
    """Build the train step.  Returns ``(step_fn, params, opt_state)``
    with ``step_fn(params, opt_state, x, y, key, t) -> (loss, params,
    opt_state)``; see the module docstring for the arms.  The step runs
    on the mesh's card, or on ``device`` (default ``cuda:0``) without a
    mesh.

    ``sample_data=(x, y)`` races ``variant_ops`` (default
    ``("conv1x1_dot",)``, plus ``"dtype_ladder"`` when
    ``MXNET_DTYPE_LADDER`` arms it, ``compute_dtype`` is None and no
    env pin decides) inside this step before it is returned; on a warm
    cache no step runs.  ``autotune=None`` follows ``MXNET_AUTOTUNE``,
    ``False`` opts this step out of races and cached winners alike.
    Under a mesh ``sample_data`` warns and is ignored (the reference
    times in-step on one device only); winners cached for the mesh key
    still apply."""
    from .. import autotune as _at
    from ..ops import collective_ops as _co
    from ..ops import nn as _nn
    from ..ops import pallas_opt as _po

    _refuse_unported(param_spec)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    world = 1 if mesh is None else mesh.shape[data_axis]
    rank = 0 if mesh is None else mesh.rank
    # the step's collectives over the mesh's processes, counted per call
    ex = _co.Exchange(mesh)
    params, apply_fn = functionalize(block, train=True)
    opt = _build_optimizer(optimizer, learning_rate, momentum, wd, beta1,
                           beta2, epsilon, opt_kwargs)
    cdt = None if compute_dtype is None else _torch_dtype(compute_dtype)
    ps_mode = _resolve_ps_mode(optimizer_sharding, zero_stage, mesh)
    # stage 2 (reduce-scattered gradients) unless a stage was asked for
    stage = (_zero_stage(zero_stage) or 2) if ps_mode else None
    comp_threshold = _compression_threshold(gradient_compression, ps_mode)
    # the replicated step of a process mesh normalizes with the global
    # batch's statistics, as the reference's does under a mesh; the ps
    # step's forward sees its own rows (per-shard statistics), as there
    bn_ex = ex if world > 1 and not ps_mode else None

    if variant_ops is None:
        # the dtype ladder joins the default roster only when the knob
        # arms it, no compute_dtype pins the answer and no env pin
        # already decided it (racing a pinned step wastes the race)
        variant_ops = ("conv1x1_dot",)
        if (compute_dtype is None and _at.dtype_ladder_armed()
                and _at.variant_choice("dtype_ladder") is None):
            variant_ops += ("dtype_ladder",)
    variant_ops = tuple(variant_ops)

    def ladder_arm():
        """This call's dtype-ladder rung (None: not consulted): a force
        scope, the MXNET_DTYPE_LADDER pin or the cached winner that
        ``program_scope`` applies; an explicit compute_dtype wins."""
        if compute_dtype is not None or not _at.dtype_ladder_armed():
            return None
        return _at.variant_choice("dtype_ladder")

    def loss_of(param_dict, x, y, key, fp8=None):
        c = cdt
        arm = ladder_arm()
        if arm == "bf16":
            c = torch.bfloat16
        if arm == "fp8" and fp8 is not None:
            # the fp8 rung: matmul/conv weights and the input snap to
            # the e4m3 grid at the delayed scales of opt_state['_fp8'],
            # their gradients to e5m2; norm parameters and every other
            # op stay fp32.  A cached fp8 winner reaching a step whose
            # build did not provision the state (fp8 None) runs fp32
            gscale = fp8["g"][0]
            # across processes the weights' gradients snap to e5m2 once
            # they are summed (reduce_grads), as the global batch's do
            wscale = gscale if world == 1 else None
            param_dict = {
                n: (_po.fp8_qdq(v, fp8["w"][n][0], wscale)
                    if n in fp8["w"] else v)
                for n, v in param_dict.items()}
            if x.is_floating_point():
                x = _po.fp8_qdq(x, fp8["x"][0], gscale)
        if c is not None:
            param_dict = amp_cast_params(param_dict, c)
            x = x.to(c)
        with _nn.bn_group_scope(bn_ex):
            out = apply_fn(param_dict, x, key=key)
        return loss_fn(out.to(torch.float32), y).mean()

    def scaled_grads(params_, x, y, key, scale, fp8=None, gather=None):
        """(loss · scale, d(loss · scale)/dparams); scale None = 1.
        ``gather`` maps the leaves to the named tree the forward takes
        (stage 3's bucket gathers)."""
        leaves = {n: v.detach().requires_grad_(v.is_floating_point())
                  for n, v in params_.items()}
        loss = loss_of(leaves if gather is None else gather(leaves), x, y,
                       key, fp8)
        if scale is not None:
            loss = loss * scale
        gs = torch.autograd.grad(
            loss, [v for v in leaves.values() if v.requires_grad],
            allow_unused=True)
        it = iter(gs)
        grads = {}
        for n, v in leaves.items():
            g = next(it) if v.requires_grad else None
            grads[n] = torch.zeros_like(v) if g is None else g
        return loss.detach(), grads

    def globalize(loss, finite):
        """The group mean of this process's ``loss`` and the global
        verdict (every process's ``finite``; None: no verdict), in one
        all-reduce of the loss and the bad count.  World 1: as given."""
        if world == 1:
            return loss, finite
        bad = torch.zeros((), dtype=torch.float32, device=dev) \
            if finite is None else (~finite).to(torch.float32)
        pack = ex.all_reduce(torch.stack([loss.to(torch.float32), bad]),
                             role="control")
        return (pack[0] / world).to(loss.dtype), \
            (None if finite is None else pack[1] == 0)

    dynamic = loss_scale == "dynamic"
    static_scale = float(loss_scale) if (
        loss_scale is not None and not dynamic) else 1.0
    names = list(params)
    f32 = dict(dtype=torch.float32, device=dev)

    if ps_mode:
        n_sh = world
        zero.check_bucket_rule(opt)
        plan = zero.plan_buckets(params, n_sh, capacity=bucket_bound)
        bucket_keys = zero.stage3_param_keys(plan)
        # fresh flat buckets on the device, rank 0's everywhere; stages
        # 1/2 return views of them, stage 3 keeps this rank's shards
        flats = [ex.broadcast(zero.flatten_bucket(b, params).to(dev))
                 for b in plan]
        if stage == 3:
            params = {bk: zero.mark_shard(
                zero.shard_slice(flat, n_sh, rank).clone(), mesh)
                for bk, flat in zip(bucket_keys, flats)}
        else:
            views = {}
            for b, flat in zip(plan, flats):
                views.update(zero.unflatten_bucket(b, flat))
            params = {n: views[n] for n in names}
        # the optimizer state of the owned shard only
        opt_state = {bk: tuple(
            zero.mark_shard(v, mesh) for v in opt.fused_state(
                zero.shard_slice(flat, n_sh, rank)))
            for bk, flat in zip(bucket_keys, flats)}
        if comp_threshold is not None:
            # the error-feedback residual: fp32, of the owned shard
            for i, b in enumerate(plan):
                opt_state[f"_residual{i}"] = zero.mark_shard(torch.zeros(
                    (b.padded // n_sh,), **f32), mesh)
        # per-tensor reductions (LARS) need each element's tensor index
        seg_info = None if opt.fused_elementwise else [
            (ids.to(dev), nseg) for ids, nseg in map(zero.bucket_segments,
                                                     plan)]
    else:
        params = {n: v.to(dev, copy=True) for n, v in params.items()}
        if world > 1:
            # the gradient buckets of the replicated step; the replicas
            # start from rank 0's weights
            rplan = zero.plan_buckets(params, 1, capacity=bucket_bound)
            for b in rplan:
                params.update(zero.unflatten_bucket(
                    b, ex.broadcast(zero.flatten_bucket(b, params))))
        opt_state = {n: opt.fused_state(v) for n, v in params.items()}
    if dynamic:
        opt_state["_loss_scale"] = (
            torch.tensor(2.0 ** 16, **f32),  # initial scale (reference amp)
            torch.zeros((), dtype=torch.int32, device=dev))
    if nan_guard is None:
        from ..config import get_env

        nan_guard = get_env("MXNET_BAD_STEP_LIMIT") > 0
    nan_guard = bool(nan_guard) and not dynamic
    if nan_guard:
        opt_state["_bad_steps"] = torch.zeros((), dtype=torch.int32,
                                              device=dev)

    # the numerics monitor: per-gradient summaries ride in the returned
    # state under _numerics (no host sync); the telemetry wrapper below
    # reads them back only on sampled steps.  Unarmed, the step is the
    # step without it.
    from ..telemetry import numerics as _nm

    numerics_on = _nm.armed()
    if numerics_on and ps_mode:
        warnings.warn(
            "MXNET_NUMERICS under optimizer_sharding='ps' is not "
            "supported yet (gradients live as scattered bucket "
            "shards, not named tensors) — monitor disabled for this "
            "step", stacklevel=2)
        numerics_on = False
    if numerics_on:
        opt_state["_numerics"] = _nm.summary_template(
            dict.fromkeys([*names, "__loss"]), device=dev)

    # the fp8 rung's delayed-scaling state, provisioned at build time
    # whenever the armed roster names fp8 (the race's fp8 arm and a
    # cached fp8 winner both need it in the state every arm threads
    # through), absent otherwise: an unarmed build is today's step.
    # One (scale, amax history) pair per matmul/conv weight, one for
    # the input, one e5m2 pair for the gradients.  Not composed with
    # the sharded-bucket arm (its gradients are flat buckets), as in
    # the reference
    fp8_rung = (compute_dtype is None and _at.dtype_ladder_armed()
                and "fp8" in _at.ladder_rungs() and not ps_mode)
    if fp8_rung:
        from ..config import get_env

        hist_len = max(1, int(get_env("MXNET_FP8_AMAX_HISTORY")))

        def fp8_pair():
            # step 1's scale is the identity until a real amax is seen
            return (torch.ones((), **f32), torch.zeros((hist_len,), **f32))

        opt_state["_fp8"] = {
            "x": fp8_pair(), "g": fp8_pair(),
            "w": {n: fp8_pair() for n in names
                  if not _is_norm_stat(n) and params[n].dim() >= 2}}

    def fp8_bookkeeping(fp8_state, params_, x, grads):
        """This step's |t|_inf of each quantized tensor class rolled into
        its history, and the next step's scales (on the device; an
        overflowed observation backs the scale off)."""
        _, xh = fp8_state["x"]
        if x.is_floating_point():
            x_amax = x.to(torch.float32).abs().max()
            # the global batch's: every process sees only its rows
            x_amax = ex.all_reduce(x_amax.reshape(1), role="fp8",
                                   op="max")[0]
        else:
            x_amax = xh.max()  # integer inputs never quantize
        nh, ns = _po.fp8_delayed_scale(xh, x_amax)
        new = {"x": (ns, nh)}
        _, gh = fp8_state["g"]
        g_amax = torch.zeros((), **f32)
        for n in fp8_state["w"]:
            g_amax = torch.maximum(g_amax,
                                   grads[n].to(torch.float32).abs().max())
        ngh, ngs = _po.fp8_delayed_scale(gh, g_amax, fmax=_po.E5M2_MAX)
        new["g"] = (ngs, ngh)
        new["w"] = {}
        for n, (_, wh) in fp8_state["w"].items():
            nwh, nws = _po.fp8_delayed_scale(
                wh, params_[n].to(torch.float32).abs().max())
            new["w"][n] = (nws, nwh)
        return new

    def nm_pack(grads, loss):
        stats = _nm.summarize_tree(grads)
        stats["__loss"] = _nm.summary(loss)
        return stats

    def guarded(finite, up_p, up_s, params_, opt_state_):
        new_p = {n: torch.where(finite, up_p[n], params_[n]) for n in names}
        new_s = {n: tuple(torch.where(finite, u, o)
                          for u, o in zip(up_s[n], opt_state_[n]))
                 for n in names}
        return new_p, new_s

    def apply_updates(params_, opt_state_, grads, t):
        new_p, new_s = {}, {}
        for n in names:
            new_p[n], new_s[n] = opt.fused_update(params_[n], grads[n],
                                                  opt_state_[n], t)
        return new_p, new_s

    def reduce_grads(grads, fp8=None):
        """The replicated step's exchange: the local mean loss's
        gradients summed over the processes, one all-reduce a bucket,
        and divided by the world (world 1: as given).  Under the fp8
        rung the summed weight gradients then snap to e5m2."""
        if world == 1:
            return grads
        out = {}
        for b in rplan:
            flat = ex.all_reduce(zero.flatten_bucket(b, grads))
            out.update(zero.unflatten_bucket(b, flat.div_(world)))
        if fp8 is not None:
            for n in fp8["w"]:
                out[n] = _po.fp8_grad_qdq(out[n], fp8["g"][0])
        return out

    def replicated_step(params_, opt_state_, x, y, key, t):
        # each process's random layers draw from its own key, so its
        # rows get masks of their own (one card: the key)
        if world > 1:
            key = _rng.fold_in(0 if key is None else key, rank)
        # the fp8 rung, decided for this call: the delayed scales go
        # into the loss and this step's amax observations into the
        # histories — on every step, a skipped one included (the
        # overflow observation is what backs the scale off).  On the
        # other rungs the provisioned state passes through untouched
        fp8_state = opt_state_["_fp8"] if fp8_rung else None
        fp8 = fp8_state if fp8_rung and ladder_arm() == "fp8" else None

        def fp8_carry(new_s, grads):
            if fp8_rung:
                new_s["_fp8"] = fp8_state if fp8 is None else \
                    fp8_bookkeeping(fp8_state, params_, x, grads)
            return new_s

        if dynamic:
            scale, good = opt_state_["_loss_scale"]
            sloss, sgrads = scaled_grads(params_, x, y, key, scale, fp8)
            sgrads = reduce_grads(sgrads, fp8)
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in sgrads.items()}
            sloss, finite = globalize(sloss, _all_finite(grads.values()))
            new_p, new_s = guarded(finite, *apply_updates(
                params_, opt_state_, grads, t), params_, opt_state_)
            new_s["_loss_scale"] = _po.scale_bookkeeping(finite, scale,
                                                         good)
            new_s = fp8_carry(new_s, grads)
            if numerics_on:
                new_s["_numerics"] = nm_pack(grads, sloss / scale)
            # unscale with the scale the loss was computed with
            return sloss / scale, new_p, new_s
        if static_scale != 1.0:
            loss, grads = scaled_grads(params_, x, y, key, static_scale,
                                       fp8)
            grads = reduce_grads(grads, fp8)
            loss = loss / static_scale
            grads = {n: g / static_scale for n, g in grads.items()}
        else:
            loss, grads = scaled_grads(params_, x, y, key, None, fp8)
            grads = reduce_grads(grads, fp8)
        if nan_guard:
            loss, finite = globalize(
                loss, torch.isfinite(loss) & _all_finite(grads.values()))
            new_p, new_s = guarded(finite, *apply_updates(
                params_, opt_state_, grads, t), params_, opt_state_)
            new_s["_bad_steps"] = torch.where(
                finite, torch.zeros_like(opt_state_["_bad_steps"]),
                opt_state_["_bad_steps"] + 1)
            new_s = fp8_carry(new_s, grads)
            if numerics_on:
                # the step as it happened, guard or no guard: the bad
                # step's NaN counts are the explanation
                new_s["_numerics"] = nm_pack(grads, loss)
            return loss, new_p, new_s
        loss, _ = globalize(loss, None)
        new_p, new_s = apply_updates(params_, opt_state_, grads, t)
        new_s = fp8_carry(new_s, grads)
        if numerics_on:
            new_s["_numerics"] = nm_pack(grads, loss)
        return loss, new_p, new_s

    if ps_mode:
        check_finite = dynamic or nan_guard
        # the fused_bucket_opt lowering, resolved at build time under
        # the plan's flat key; None (undecided on the host) leaves it
        # to each call's variant_choice (a force scope or a winner of
        # the program scope)
        ps_pallas = zero.resolve_bucket_variant(opt, plan, mesh, stage)
        # stages 1/2 gather each updated shard back into its flat bucket
        gather_back = stage != 3 and n_sh > 1

        def stage3_gather(leaves):
            """The named tree of stage 3's bucket shards: every bucket's
            all-gather issued up front, each waited on as the forward's
            tree is built, their backward the reduce-scatter."""
            pending = [list(ex.all_gather(leaves[bk].detach(),
                                          async_op=True))
                       for bk in bucket_keys]
            named = {}
            for bk, b, pend in zip(bucket_keys, plan, pending):
                named.update(zero.unflatten_bucket(
                    b, _GatherBucket.apply(leaves[bk], pend, ex)))
            return named

        def ps_step(params_, opt_state_, x, y, key, t):
            scale = opt_state_["_loss_scale"][0] if dynamic else None
            # each process's random layers draw from its own key (the
            # reference's fold_in of the shard index); one card: the key
            if world > 1:
                key = _rng.fold_in(0 if key is None else key, rank)
            lval, lgrads = scaled_grads(
                params_, x, y, key,
                scale if dynamic else
                (static_scale if static_scale != 1.0 else None),
                gather=stage3_gather if stage == 3 else None)
            # grad of the global mean loss = sum of shard grads / N; the
            # unscale folds into the same multiply
            inv = 1.0 / n_sh
            if dynamic:
                inv = inv / scale
            elif static_scale != 1.0:
                inv = inv / static_scale
            # dynamic scaling's verdict is gradient finiteness only; the
            # nan guard also checks the loss
            finite = None
            if nan_guard:
                finite = torch.isfinite(lval)
            elif dynamic:
                finite = torch.ones((), dtype=torch.bool, device=dev)
            staged = []
            for i, (bk, b) in enumerate(zip(bucket_keys, plan)):
                state = opt_state_[bk]
                if not donate:
                    state = tuple(s.clone() for s in state)
                if stage == 3:
                    # the shard is the parameter; its gradient arrived
                    # summed and scattered through the gather's backward
                    w_flat = None
                    w_sh = params_[bk] if donate else params_[bk].clone()
                    g_sh = lgrads[bk]
                else:
                    w_flat = _bucket_flat(b, params_) if donate else None
                    if w_flat is None:
                        w_flat = zero.flatten_bucket(b, params_)
                    w_sh = zero.shard_slice(w_flat, n_sh, rank)
                    g_full = zero.flatten_bucket(b, lgrads)
                    if stage == 1:
                        # one all-reduce; the owned shard sliced off it
                        g_sh = zero.shard_slice(ex.all_reduce(g_full), n_sh,
                                                rank)
                    else:
                        g_sh = ex.reduce_scatter(g_full)
                g32 = g_sh.to(torch.float32)
                if not (isinstance(inv, float) and inv == 1.0):
                    g32 = g32 * inv
                new_resid = None
                if comp_threshold is not None:
                    from ..kvstore import quantize_2bit

                    # the verdict is the raw gradient's, taken before
                    # the quantize (the kernel's would see {-t, 0, t})
                    if check_finite:
                        finite = finite & torch.isfinite(g32).all()
                    g32, new_resid = quantize_2bit(
                        g32 + opt_state_[f"_residual{i}"], comp_threshold)
                want_fin = check_finite and comp_threshold is None
                # in place unless the verdict may hold the update back;
                # a shard to gather back takes a buffer of its own
                out = None
                if not check_finite:
                    out = (torch.empty_like(w_sh) if gather_back else w_sh,
                           *state)
                res = zero.bucket_shard_update(
                    b, opt, params_, g32, state, t, n_shards=n_sh, idx=rank,
                    axis=ex, seg=None if seg_info is None else seg_info[i],
                    pallas=ps_pallas, want_finite=want_fin, w_sh=w_sh,
                    out=out)
                if want_fin:
                    _, uw, us, bfin = res
                    finite = finite & (bfin if bfin is not None
                                       else torch.isfinite(g32).all())
                else:
                    _, uw, us = res
                staged.append((i, bk, b, w_flat, w_sh, uw, state, us,
                               new_resid))
            loss, finite = globalize(lval, finite)
            new_p, new_s = {}, {}
            for i, bk, b, w_flat, w_sh, uw, state, us, new_resid in staged:
                if check_finite:
                    # skip the update on a bad step: shard, state and
                    # residual hold
                    if gather_back:
                        uw = torch.where(finite, uw, w_sh)
                    else:
                        uw = torch.where(finite, uw, w_sh, out=w_sh)
                    for u, o in zip(us, state):
                        torch.where(finite, u, o, out=o)
                    if new_resid is not None:
                        new_resid = torch.where(
                            finite, new_resid, opt_state_[f"_residual{i}"])
                else:
                    if not gather_back and uw is not w_sh:
                        uw = w_sh.copy_(uw)
                    for u, o in zip(us, state):
                        if u is not o:
                            o.copy_(u)
                # the shards stay tagged for host_gather
                new_s[bk] = tuple(zero.mark_shard(o, mesh) for o in state)
                if new_resid is not None:
                    new_s[f"_residual{i}"] = zero.mark_shard(new_resid, mesh)
                if stage == 3:
                    new_p[bk] = zero.mark_shard(uw, mesh)
                    continue
                if gather_back:
                    ex.all_gather(uw, out=w_flat)
                new_p.update(zero.unflatten_bucket(b, w_flat))
            if dynamic:
                new_s["_loss_scale"] = _po.scale_bookkeeping(
                    finite, scale, opt_state_["_loss_scale"][1])
                loss = loss / scale
            elif static_scale != 1.0:
                loss = loss / static_scale
            if nan_guard:
                new_s["_bad_steps"] = torch.where(
                    finite, torch.zeros_like(opt_state_["_bad_steps"]),
                    opt_state_["_bad_steps"] + 1)
            return loss, {n: new_p[n] for n in (
                bucket_keys if stage == 3 else names)}, new_s

    inner = ps_step if ps_mode else replicated_step

    def step(params_, opt_state_, x, y, key, t):
        # ``key`` seeds the step's random layers (None: key 0)
        return inner(params_, opt_state_, torch.as_tensor(x).to(dev),
                     torch.as_tensor(y).to(dev), key, t)

    # ---- the in-step variant race (autotune.tune_train_step)
    mesh_d = _at.mesh_desc(mesh)
    tune_level = None if autotune is None else int(autotune)
    if sample_data is not None and _at.enabled(tune_level):
        if mesh is None:
            xs, ys = sample_data
            _at.tune_train_step(
                step, params, opt_state, torch.as_tensor(xs).to(dev),
                torch.as_tensor(ys).to(dev), None, variant_ops=variant_ops,
                platform=dev.type, mesh=mesh_d, level=tune_level)
        else:
            warnings.warn(
                "make_train_step: in-step autotuning under a mesh is not "
                "yet supported; sample_data ignored (cached winners for "
                "this mesh key still apply)", stacklevel=2)

    def step_fn(params_, opt_state_, x, y, key, t):
        # the cached winners of this batch's signature apply to the call
        # (autotune=False opts the step out)
        x = torch.as_tensor(x)
        if not _at.enabled(tune_level):
            return step(params_, opt_state_, x, y, key, t)
        with _at.program_scope(x.shape, x.dtype, platform=dev.type,
                               mesh=mesh_d):
            return step(params_, opt_state_, x, y, key, t)

    step_fn = _observed(step_fn, opt, stage, numerics_on, dev,
                        variant_ops, mesh_d, tune_level)
    if mesh is not None:
        # each call's collectives, counted: step_fn.exchange
        counted = step_fn

        def step_fn(p, o, x, y, key, t):
            ex.reset()
            result = counted(p, o, x, y, key, t)
            step_fn.exchange = ex.counts()
            return result

        ex.reset()
        step_fn.exchange = ex.counts()
    if ps_mode:
        step_fn.zero_stage = stage
        step_fn.zero_plan = plan
    return step_fn, params, opt_state


def _observed(inner, opt, stage, numerics_on, dev, variant_ops, mesh_d,
              tune_level):
    """The telemetry and fault wrappers of the reference
    (``mxnet_tpu/parallel/__init__.py:951-1052``) around a built step.

    Per call with nothing armed: one ``telemetry.current()`` lookup.
    Armed: a ``compile`` record for each new ``(shape, dtype)`` of the
    batch — a signature seen before that recurs after a change is a
    cache ``hit``; its fingerprint's winners are the cached winners of
    ``variant_ops`` under the step's platform and mesh key — and, on a
    miss, the call itself runs under
    ``describe_call`` for the ``program_report``; the numerics
    summaries are read back on sampled steps.  ``step.loss_nan`` armed
    in ``MXNET_FAULT_SPEC`` poisons the batch with NaN on its armed
    hits, before the step, so the step's guard sees a non-finite step.
    """
    from .. import autotune as _at
    from .. import telemetry as _tm
    from ..resilience import faultsim
    from ..telemetry import numerics as _nm

    hyper = {k: v for k, v in sorted(vars(opt).items())
             if not k.startswith("_")
             and isinstance(v, (int, float, bool, str, type(None)))}
    # stage 2 keeps the reference's "ps" stamp; stages 1/3 name
    # themselves, so a stage flip reads as a retrace cause
    sharding = "none" if stage is None else (
        "ps" if stage == 2 else f"zero{stage}")
    seen = set()
    last = [None]
    nm_period = _nm.sample_period() if numerics_on else 0
    nm_step = [0]

    def step_fn(p, o, x, y, key, t):
        rl = _tm.current()
        result = None
        if rl is not None:
            sig = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            if sig not in seen or sig != last[0]:
                cache = "hit" if sig in seen else "miss"
                ran = [False]

                def call(*a):
                    ran[0] = True
                    return inner(*a)

                try:
                    winners = {}
                    if _at.enabled(tune_level):
                        winners = {op: _at.lookup(op, sig[0], sig[1],
                                                  platform=dev.type,
                                                  mesh=mesh_d)
                                   for op in variant_ops}
                    rl.compile_event(
                        "train_step",
                        _tm.compile_fingerprint(
                            sig[0], sig[1], True, winners=winners,
                            hyper=hyper, sharding=sharding),
                        cache=cache)
                    if cache == "miss":
                        # memory and FLOPs of the call about to run
                        result, _ = _tm.describe_call(
                            call, p, o, x, y, key, t,
                            program="train_step")
                except Exception:
                    if ran[0]:
                        raise  # the step itself failed
                    result = None  # telemetry must never kill the step
                seen.add(sig)
                last[0] = sig
        if result is None:
            result = inner(p, o, x, y, key, t)
        if numerics_on and rl is not None:
            # sampled readback of the summaries: the only steps that pay
            # a device sync for the monitor
            try:
                vecs = result[2].get("_numerics")
                if vecs is not None:
                    i = nm_step[0]
                    nm_step[0] = i + 1
                    if i % nm_period == 0:
                        _nm.emit(rl, i, vecs, where="grad")
            except Exception:
                pass  # the monitor must never kill the step
        return result

    if faultsim.armed("step.loss_nan"):
        # fault harness only: the disarmed fast path never grows this
        # wrapper
        observed = step_fn

        def step_fn(p, o, x, y, key, t):
            if faultsim.inject("step.loss_nan") == "nan":
                # integer dtypes have no NaN: poison the first inexact
                # input (token-id models poison through float labels)
                x, y = torch.as_tensor(x), torch.as_tensor(y)
                if x.is_floating_point():
                    x = x * torch.tensor(float("nan"), dtype=x.dtype)
                elif y.is_floating_point():
                    y = y * torch.tensor(float("nan"), dtype=y.dtype)
                else:
                    warnings.warn(
                        "step.loss_nan injection skipped: neither x "
                        "nor y has an inexact dtype to poison",
                        stacklevel=2)
            return observed(p, o, x, y, key, t)

    return step_fn


class DataParallelTrainer:
    """The fused training driver: one object owning the parameters, the
    optimizer state and the step of :func:`make_train_step` (same
    arguments).  Call :meth:`fit_batch` per batch and
    :meth:`sync_to_block` to write the weights back into the block (at
    ZeRO stage 3 the bucket shards gather to the named tree first)."""

    def __init__(self, block, loss_fn, optimizer="sgd", mesh=None,
                 **opt_kwargs):
        self._block = block
        self._step_fn, self._params, self._opt_state = make_train_step(
            block, loss_fn, optimizer=optimizer, mesh=mesh, **opt_kwargs)
        self._t = 0
        self._key = 0  # the reference's jax.random.key(0)

    @property
    def step_fn(self):
        return self._step_fn

    def fit_batch(self, x, y):
        """One step on the batch ``(x, y)`` with a fresh key split off
        the trainer's; returns the loss tensor."""
        self._t += 1
        self._key, sub = _rng.split(self._key)
        loss, self._params, self._opt_state = self._step_fn(
            self._params, self._opt_state, x, y, sub, float(self._t))
        return loss

    @property
    def params(self):
        return self._params

    @property
    def opt_state(self):
        return self._opt_state

    def sync_to_block(self):
        """Copy the trained parameters into the block's tensors; stage 3's
        bucket shards are gathered over the mesh's processes first
        (every process must call it)."""
        from ..gluon.block import _collect_all_params

        params = self._params
        if getattr(self._step_fn, "zero_stage", None) == 3:
            from ..resilience.elastic import host_gather

            params = zero.gather_stage3_params(
                self._step_fn.zero_plan,
                {k: host_gather(v) for k, v in params.items()})
        with torch.no_grad():
            for p in _collect_all_params(self._block):
                if p.name in params:
                    t = p._tensor()
                    t.copy_(torch.as_tensor(params[p.name]).to(t.device))
