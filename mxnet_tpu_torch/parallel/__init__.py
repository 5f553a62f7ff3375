"""The fused train step (counterpart of ``mxnet_tpu/parallel/__init__.py``).

:func:`functionalize` turns a Gluon block into ``(params, apply_fn)``
over ``torch.func.functional_call``; :func:`make_train_step` builds
``step_fn(params, opt_state, x, y, key, t) -> (loss, params,
opt_state)`` with the reference's contract:

- the replicated arm: the optimizer's per-tensor rule on every
  parameter;
- the ``optimizer_sharding="ps"`` arm on a one-card :class:`Mesh`: the
  parameters live in flat buckets (``parallel.zero``), each updated in
  one pass — the ``fused_bucket_opt`` kernel arm runs the hand-written
  bucket kernels (SGD, Adam, LARS), whose fused non-finite count is the
  dynamic loss scale's verdict; a rule that reduces per tensor (LARS)
  gets each bucket's segment ids;
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

Not ported yet (they raise): in-step variant tuning (``sample_data``,
a true ``autotune``),
tensor parallelism (``param_spec``), ZeRO stages 1 and 3, gradient
compression, the dtype ladder and fp8, the numerics monitor, and any
mesh of more than one card.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import os
import warnings

import numpy as onp
import torch

from .. import _rng
from ..base import MXNetError
from ..context import resolve_device
from . import zero

__all__ = ["Mesh", "get_mesh", "functionalize", "make_train_step",
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
    """A device mesh; the port has the one-card mesh only."""

    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def shape(self):
        return dict(zip(self.axis_names, (len(self.devices),)))


def get_mesh(shape=None, axis_names=("data",), devices=None):
    """A one-card ``data`` mesh over ``devices[0]`` (default ``cuda:0``).
    A mesh over more than one card raises until the multi-card slice
    (ROADMAP §A 11)."""
    devs = [resolve_device(None)] if devices is None \
        else [resolve_device(d) for d in devices]
    size = len(devs) if shape is None else math.prod(shape)
    if size != 1 or len(tuple(axis_names)) != 1:
        raise MXNetError("a mesh over more than one card is not ported "
                         "yet (ROADMAP §A 11)")
    return Mesh((devs[0],), tuple(axis_names))


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


def _refuse_unported(param_spec, sample_data, autotune,
                     gradient_compression, compute_dtype):
    def armed(var):
        raw = os.environ.get(var)
        return raw is not None and raw.lower() not in (
            "", "0", "off", "false", "no")

    for what, bad in (
            ("tensor parallelism (param_spec)", param_spec),
            ("in-step variant tuning (sample_data, autotune)",
             sample_data is not None or bool(autotune)),
            ("gradient_compression", gradient_compression is not None),
            ("the dtype ladder and fp8 (MXNET_DTYPE_LADDER)",
             compute_dtype is None and armed("MXNET_DTYPE_LADDER")),
            ("the numerics monitor (MXNET_NUMERICS)",
             armed("MXNET_NUMERICS"))):
        if bad:
            raise MXNetError(f"make_train_step: {what} is not ported yet "
                             "(ROADMAP §A)")


def _resolve_ps_mode(optimizer_sharding, zero_stage, mesh):
    """Does the step run the sharded-bucket arm?  A ``zero_stage``
    implies it; stage 2 is the one ported."""
    if optimizer_sharding not in (None, False, "", "ps"):
        raise MXNetError(
            f"unknown optimizer_sharding {optimizer_sharding!r} (only 'ps')")
    if zero_stage not in (None, 1, 2, 3):
        raise MXNetError(
            f"unknown zero_stage {zero_stage!r} (use 1, 2 or 3)")
    if zero_stage in (1, 3):
        raise MXNetError(f"ZeRO stage {zero_stage} is not ported yet "
                         "(ROADMAP §A 11)")
    ps_mode = optimizer_sharding == "ps" or zero_stage is not None
    if ps_mode and mesh is None:
        warnings.warn(
            "optimizer_sharding='ps' needs a mesh (nothing to shard over "
            "on one device) — step stays replicated", stacklevel=3)
        ps_mode = False
    return ps_mode


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
                    gradient_compression=None, device=None, **opt_kwargs):
    """Build the train step.  Returns ``(step_fn, params, opt_state)``
    with ``step_fn(params, opt_state, x, y, key, t) -> (loss, params,
    opt_state)``; see the module docstring for the arms.  The step runs
    on the mesh's card, or on ``device`` (default ``cuda:0``) without a
    mesh."""
    from ..ops import pallas_opt as _po

    _refuse_unported(param_spec, sample_data, autotune,
                     gradient_compression, compute_dtype)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    params, apply_fn = functionalize(block, train=True)
    opt = _build_optimizer(optimizer, learning_rate, momentum, wd, beta1,
                           beta2, epsilon, opt_kwargs)
    cdt = None if compute_dtype is None else _torch_dtype(compute_dtype)

    def loss_of(param_dict, x, y, key):
        if cdt is not None:
            param_dict = amp_cast_params(param_dict, cdt)
            x = x.to(cdt)
        out = apply_fn(param_dict, x, key=key)
        return loss_fn(out.to(torch.float32), y).mean()

    def scaled_grads(params_, x, y, key, scale):
        """(loss · scale, d(loss · scale)/dparams); scale None = 1."""
        leaves = {n: v.detach().requires_grad_(v.is_floating_point())
                  for n, v in params_.items()}
        loss = loss_of(leaves, x, y, key)
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

    dynamic = loss_scale == "dynamic"
    static_scale = float(loss_scale) if (
        loss_scale is not None and not dynamic) else 1.0
    ps_mode = _resolve_ps_mode(optimizer_sharding, zero_stage, mesh)
    names = list(params)
    f32 = dict(dtype=torch.float32, device=dev)

    if ps_mode:
        n_sh = mesh.shape[data_axis]
        zero.check_bucket_rule(opt)
        plan = zero.plan_buckets(params, n_sh, capacity=bucket_bound)
        bucket_keys = zero.stage3_param_keys(plan)
        # fresh flat buckets on the card; the returned params are views
        flats = [zero.flatten_bucket(b, params).to(dev) for b in plan]
        views = {}
        for b, flat in zip(plan, flats):
            views.update(zero.unflatten_bucket(b, flat))
        params = {n: views[n] for n in names}
        opt_state = {bk: opt.fused_state(flat)
                     for bk, flat in zip(bucket_keys, flats)}
        # per-tensor reductions (LARS) need each element's tensor index
        seg_info = None if opt.fused_elementwise else [
            (ids.to(dev), nseg) for ids, nseg in map(zero.bucket_segments,
                                                     plan)]
    else:
        params = {n: v.to(dev, copy=True) for n, v in params.items()}
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

    def replicated_step(params_, opt_state_, x, y, key, t):
        if dynamic:
            scale, good = opt_state_["_loss_scale"]
            sloss, sgrads = scaled_grads(params_, x, y, key, scale)
            inv = 1.0 / scale
            grads = {n: g * inv for n, g in sgrads.items()}
            finite = _all_finite(grads.values())
            new_p, new_s = guarded(finite, *apply_updates(
                params_, opt_state_, grads, t), params_, opt_state_)
            new_s["_loss_scale"] = _po.scale_bookkeeping(finite, scale,
                                                         good)
            # unscale with the scale the loss was computed with
            return sloss / scale, new_p, new_s
        if static_scale != 1.0:
            loss, grads = scaled_grads(params_, x, y, key, static_scale)
            loss = loss / static_scale
            grads = {n: g / static_scale for n, g in grads.items()}
        else:
            loss, grads = scaled_grads(params_, x, y, key, None)
        if nan_guard:
            finite = torch.isfinite(loss) & _all_finite(grads.values())
            new_p, new_s = guarded(finite, *apply_updates(
                params_, opt_state_, grads, t), params_, opt_state_)
            new_s["_bad_steps"] = torch.where(
                finite, torch.zeros_like(opt_state_["_bad_steps"]),
                opt_state_["_bad_steps"] + 1)
            return loss, new_p, new_s
        new_p, new_s = apply_updates(params_, opt_state_, grads, t)
        return loss, new_p, new_s

    if ps_mode:
        check_finite = dynamic or nan_guard
        ps_pallas = zero.resolve_bucket_variant()

        def ps_step(params_, opt_state_, x, y, key, t):
            scale = opt_state_["_loss_scale"][0] if dynamic else None
            lval, lgrads = scaled_grads(
                params_, x, y, key,
                scale if dynamic else
                (static_scale if static_scale != 1.0 else None))
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
                w_flat = _bucket_flat(b, params_) if donate else None
                state = opt_state_[bk]
                if w_flat is None:
                    w_flat = zero.flatten_bucket(b, params_)
                if not donate:
                    state = tuple(s.clone() for s in state)
                # stage 2 at one shard: the reduce-scatter is the identity
                g32 = zero.flatten_bucket(b, lgrads).to(torch.float32)
                if not (isinstance(inv, float) and inv == 1.0):
                    g32 = g32 * inv
                res = zero.bucket_shard_update(
                    b, opt, params_, g32, state, t, n_shards=n_sh, idx=0,
                    seg=None if seg_info is None else seg_info[i],
                    pallas=ps_pallas, want_finite=check_finite, w_sh=w_flat,
                    out=None if check_finite else (w_flat, *state))
                if check_finite:
                    _, uw, us, bfin = res
                    finite = finite & (bfin if bfin is not None
                                       else torch.isfinite(g32).all())
                else:
                    _, uw, us = res
                staged.append((bk, b, w_flat, uw, state, us))
            new_p, new_s = {}, {}
            for bk, b, w_flat, uw, state, us in staged:
                if check_finite:
                    # skip the update on a bad step: shard and state hold
                    torch.where(finite, uw, w_flat, out=w_flat)
                    for u, o in zip(us, state):
                        torch.where(finite, u, o, out=o)
                else:
                    if uw is not w_flat:
                        w_flat.copy_(uw)
                    for u, o in zip(us, state):
                        if u is not o:
                            o.copy_(u)
                new_s[bk] = state
                new_p.update(zero.unflatten_bucket(b, w_flat))
            loss = lval
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
            return loss, {n: new_p[n] for n in names}, new_s

    inner = ps_step if ps_mode else replicated_step

    def step_fn(params_, opt_state_, x, y, key, t):
        # ``key`` seeds the step's random layers (None: key 0); one card,
        # so the reference's per-shard fold_in of the shard index 0 is
        # the key itself
        return inner(params_, opt_state_, torch.as_tensor(x).to(dev),
                     torch.as_tensor(y).to(dev), key, t)

    if ps_mode:
        step_fn.zero_stage = 2
        step_fn.zero_plan = plan
    return step_fn, params, opt_state


class DataParallelTrainer:
    """The fused training driver: one object owning the parameters, the
    optimizer state and the step of :func:`make_train_step` (same
    arguments).  Call :meth:`fit_batch` per batch and
    :meth:`sync_to_block` to write the weights back into the block.
    ZeRO stage 3, whose parameters live as bucket shards, is not ported
    (``make_train_step`` raises)."""

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
        """Copy the trained parameters into the block's tensors."""
        from ..gluon.block import _collect_all_params

        with torch.no_grad():
            for p in _collect_all_params(self._block):
                if p.name in self._params:
                    p._tensor().copy_(self._params[p.name])
