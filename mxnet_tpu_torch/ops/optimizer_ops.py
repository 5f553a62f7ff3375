"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``).

Reference parity: src/operator/optimizer_op.cc (``sgd_update``,
``sgd_mom_update``, ``nag_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update``, ``adagrad_update`` and its alias
``_sparse_adagrad_update``, the multi-tensor ``multi_sgd_update`` and
``multi_sgd_mom_update``), contrib/multi_sum_sq.cc and multi_lars.cc,
and the flat-bucket ``_fused_bucket_{sgd_mom,adam,lars}_update``.  Each
op returns its updated tensors (the reference's functional outputs, in
its order) and is not differentiable.  The rules are the optimizers'
own (``optimizer/optimizer.py``), their hyper-parameters rounded as
there: each to the weight's dtype, ``1 - beta`` taken in float32.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..optimizer import optimizer as _o
from ..optimizer.optimizer import scalar_as
from .registry import register_op

__all__ = []


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * scalar_as(rescale_grad, grad.dtype)
    if clip_gradient is not None and clip_gradient > 0:
        c = scalar_as(clip_gradient, grad.dtype)
        g = torch.clamp(g, -c, c)
    return g


def _s(x, like):
    return scalar_as(x, like.dtype)


def _one_m(x, like):
    """``1 - x`` in float32, then to ``like``'s dtype."""
    return scalar_as(onp.float32(1) - onp.float32(x), like.dtype)


@register_op("sgd_update", differentiable=False)
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._sgd_step(weight, g, _s(lr, weight), _s(wd, weight))


@register_op("sgd_mom_update", num_outputs=2, differentiable=False)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0,
                   lazy_update=True):
    """``(weight, mom)`` after one SGD-momentum step."""
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._sgd_mom_step(weight, mom, g, _s(lr, weight), _s(wd, weight),
                            _s(momentum, weight))


@register_op("nag_mom_update", num_outputs=2, differentiable=False)
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._nag_step(weight, mom, g, _s(lr, weight), _s(wd, weight),
                        _s(momentum, weight))


@register_op("adam_update", num_outputs=3, differentiable=False)
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, t=1.0, lazy_update=True):
    """``(weight, mean, var)``; ``t`` is the step count of the bias
    correction."""
    g = _prep(grad, rescale_grad, clip_gradient)
    b1, b2 = float(onp.float32(beta1)), float(onp.float32(beta2))
    return _o._adam_step(weight, mean, var, g,
                         _s(_o.adam_lr_t(lr, b1, b2, t), weight),
                         _s(wd, weight), _s(b1, weight), _s(b2, weight),
                         _one_m(b1, weight), _one_m(b2, weight),
                         _s(epsilon, weight))


@register_op("rmsprop_update", num_outputs=2, differentiable=False)
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_w, new_n = _o._rmsprop_step(
        weight, n, g, _s(lr, weight), _s(wd, weight), _s(gamma1, weight),
        _one_m(gamma1, weight), _s(epsilon, weight))
    if clip_weights is not None and clip_weights > 0:
        c = _s(clip_weights, weight)
        new_w = torch.clamp(new_w, -c, c)
    return new_w, new_n


@register_op("rmspropalex_update", num_outputs=4, differentiable=False)
def rmspropalex_update(weight, grad, n, g_avg, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._rmsprop_alex_step(
        weight, n, g_avg, delta, g, _s(lr, weight), _s(wd, weight),
        _s(gamma1, weight), _one_m(gamma1, weight), _s(gamma2, weight),
        _s(epsilon, weight))


@register_op("ftrl_update", num_outputs=3, differentiable=False)
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._ftrl_step(weight, z, n, g, _s(lr, weight), _s(wd, weight),
                         _s(lamda1, weight), _s(beta, weight))


@register_op("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _s(1 - lr * wd, weight) * weight - _s(lr, weight) * torch.sign(g)


@register_op("signum_update", num_outputs=2, differentiable=False)
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    mom = _s(momentum, weight) * mom - _one_m(momentum, weight) * (
        g + _s(wd, weight) * weight)
    decay = scalar_as(onp.float32(1) - onp.float32(lr)
                      * onp.float32(wd_lh), weight.dtype)
    return decay * weight + _s(lr, weight) * torch.sign(mom), mom


@register_op("adagrad_update", num_outputs=2, differentiable=False,
             aliases=("_sparse_adagrad_update",))
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return _o._adagrad_step(weight, history, g, _s(lr, weight),
                            _s(wd, weight), _s(epsilon, weight))


# ------------------------------------------------- multi-tensor variants
@register_op("multi_sgd_update",
             num_outputs=lambda p: p.get("num_weights", 1),
             differentiable=False)
def multi_sgd_update(*args, lrs, wds, num_weights=1, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """``num_weights`` SGD steps: the weights, then their gradients, in
    the inputs; the new weights out."""
    weights, grads = args[:num_weights], args[num_weights:2 * num_weights]
    return tuple(sgd_update(w, g, lr=lr, wd=wd, rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for w, g, lr, wd in zip(weights, grads, lrs, wds))


@register_op("multi_sgd_mom_update",
             num_outputs=lambda p: 2 * p.get("num_weights", 1),
             differentiable=False)
def multi_sgd_mom_update(*args, lrs, wds, momentum=0.0, num_weights=1,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """Weights, gradients and momenta in; the new weights, then the new
    momenta, out."""
    n = num_weights
    outs = [sgd_mom_update(w, g, m, lr=lr, momentum=momentum, wd=wd,
                           rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)
            for w, g, m, lr, wd in zip(args[:n], args[n:2 * n],
                                       args[2 * n:3 * n], lrs, wds)]
    return tuple(o[0] for o in outs) + tuple(o[1] for o in outs)


# ----------------------------------------- flat-bucket variants (jnp twins)
@register_op("_fused_bucket_sgd_mom_update", num_outputs=2,
             differentiable=False)
def fused_bucket_sgd_mom_update(weight, grad, mom, *, lr, momentum=0.9,
                                wd=0.0, rescale_grad=1.0,
                                clip_gradient=-1.0):
    """SGD-momentum over one flat bucket of many parameters."""
    return sgd_mom_update(weight, grad, mom, lr=lr, momentum=momentum,
                          wd=wd, rescale_grad=rescale_grad,
                          clip_gradient=clip_gradient)


@register_op("_fused_bucket_adam_update", num_outputs=3,
             differentiable=False)
def fused_bucket_adam_update(weight, grad, mean, var, *, lr, beta1=0.9,
                             beta2=0.999, epsilon=1e-8, wd=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0, t=1.0):
    """Adam over one flat bucket."""
    return adam_update(weight, grad, mean, var, lr=lr, beta1=beta1,
                       beta2=beta2, epsilon=epsilon, wd=wd,
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient, t=t)


@register_op("_fused_bucket_lars_update", num_outputs=2,
             differentiable=False)
def fused_bucket_lars_update(weight, grad, mom, seg_ids, *, lr,
                             num_segments, momentum=0.9, lars_eta=0.001,
                             lars_epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                             clip_gradient=-1.0):
    """LARS over one flat bucket: one trust ratio per parameter, from
    the segment sums of the squares (``seg_ids`` maps each element to
    its parameter)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    seg = seg_ids.to(torch.int64)
    nseg = int(num_segments)
    h = {k: _s(v, weight) for k, v in (("lr", lr), ("wd", wd),
                                        ("eta", lars_eta),
                                        ("eps", lars_epsilon))}
    slr = _o._lars_scaled_lr(_o.segment_sum(weight * weight, seg, nseg),
                             _o.segment_sum(g * g, seg, nseg), **h)
    return _o._lars_momentum(weight, mom, g, slr[seg], h["wd"],
                             _s(momentum, weight))


@register_op("multi_sum_sq", num_outputs=1, differentiable=False)
def multi_sum_sq(*arrays, num_arrays=1):
    """Each array's sum of squares, in float32 (the LARS norms)."""
    return torch.stack([(a.to(torch.float32) ** 2).sum() for a in arrays])


@register_op("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta, eps,
               rescale_grad=1.0):
    """Layer-wise learning rates from precomputed squared norms."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * _s(rescale_grad, grads_sum_sq)
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        _s(eta, w_norm) * w_norm
                        / (g_norm + wds * w_norm + _s(eps, w_norm)),
                        torch.ones_like(w_norm))
    return lrs * trust
