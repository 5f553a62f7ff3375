"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``): the
``Optimizer`` base with its fused-update interface, the registry, SGD,
Adam and LARS.  The other rules are not ported yet (ROADMAP §A item 5).

An update rule is a function on tensors ``(w, g, state) -> (new_w,
new_state)`` evaluated in the reference's order (``_sgd_step``,
``_sgd_mom_step``, ``_adam_step``, ``_lars_step``).  Hyper-parameters
enter as Python scalars rounded to the parameter's dtype first, which
is what the reference's weak-typed scalars do: a bf16 update multiplies
by ``bf16(0.9)``, not by the fp32 0.9.

LARS's trust ratio is a per-tensor norm, so on a flat bucket of many
tensors (``parallel.zero``) it needs each element's segment id (its
tensor's index in the bucket): ``fused_bucket_update(...,
seg_ids=, num_segments=)`` recovers the tensors' norms as segment sums.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "LARS", "register", "scalar_as",
           "adam_lr_t", "segment_sum"]

_REGISTRY: dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def scalar_as(x, dtype):
    """The Python float ``x`` rounded to ``dtype`` (what a weak-typed
    scalar becomes beside an array of that dtype in the reference)."""
    return float(torch.tensor(float(x), dtype=dtype))


class Optimizer:
    """Base optimizer.  ``fused_state(w)`` makes the state of one tensor
    (or flat bucket); ``fused_update`` is the pure per-tensor rule and
    ``fused_bucket_update`` its flat-bucket form (the same rule for an
    elementwise optimizer)."""

    opt_registry = _REGISTRY

    #: stochastic rules consume a PRNG key (none is ported)
    needs_key = False
    #: the rule treats every element alone, so it runs unchanged on a
    #: flat bucket of many parameters (parallel.zero relies on it)
    fused_elementwise = True

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False):
        if lr_scheduler is not None:
            raise MXNetError("lr_scheduler is not ported yet "
                             "(ROADMAP §A item 5)")
        if multi_precision:
            raise MXNetError("multi_precision is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision

    @property
    def learning_rate(self):
        return self.lr

    def _prep(self, g):
        """``g * rescale_grad``, then the symmetric clip."""
        g = g * scalar_as(self.rescale_grad, g.dtype)
        if self.clip_gradient is not None:
            c = scalar_as(self.clip_gradient, g.dtype)
            g = torch.clamp(g, -c, c)
        return g

    def fused_state(self, w):
        """Initial state of ``w`` as a tuple of tensors."""
        return ()

    def fused_update(self, w, g, state, t, key=None):
        raise MXNetError(
            f"{type(self).__name__} does not provide a fused rule")

    def fused_bucket_update(self, w, g, state, t, key=None, seg_ids=None,
                            num_segments=None, axis_name=None):
        """Update one flat bucket (shard); elementwise rules delegate to
        ``fused_update``.  ``seg_ids`` maps each element to its tensor
        within the bucket (``num_segments`` of them), for rules that
        reduce per tensor; ``axis_name`` names the shard axis of a
        reduction across shards, which needs more than one card (not
        ported yet, ROADMAP §A item 9)."""
        if axis_name is not None:
            raise MXNetError("bucket reductions across shards are not "
                             "ported yet (ROADMAP §A item 9)")
        if not self.fused_elementwise:
            raise MXNetError(
                f"{type(self).__name__} is not elementwise and provides "
                "no bucket-aware fused rule")
        return self.fused_update(w, g, state, t, key=key)


def _sgd_step(w, g, lr, wd):
    return w - lr * (g + wd * w)


def _sgd_mom_step(w, mom, g, lr, wd, momentum):
    mom = momentum * mom - lr * (g + wd * w)
    return w + mom, mom


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum*mom - lr*(grad + wd*w);
    w += mom`` (without momentum ``w -= lr*(grad + wd*w)``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def fused_state(self, w):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(w),)

    def fused_update(self, w, g, state, t, key=None):
        g = self._prep(g)
        lr = scalar_as(self.learning_rate, w.dtype)
        wd = scalar_as(self.wd, w.dtype)
        if self.momentum == 0.0:
            # momentum zeroed live: any existing slot passes through
            return _sgd_step(w, g, lr, wd), state
        (mom,) = state
        new_w, new_m = _sgd_mom_step(w, mom, g, lr, wd,
                                     scalar_as(self.momentum, w.dtype))
        return new_w, (new_m,)


def adam_lr_t(lr, beta1, beta2, t):
    """Adam's bias-corrected rate ``lr·√(1−β2^t)/(1−β1^t)`` as the
    reference computes it: in float32, the powers a float32 pow of
    ``f32(beta)`` and ``f32(t)``.  Taken on the host from a Python
    ``t``, so the step reads no device value."""
    f = onp.float32
    coef1 = f(1.0) - f(beta1) ** f(t)
    coef2 = f(1.0) - f(beta2) ** f(t)
    return float(f(lr) * onp.sqrt(coef2) / coef1)


def _adam_step(w, m, v, g, lr_t, wd, beta1, beta2, one_m_beta1,
               one_m_beta2, eps):
    g = g + wd * w
    m = beta1 * m + one_m_beta1 * g
    v = beta2 * v + one_m_beta2 * g * g
    return w - lr_t * m / (torch.sqrt(v) + eps), m, v


@register
class Adam(Optimizer):
    """Adam: ``g += wd*w; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
    w -= lr_t*m/(sqrt(v) + eps)`` with the bias-corrected ``lr_t``
    (:func:`adam_lr_t`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def fused_state(self, w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def fused_update(self, w, g, state, t, key=None):
        m, v = state
        dt = w.dtype
        b1, b2 = (scalar_as(b, torch.float32) for b in (self.beta1,
                                                       self.beta2))
        # the reference's rule runs jitted with its hyper-parameters
        # traced as float32 values, so 1 - beta is taken from f32(beta):
        # 0.100000024 for 0.9 (the bucket kernel's constant is f32(0.1))
        new_w, new_m, new_v = _adam_step(
            w, m, v, self._prep(g),
            scalar_as(adam_lr_t(self.learning_rate, b1, b2, t), dt),
            scalar_as(self.wd, dt), scalar_as(b1, dt), scalar_as(b2, dt),
            scalar_as(1.0 - b1, dt), scalar_as(1.0 - b2, dt),
            scalar_as(self.epsilon, dt))
        return new_w, (new_m, new_v)


def segment_sum(x, seg_ids, num_segments):
    """``out[s] = Σ x[seg_ids == s]`` over ``num_segments`` segments."""
    return x.new_zeros((num_segments,)).index_add_(0, seg_ids, x)


def _lars_scaled_lr(w_ss, g_ss, lr, wd, eta, eps):
    """``lr·trust`` from the squared norms of w and g (per tensor):
    ``trust = eta·|w|/(|g| + wd·|w| + eps)`` where both norms are
    positive, else 1."""
    w_norm = torch.sqrt(w_ss)
    g_norm = torch.sqrt(g_ss)
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + eps),
                        torch.ones_like(w_norm))
    return lr * trust


def _lars_momentum(w, mom, g, scaled_lr, wd, momentum):
    mom = momentum * mom + scaled_lr * (g + wd * w)
    return w - mom, mom


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling: ``mom = momentum*mom +
    lr*trust*(g + wd*w); w -= mom`` with one trust ratio per tensor."""

    #: the trust ratio is a per-tensor norm: a flat bucket needs the
    #: segment ids (fused_bucket_update below)
    fused_elementwise = False

    def __init__(self, momentum=0.0, lars_eta=0.001, lars_epsilon=0,
                 momentum_correction=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = lars_eta
        self.epsilon = lars_epsilon

    def fused_state(self, w):
        return (torch.zeros_like(w),)

    def _hyper(self, dt):
        return {k: scalar_as(v, dt) for k, v in (
            ("lr", self.learning_rate), ("wd", self.wd),
            ("eta", self.eta), ("eps", self.epsilon))}

    def fused_update(self, w, g, state, t, key=None):
        (mom,) = state
        g = self._prep(g)
        h = self._hyper(w.dtype)
        slr = _lars_scaled_lr((w * w).sum(), (g * g).sum(), **h)
        new_w, new_m = _lars_momentum(w, mom, g, slr, h["wd"],
                                      scalar_as(self.momentum, w.dtype))
        return new_w, (new_m,)

    def fused_bucket_update(self, w, g, state, t, key=None, seg_ids=None,
                            num_segments=None, axis_name=None):
        if seg_ids is None:
            # a whole-tensor bucket: the per-tensor rule
            return self.fused_update(w, g, state, t, key=key)
        if axis_name is not None:
            raise MXNetError("bucket reductions across shards are not "
                             "ported yet (ROADMAP §A item 9)")
        (mom,) = state
        g = self._prep(g)
        h = self._hyper(w.dtype)
        slr = _lars_scaled_lr(segment_sum(w * w, seg_ids, num_segments),
                              segment_sum(g * g, seg_ids, num_segments),
                              **h)
        new_w, new_m = _lars_momentum(w, mom, g, slr[seg_ids], h["wd"],
                                      scalar_as(self.momentum, w.dtype))
        return new_w, (new_m,)
