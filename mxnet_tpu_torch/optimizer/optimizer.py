"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``): the
``Optimizer`` base with its fused-update interface, the registry, and
SGD.  Adam, LARS and the rest are not ported yet (ROADMAP §A item 5).

An update rule is a function on tensors ``(w, g, state) -> (new_w,
new_state)`` evaluated in the reference's order (``_sgd_step``,
``_sgd_mom_step``).  Hyper-parameters enter as Python scalars rounded
to the parameter's dtype first, which is what the reference's
weak-typed scalars do: a bf16 update multiplies by ``bf16(0.9)``, not
by the fp32 0.9.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "register", "scalar_as"]

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

    def fused_bucket_update(self, w, g, state, t, key=None):
        """Update one flat bucket (shard); elementwise rules delegate to
        ``fused_update``."""
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
