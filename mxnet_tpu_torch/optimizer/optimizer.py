"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``): the
``Optimizer`` base (learning-rate schedule, per-parameter ``lr_mult``
and ``wd_mult``, update counts, fp32 master weights under
``multi_precision``), the registry, the :class:`Updater` a
``gluon.Trainer`` drives, and the rules SGD, NAG, Signum, Adam, AdamW,
AdaGrad, RMSProp (plain and centered) and LARS.  The other rules are
not ported yet (ROADMAP §A item 5).

Each rule is one function on tensors, :meth:`Optimizer._step` ``(w, g,
state, lr, wd, t) -> (new_w, new_state)``, evaluated in the reference's
order (``_sgd_step``, ``_sgd_mom_step``, ``_adam_step``, ...).  The
fused path (``fused_update``, what ``parallel.make_train_step`` runs)
calls it with the optimizer's own learning rate and weight decay; the
eager path (``update``, what the Trainer runs per parameter) with the
parameter's (``_get_lr``/``_get_wd``: the multipliers apply), and
writes the result into the weight and state arrays.  The two paths
therefore give the same bits for the same hyper-parameters.

Hyper-parameters enter as Python scalars rounded to the parameter's
dtype first, which is what the reference's weak-typed scalars do: a
bf16 update multiplies by ``bf16(0.9)``, not by the fp32 0.9.  A
scalar expression the reference evaluates inside its jitted rule
(``1 - beta1``, ``1 - rho``) is taken in float32 first, as there.

LARS's trust ratio is a per-tensor norm, so on a flat bucket of many
tensors (``parallel.zero``) it needs each element's segment id (its
tensor's index in the bucket): ``fused_bucket_update(...,
seg_ids=, num_segments=)`` recovers the tensors' norms as segment sums.
"""
from __future__ import annotations

import copy
import pickle

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "Adam", "AdamW", "AdaGrad",
           "RMSProp", "LARS", "Updater", "create", "register",
           "get_updater", "scalar_as", "adam_lr_t", "segment_sum"]

_REGISTRY: dict[str, type] = {}
_HALF = (torch.float16, torch.bfloat16)


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by its registered name (case-insensitive), or the
    instance given."""
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _REGISTRY:
        raise MXNetError(f"Cannot find optimizer {name}")
    return _REGISTRY[name.lower()](**kwargs)


def scalar_as(x, dtype):
    """The Python float ``x`` rounded to ``dtype`` (what a weak-typed
    scalar becomes beside an array of that dtype in the reference)."""
    return float(torch.tensor(float(x), dtype=dtype))


def _f32(x):
    """``x`` as the float32 value a jitted rule of the reference traces
    it as (scalar expressions inside such a rule are float32)."""
    return onp.float32(x)


class Optimizer:
    """Base optimizer.  ``fused_state(w)`` makes the state of one tensor
    (or flat bucket); ``fused_update`` is the pure per-tensor rule and
    ``fused_bucket_update`` its flat-bucket form (the same rule for an
    elementwise optimizer).  ``create_state``/``update`` are the eager
    forms on NDArrays, with the per-parameter multipliers."""

    opt_registry = _REGISTRY

    #: stochastic rules consume a PRNG key (none is ported)
    needs_key = False
    #: the rule treats every element alone, so it runs unchanged on a
    #: flat bucket of many parameters (parallel.zero relies on it)
    fused_elementwise = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # ------------------------------------------------------------ lr / wd
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight decay applies to weights and gammas by name; every
        other named parameter gets a 0 multiplier unless given one."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    # ------------------------------------------------------------- rules
    def _prep(self, g):
        """``g * rescale_grad``, then the symmetric clip."""
        g = g * scalar_as(self.rescale_grad, g.dtype)
        if self.clip_gradient is not None:
            c = scalar_as(self.clip_gradient, g.dtype)
            g = torch.clamp(g, -c, c)
        return g

    def _step(self, w, g, state, lr, wd, t):
        """The rule: ``(new_w, new_state)`` from the raw gradient."""
        raise MXNetError(
            f"{type(self).__name__} does not provide an update rule")

    def fused_state(self, w):
        """Initial state of ``w`` as a tuple of tensors."""
        return ()

    def fused_update(self, w, g, state, t, key=None):
        """The pure per-tensor rule at the optimizer's own learning rate
        and weight decay; ``t`` is the 1-based step count."""
        return self._step(w, g, state, self.learning_rate, self.wd, t)

    def fused_bucket_update(self, w, g, state, t, key=None, seg_ids=None,
                            num_segments=None, axis_name=None):
        """Update one flat bucket (shard); elementwise rules delegate to
        ``fused_update``.  ``seg_ids`` maps each element to its tensor
        within the bucket (``num_segments`` of them), for rules that
        reduce per tensor; ``axis_name`` names the shard axis of a
        reduction across shards, which needs more than one card (not
        ported yet, ROADMAP §A 11)."""
        if axis_name is not None:
            raise MXNetError("bucket reductions across shards are not "
                             "ported yet (ROADMAP §A 11)")
        if not self.fused_elementwise:
            raise MXNetError(
                f"{type(self).__name__} is not elementwise and provides "
                "no bucket-aware fused rule")
        return self.fused_update(w, g, state, t, key=key)

    # ------------------------------------------------------------- eager
    def create_state(self, index, weight):
        """The state of the NDArray ``weight``: a tuple of NDArrays on
        its device."""
        return tuple(NDArray(s) for s in self.fused_state(weight._data))

    def create_state_multi_precision(self, index, weight):
        """Under ``multi_precision`` an fp16/bf16 weight gets an fp32
        master copy, whose state is fp32: ``(master, state)``."""
        if self.multi_precision and weight._data.dtype in _HALF:
            master = NDArray(weight._data.detach().to(torch.float32))
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """One eager step of parameter ``index``: the rule at its
        learning rate and weight decay, written into ``weight`` and the
        state arrays."""
        self._update_count(index)
        with torch.no_grad():
            new_w, new_state = self._step(
                weight._data, grad._data, tuple(s._data for s in state),
                self._get_lr(index), self._get_wd(index),
                self._index_update_count[index])
        weight._adopt(new_w)
        for s, v in zip(state, new_state):
            s._adopt(v)

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` on the fp32 master of an fp16/bf16 weight
        under ``multi_precision`` (the gradient widened to fp32), the
        weight then re-cast from the master; else :meth:`update`."""
        if self.multi_precision and weight._data.dtype in _HALF:
            master, base_state = state
            self.update(index, master, NDArray(
                grad._data.to(torch.float32)), base_state)
            weight._adopt(master._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)


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

    def _step(self, w, g, state, lr, wd, t):
        g = self._prep(g)
        lr, wd = scalar_as(lr, w.dtype), scalar_as(wd, w.dtype)
        if self.momentum == 0.0:
            # momentum zeroed live: any existing slot passes through
            return _sgd_step(w, g, lr, wd), state
        (mom,) = state
        new_w, new_m = _sgd_mom_step(w, mom, g, lr, wd,
                                     scalar_as(self.momentum, w.dtype))
        return new_w, (new_m,)


def _nag_step(w, mom, g, lr, wd, momentum):
    g = g + wd * w
    mom = momentum * mom + g
    return w - lr * (g + momentum * mom), mom


@register
class NAG(SGD):
    """Nesterov accelerated SGD: ``g += wd*w; mom = momentum*mom + g;
    w -= lr*(g + momentum*mom)`` (without momentum, SGD's rule)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(momentum=momentum, **kwargs)

    def _step(self, w, g, state, lr, wd, t):
        if self.momentum == 0.0:
            return super()._step(w, g, state, lr, wd, t)
        dt = w.dtype
        (mom,) = state
        new_w, new_m = _nag_step(w, mom, self._prep(g), scalar_as(lr, dt),
                                 scalar_as(wd, dt),
                                 scalar_as(self.momentum, dt))
        return new_w, (new_m,)


@register
class Signum(Optimizer):
    """signSGD / Signum: ``mom = momentum*mom - (1-momentum)*(g +
    wd*w); w = (1 - lr*wd_lh)*w + lr*sign(mom)`` (without momentum
    ``w = (1 - lr*wd_lh)*w - lr*sign(g + wd*w)``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def fused_state(self, w):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(w),)

    def _step(self, w, g, state, lr, wd, t):
        dt = w.dtype
        g = self._prep(g)
        if self.momentum == 0.0:
            # the reference computes this form eagerly, its scalars in
            # Python floats
            decay = scalar_as(1 - lr * self.wd_lh, dt)
            lr, wd = scalar_as(lr, dt), scalar_as(wd, dt)
            return decay * w - lr * torch.sign(g + wd * w), state
        (mom,) = state
        m = _f32(self.momentum)
        mom = scalar_as(m, dt) * mom - scalar_as(_f32(1) - m, dt) * (
            g + scalar_as(wd, dt) * w)
        decay = scalar_as(_f32(1) - _f32(lr) * _f32(self.wd_lh), dt)
        return decay * w + scalar_as(lr, dt) * torch.sign(mom), (mom,)


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

    def _consts(self, lr, t, dt):
        """``(lr_t, beta1, beta2, 1 - beta1, 1 - beta2, eps)`` in
        ``dt``: the reference's rule runs jitted with its
        hyper-parameters traced as float32 values, so 1 - beta is taken
        from f32(beta): 0.100000024 for 0.9 (the bucket kernel's
        constant is f32(0.1))."""
        b1, b2 = float(_f32(self.beta1)), float(_f32(self.beta2))
        return (scalar_as(adam_lr_t(lr, b1, b2, t), dt), scalar_as(b1, dt),
                scalar_as(b2, dt), scalar_as(1.0 - b1, dt),
                scalar_as(1.0 - b2, dt), scalar_as(self.epsilon, dt))

    def _step(self, w, g, state, lr, wd, t):
        m, v = state
        lr_t, b1, b2, omb1, omb2, eps = self._consts(lr, t, w.dtype)
        new_w, new_m, new_v = _adam_step(
            w, m, v, self._prep(g), lr_t, scalar_as(wd, w.dtype), b1, b2,
            omb1, omb2, eps)
        return new_w, (new_m, new_v)


def _adamw_step(w, m, v, g, lr_t, eta, wd, beta1, beta2, one_m_beta1,
                one_m_beta2, eps):
    m = beta1 * m + one_m_beta1 * g
    v = beta2 * v + one_m_beta2 * g * g
    return w - eta * (lr_t * m / (torch.sqrt(v) + eps) + wd * w), m, v


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``m``, ``v`` from the raw
    gradient; ``w -= eta*(lr_t*m/(sqrt(v) + eps) + wd*w)``."""

    def __init__(self, eta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta

    def _step(self, w, g, state, lr, wd, t):
        m, v = state
        dt = w.dtype
        lr_t, b1, b2, omb1, omb2, eps = self._consts(lr, t, dt)
        new_w, new_m, new_v = _adamw_step(
            w, m, v, self._prep(g), lr_t, scalar_as(self.eta, dt),
            scalar_as(wd, dt), b1, b2, omb1, omb2, eps)
        return new_w, (new_m, new_v)


def _adagrad_step(w, hist, g, lr, wd, eps):
    # the history accumulates the raw grad^2, eps sits inside the sqrt,
    # and wd applies as a decoupled term
    hist = hist + g * g
    return w - lr * (g / torch.sqrt(hist + eps) + wd * w), hist


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``hist += g*g; w -= lr*(g/sqrt(hist + eps) + wd*w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def fused_state(self, w):
        return (torch.zeros_like(w),)

    def _step(self, w, g, state, lr, wd, t):
        dt = w.dtype
        (hist,) = state
        new_w, new_h = _adagrad_step(w, hist, self._prep(g),
                                     scalar_as(lr, dt), scalar_as(wd, dt),
                                     scalar_as(self.float_stable_eps, dt))
        return new_w, (new_h,)


def _rmsprop_step(w, n, g, lr, wd, rho, one_m_rho, eps):
    g = g + wd * w
    n = rho * n + one_m_rho * g * g
    return w - lr * g / torch.sqrt(n + eps), n


def _rmsprop_alex_step(w, n, gavg, delta, g, lr, wd, rho, one_m_rho,
                       momentum, eps):
    g = g + wd * w
    n = rho * n + one_m_rho * g * g
    gavg = rho * gavg + one_m_rho * g
    delta = momentum * delta - lr * g / torch.sqrt(n - gavg * gavg + eps)
    return w + delta, n, gavg, delta


@register
class RMSProp(Optimizer):
    """RMSProp: ``n = gamma1*n + (1-gamma1)*g*g; w -= lr*g/sqrt(n +
    eps)`` with ``g`` including ``wd*w``; ``centered=True`` is Alex
    Graves' variant (a running mean of g and a momentum ``gamma2`` on
    the step); ``clip_weights`` clips the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def fused_state(self, w):
        return tuple(torch.zeros_like(w)
                     for _ in range(3 if self.centered else 1))

    def _step(self, w, g, state, lr, wd, t):
        dt = w.dtype
        g = self._prep(g)
        rho = _f32(self.gamma1)
        h = dict(lr=scalar_as(lr, dt), wd=scalar_as(wd, dt),
                 rho=scalar_as(rho, dt),
                 one_m_rho=scalar_as(_f32(1) - rho, dt),
                 eps=scalar_as(self.epsilon, dt))
        if self.centered:
            n, gavg, delta = state
            new_w, *new_state = _rmsprop_alex_step(
                w, n, gavg, delta, g,
                momentum=scalar_as(self.gamma2, dt), **h)
        else:
            (n,) = state
            new_w, *new_state = _rmsprop_step(w, n, g, **h)
        if self.clip_weights:
            c = scalar_as(self.clip_weights, dt)
            new_w = torch.clamp(new_w, -c, c)
        return new_w, tuple(new_state)


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

    def _hyper(self, lr, wd, dt):
        return {k: scalar_as(v, dt) for k, v in (
            ("lr", lr), ("wd", wd), ("eta", self.eta),
            ("eps", self.epsilon))}

    def _step(self, w, g, state, lr, wd, t):
        (mom,) = state
        g = self._prep(g)
        h = self._hyper(lr, wd, w.dtype)
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
                             "ported yet (ROADMAP §A 11)")
        (mom,) = state
        g = self._prep(g)
        h = self._hyper(self.learning_rate, self.wd, w.dtype)
        slr = _lars_scaled_lr(segment_sum(w * w, seg_ids, num_segments),
                              segment_sum(g * g, seg_ids, num_segments),
                              **h)
        new_w, new_m = _lars_momentum(w, mom, g, slr[seg_ids], h["wd"],
                                      scalar_as(self.momentum, w.dtype))
        return new_w, (new_m,)


# ================================================================ Updater
class Updater:
    """Applies an optimizer to parameters by index, keeping each one's
    state (reference ``Updater``; what ``gluon.Trainer`` drives)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            # loaded states come back on the host: each goes to its
            # weight's device, never the weight to the host
            self.states[index] = _on_device(self.states[index],
                                            weight._data.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states pickled, with the optimizer when
        ``dump_optimizer`` (its live parameter handles left out)."""
        if dump_optimizer:
            opt = copy.copy(self.optimizer)
            opt.param_dict = {}
            return pickle.dumps((self.states, opt))
        return pickle.dumps(self.states)

    def set_states(self, states):
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, new_opt = states
            new_opt.param_dict = getattr(self.optimizer, "param_dict", {})
            self.optimizer = new_opt
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)


def _on_device(state, device):
    if isinstance(state, (tuple, list)):
        return type(state)(_on_device(s, device) for s in state)
    if isinstance(state, NDArray) and state._data.device != device:
        return NDArray(state._data.to(device))
    return state


def get_updater(optimizer):
    return Updater(optimizer)
