"""Neural-network ops (counterpart of ``mxnet_tpu/ops/nn.py``):
FullyConnected, Activation, LeakyReLU, the softmax family, pick,
Dropout, BatchNorm with its fused backward, and the loss-style output ops
(SoftmaxOutput and the regression outputs), whose backward ignores the
head gradient.

Each op is registered under the reference's names and aliases with
exactly the reference's keyword names and defaults, the ignored ones
(``cudnn_off``, ``dtype``) included, since a symbol's attributes are
parsed against them.  Gluon's layers call the same functions.

BatchNorm keeps the reference's numerics policy: statistics in fp32
whatever the activation dtype (one pass E[x], E[x²] for bf16/fp16, two
passes for fp32, ``_bn_stats``), and a custom backward whose residuals
are the original activation plus per-channel statistics
(``_bn_train``'s custom VJP, ``mxnet_tpu/ops/nn.py:153-215``), here a
``torch.autograd.Function``.  Inside :func:`bn_group_scope` (the
replicated train step of a process mesh) the statistics are the global
batch's, as XLA computes them for the reference's replicated step under
a mesh: the channel sums and the counts all-reduce over the processes,
in the same fp32 policy, and the backward all-reduces its two channel
sums.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from .. import _rng
from ..base import MXNetError
from .registry import register_op
from .shape_ops import pick

__all__ = ["fully_connected", "activation", "leaky_relu", "softmax",
           "log_softmax", "softmin", "softmax_activation", "pick",
           "dropout", "batch_norm", "softmax_output"]


@register_op("FullyConnected", aliases=("_FullyConnected",))
def fully_connected(data, weight, bias=None, *, num_hidden, no_bias=False,
                    flatten=True):
    """``data @ weight.T + bias`` (reference ``FullyConnected``,
    ``mxnet_tpu/ops/nn.py:21``)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.shape[0] != num_hidden:
        raise MXNetError(f"FullyConnected: weight has {weight.shape[0]} "
                         f"rows, num_hidden={num_hidden}")
    out = x @ weight.t()
    if not no_bias and bias is not None:
        out = out + bias
    return out


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}


@register_op("Activation")
def activation(x, *, act_type):
    """Reference ``Activation`` (``mxnet_tpu/ops/nn.py:35``): relu,
    sigmoid, tanh, softrelu (softplus) or softsign."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type!r} (one of "
                         f"{sorted(_ACTIVATIONS)})")
    return fn(x)


@register_op("LeakyReLU")
def leaky_relu(*inputs, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """Reference ``LeakyReLU`` (``mxnet_tpu/ops/nn.py:49``): leaky,
    prelu (``gamma`` the second input, per channel on axis 1), elu,
    selu, gelu and rrelu.  ``rrelu`` takes the midpoint slope
    ``(lower_bound + upper_bound) / 2`` in training and inference
    alike, as the reference does (it draws nothing)."""
    x = inputs[0]
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        gamma = inputs[1]
        if gamma.dim() < x.dim() and gamma.numel() > 1:
            shape = [1] * x.dim()
            shape[1] = gamma.numel()
            gamma = gamma.reshape(shape)
        return torch.where(x > 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":
        return torch.nn.functional.gelu(x)
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, s * x)
    raise MXNetError(f"unknown act_type {act_type!r}")


def _float_of(x, axis):
    """An integer or bool input as float32, the dtype jnp's softmax
    family returns for it, after jnp's first step, ``x - max(x)``, which
    it takes in the integer type (a uint8 difference wraps)."""
    if x.is_floating_point():
        return x
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return (x - x.amax(dim=axis, keepdim=True)).to(torch.float32)


@register_op("softmax")
def softmax(x, length=None, *, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Reference ``softmax`` (``mxnet_tpu/ops/nn.py:76``); with
    ``use_length`` the positions at or past ``length`` along ``axis``
    get 0."""
    x = _float_of(x, axis)
    if temperature:
        x = x / temperature
    if use_length and length is not None:
        shape = [1] * x.dim()
        shape[axis] = -1
        pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        mask = pos < length.unsqueeze(axis)
        r = torch.softmax(torch.where(mask, x, -math.inf), dim=axis)
        return torch.where(mask, r, torch.zeros((), dtype=r.dtype,
                                                device=r.device))
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def log_softmax(x, *, axis=-1, temperature=None, dtype=None,
                use_length=False):
    """Reference ``log_softmax`` (``mxnet_tpu/ops/nn.py:92``)."""
    x = _float_of(x, axis)
    if temperature:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)


@register_op("softmin")
def softmin(x, *, axis=-1, temperature=None, dtype=None, use_length=False):
    """Reference ``softmin`` (``mxnet_tpu/ops/nn.py:100``), which takes
    no temperature."""
    return torch.softmax(-_float_of(x, axis), dim=axis)


@register_op("SoftmaxActivation")
def softmax_activation(x, *, mode="instance"):
    """Reference ``SoftmaxActivation``: over axis 1 (``channel``) or
    over all but the batch axis (``instance``); an integer or bool input
    gives float32, as jnp's softmax does."""
    if mode == "channel":
        x = _float_of(x, 1)
        return torch.softmax(x, dim=1)
    flat = _float_of(x.reshape(x.shape[0], -1), -1)
    return torch.softmax(flat, dim=-1).reshape(x.shape)


@register_op("Dropout", key_param="key", train_param="train")
def dropout(data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
            key=None, train=False):
    """Reference ``Dropout`` (``mxnet_tpu/ops/nn.py:331``): ``data`` times
    a Bernoulli mask of keep probability ``1 - p`` scaled by ``1 /
    (1 - p)``; ``axes`` give the mask extent 1 there (one draw shared
    along them).  The identity when not training (unless ``mode ==
    "always"``) and at ``p = 0``.  The mask is drawn by
    ``_rng.draw_bernoulli`` from ``key`` (the dispatcher's generator;
    None: the data device's)."""
    if (not train and mode != "always") or p == 0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    gen = key if key is not None else _rng.take_key(data.device)
    mask = _rng.draw_bernoulli(keep, tuple(shape), data.device, gen)
    return data * (mask.to(data.dtype) / keep)


# ------------------------------------------------------------ BatchNorm
_BN_GROUP = threading.local()


@contextlib.contextmanager
def bn_group_scope(exchange):
    """Training BatchNorm inside takes the global batch's statistics over
    ``exchange``'s processes (an ``ops.collective_ops.Exchange``; its
    all-reduces count under the role ``bn``).  None: per process."""
    prev = getattr(_BN_GROUP, "ex", None)
    _BN_GROUP.ex = exchange
    try:
        yield
    finally:
        _BN_GROUP.ex = prev


_BATCH_WORLD = threading.local()


@contextlib.contextmanager
def global_batch_scope(world):
    """Output ops inside that divide their gradient by the batch
    (``SoftmaxOutput``'s ``normalization="valid"``, the regression
    outputs) divide by the global batch: this process's rows times
    ``world``, the processes of a mesh that each take as many rows (the
    Module over a process mesh).  The reference's program sees the
    global batch itself."""
    prev = getattr(_BATCH_WORLD, "n", 1)
    _BATCH_WORLD.n = int(world)
    try:
        yield
    finally:
        _BATCH_WORLD.n = prev


def _batch_world():
    return getattr(_BATCH_WORLD, "n", 1)


def bn_group():
    """The :func:`bn_group_scope` of this thread (None outside one);
    a layer's forward saves it for its backward, which autograd may run
    on another thread."""
    ex = getattr(_BN_GROUP, "ex", None)
    return ex if ex is not None and ex.world > 1 else None


def _bn_stats_global(data, ax, ex):
    """``(mean, var, count)`` of the global batch over ``ex``'s
    processes, in :func:`_bn_stats`'s policy: for fp32 the mean (with
    the count) all-reduces first, then the centred squares; for half
    precision E[x] and E[x²] in one all-reduce."""
    red = tuple(i for i in range(data.dim()) if i != ax)
    c = data.shape[ax]
    x32 = data.to(torch.float32)
    n_local = x32.new_full((1,), float(data.numel() // max(c, 1)))
    if data.dtype in (torch.bfloat16, torch.float16):
        sums = ex.all_reduce(torch.cat([x32.sum(dim=red),
                                        x32.square().sum(dim=red),
                                        n_local]), role="bn")
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean.square(), 0.0)
        return mean, var, n
    sums = ex.all_reduce(torch.cat([x32.sum(dim=red), n_local]), role="bn")
    n = sums[c]
    mean = sums[:c] / n
    sq = ex.all_reduce((x32 - mean.reshape(_bshape(data, ax))).square()
                       .sum(dim=red), role="bn")
    return mean, sq / n, n


def _bn_grad_sums(ex, sums):
    """The backward's channel sums (and any statistics cotangents)
    summed over ``ex``'s processes: one all-reduce of them all."""
    parts = [t for t in sums if t is not None]
    flat = ex.all_reduce(torch.cat(parts), role="bn")
    out, i = [], 0
    for t in sums:
        if t is None:
            out.append(None)
        else:
            out.append(flat[i:i + t.numel()])
            i += t.numel()
    return out


def _bn_stats(data, axis):
    """fp32 batch statistics over every axis but ``axis``: one pass
    (E[x] and E[x²], var clamped at 0) for half-precision data, the
    numerically safe two-pass form for fp32 (the reference's policy,
    ``mxnet_tpu/ops/nn.py:124``)."""
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    x32 = data.to(torch.float32)
    mean = x32.mean(dim=red)
    if data.dtype in (torch.bfloat16, torch.float16):
        ex2 = x32.square().mean(dim=red)
        var = torch.clamp_min(ex2 - mean.square(), 0.0)
    else:
        var = (x32 - mean.reshape(_bshape(data, ax))).square().mean(dim=red)
    return mean, var


def _bshape(data, ax):
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    return shape


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm: forward returns (out, batch_mean,
    batch_var); backward is the fused BatchNormalizationBackward of the
    reference (``_bn_train_bwd``), in fp32, from the original data and
    the per-channel statistics."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps, axis, fix_gamma):
        ax = axis % data.dim()
        bshape = _bshape(data, ax)
        ctx.ex = bn_group()
        if ctx.ex is None:
            mean, var = _bn_stats(data, ax)
        else:
            mean, var, ctx.n = _bn_stats_global(data, ax, ctx.ex)
        inv = torch.rsqrt(var + eps)
        g32 = torch.ones_like(inv) if fix_gamma else gamma.to(torch.float32)
        scale = (inv * g32).reshape(bshape)
        shift = (beta.to(torch.float32) - mean * inv * g32).reshape(bshape)
        out = (data.to(torch.float32) * scale + shift).to(data.dtype)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.ax, ctx.fix_gamma = ax, fix_gamma
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        data, gamma, mean, inv = ctx.saved_tensors
        ax = ctx.ax
        red = tuple(i for i in range(data.dim()) if i != ax)
        bshape = _bshape(data, ax)
        n = math.prod(data.shape[i] for i in red)
        x32 = data.to(torch.float32)
        dy32 = torch.zeros_like(x32) if dy is None else dy.to(torch.float32)
        g32 = torch.ones_like(inv) if ctx.fix_gamma \
            else gamma.to(torch.float32)
        xhat = (x32 - mean.reshape(bshape)) * inv.reshape(bshape)
        sum_dy = dy32.sum(dim=red)
        sum_dy_xhat = (dy32 * xhat).sum(dim=red)
        # the parameter gradients are this process's sums (the step
        # all-reduces them with every other gradient); the input
        # gradient takes the global batch's
        g_dy, g_dy_xhat = sum_dy, sum_dy_xhat
        if ctx.ex is not None:
            n = ctx.n
            g_dy, g_dy_xhat, dmean_ct, dvar_ct = _bn_grad_sums(
                ctx.ex, (sum_dy, sum_dy_xhat, dmean_ct, dvar_ct))
        dx32 = (inv * g32).reshape(bshape) * (
            dy32 - (g_dy / n).reshape(bshape)
            - xhat * (g_dy_xhat / n).reshape(bshape))
        # cotangents of the mean/var outputs: None unless a caller
        # differentiates through the batch statistics
        if dmean_ct is not None:
            dx32 = dx32 + (dmean_ct / n).reshape(bshape)
        if dvar_ct is not None:
            dx32 = dx32 + (dvar_ct * 2.0 / n).reshape(bshape) \
                * (x32 - mean.reshape(bshape))
        dgamma = torch.zeros_like(gamma) if ctx.fix_gamma \
            else sum_dy_xhat.to(gamma.dtype)
        dbeta = sum_dy.to(gamma.dtype)
        return dx32.to(data.dtype), dgamma, dbeta, None, None, None


def _mean_var_nout(p):
    return 3 if p.get("output_mean_var") else 1


@register_op("BatchNorm", aliases=("BatchNorm_v1",),
             num_outputs=_mean_var_nout, train_param="train")
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, train=False):
    """Reference ``BatchNorm`` (``mxnet_tpu/ops/nn.py:220``).  Pure: with
    ``output_mean_var`` it returns (out, batch_mean, batch_var) and the
    caller (the Gluon layer, the graph executor) folds the batch
    statistics into the moving averages with ``momentum``."""
    if train and not use_global_stats:
        out, mean, var = _BNTrain.apply(data, gamma, beta, float(eps),
                                        int(axis), bool(fix_gamma))
        return (out, mean, var) if output_mean_var else out
    bshape = _bshape(data, axis % data.dim())
    mean = moving_mean.to(torch.float32)
    var = moving_var.to(torch.float32)
    inv = torch.rsqrt(var + eps)
    g32 = torch.ones_like(inv) if fix_gamma else gamma.to(torch.float32)
    scale = (inv * g32).reshape(bshape)
    shift = (beta.to(torch.float32) - mean * inv * g32).reshape(bshape)
    out = (data.to(torch.float32) * scale + shift).to(data.dtype)
    return (out, mean, var) if output_mean_var else out


# ------------------------------------------------------- output ops
def _class_last(data):
    """The permutation that moves axis 1 (the classes) last, and its
    inverse."""
    perm = (0,) + tuple(range(2, data.dim())) + (1,)
    inv = tuple(sorted(range(len(perm)), key=perm.__getitem__))
    return perm, inv


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis whose backward is the loss gradient
    ``(p - onehot(label)) * grad_scale`` whatever the head gradient
    (the reference's custom VJP, ``mxnet_tpu/ops/nn.py:322-353``):
    ``smooth_alpha`` smooths the one-hot, ``use_ignore`` zeroes the rows
    whose label is ``ignore_label``, and ``normalize`` divides by the
    leading (batch) extent (times :func:`global_batch_scope`'s world)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                smooth_alpha, normalize):
        out = torch.softmax(_float_of(data, -1), dim=-1)
        ctx.save_for_backward(out, label)
        ctx.hyper = (grad_scale, ignore_label, use_ignore, smooth_alpha,
                     normalize)
        ctx.world = _batch_world()
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, smooth_alpha, normalize = \
            ctx.hyper
        k = out.shape[-1]
        # an integer label outside [0, k) (ignore_label -1) is a zero row,
        # as jax.nn.one_hot makes it
        cls = torch.arange(k, device=out.device)
        oh = (label.to(torch.int32).unsqueeze(-1) == cls).to(out.dtype)
        if smooth_alpha:
            oh = oh * (1 - smooth_alpha) + smooth_alpha / (k - 1) * (1 - oh)
        grad = out - oh
        if use_ignore:
            grad = grad * (label != ignore_label).to(out.dtype).unsqueeze(-1)
        scale = grad_scale / (out.shape[0] * ctx.world) if normalize \
            else grad_scale
        return grad * scale, None, None, None, None, None, None


@register_op("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", smooth_alpha=0.0, out_grad=False):
    """Reference ``SoftmaxOutput`` (``mxnet_tpu/ops/nn.py:356``): the
    softmax of ``data`` over its last axis, or over axis 1 when
    ``multi_output`` or ``data`` has more than two axes, with the loss
    backward of :class:`_SoftmaxOutput`.  As in the reference,
    ``normalization="valid"`` divides the gradient by the batch extent
    and ``"batch"`` by nothing."""
    hyper = (float(grad_scale), float(ignore_label), bool(use_ignore),
             float(smooth_alpha), normalization == "valid")
    if multi_output or data.dim() > 2:
        perm, inv = _class_last(data)
        out = _SoftmaxOutput.apply(data.permute(perm), label, *hyper)
        return out.permute(inv)
    return _SoftmaxOutput.apply(data, label, *hyper)


class _RegressionOutput(torch.autograd.Function):
    """``transform(data)`` forward; backward ``grad_fn(out, label) *
    grad_scale / batch`` whatever the head gradient
    (``mxnet_tpu/ops/nn.py:377-400``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = _REGRESSION[kind][0](data)
        ctx.save_for_backward(out, label)
        ctx.grad_scale, ctx.kind = grad_scale, kind
        ctx.world = _batch_world()
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        batch = (out.shape[0] if out.dim() else 1) * ctx.world
        grad = _REGRESSION[ctx.kind][1](out, label)
        return grad * (ctx.grad_scale / batch), None, None, None


_REGRESSION = {
    "LinearRegressionOutput": (lambda x: x, lambda o, lab: o - lab),
    "LogisticRegressionOutput": (torch.sigmoid, lambda o, lab: o - lab),
    "MAERegressionOutput": (lambda x: x,
                            lambda o, lab: torch.sign(o - lab)),
}


def _make_regression(name):
    @register_op(name)
    def _reg(data, label, *, grad_scale=1.0):
        return _RegressionOutput.apply(data, label.reshape(data.shape),
                                       float(grad_scale), name)

    _reg.__name__ = name
    _reg.__doc__ = f"Reference ``{name}`` (``mxnet_tpu/ops/nn.py:406``)."
    return _reg


for _name in _REGRESSION:
    _make_regression(_name)
