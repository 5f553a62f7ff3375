"""Neural-network ops (counterpart of ``mxnet_tpu/ops/nn.py``): the
subset ResNet training runs — FullyConnected, Activation, log_softmax,
pick and BatchNorm with its fused backward.

BatchNorm keeps the reference's numerics policy: statistics in fp32
whatever the activation dtype (one pass E[x], E[x²] for bf16/fp16, two
passes for fp32, ``_bn_stats``), and a custom backward whose residuals
are the original activation plus per-channel statistics
(``_bn_train``'s custom VJP, ``mxnet_tpu/ops/nn.py:153-215``), here a
``torch.autograd.Function``.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["fully_connected", "activation", "log_softmax", "pick",
           "batch_norm"]


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


def activation(x, *, act_type):
    """Reference ``Activation`` (``mxnet_tpu/ops/nn.py:35``): relu,
    sigmoid, tanh, softrelu (softplus) or softsign."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"unknown act_type {act_type!r} (one of "
                         f"{sorted(_ACTIVATIONS)})")
    return fn(x)


def log_softmax(x, *, axis=-1):
    """Reference ``log_softmax`` (``mxnet_tpu/ops/nn.py:93``)."""
    return torch.log_softmax(x, dim=axis)


def pick(data, index, *, axis=-1, keepdims=False):
    """Elements of ``data`` at integer positions ``index`` along
    ``axis`` (indices are taken as integers, like the reference's
    float labels)."""
    idx = index.to(torch.long).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


# ------------------------------------------------------------ BatchNorm
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
        mean, var = _bn_stats(data, ax)
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
        dx32 = (inv * g32).reshape(bshape) * (
            dy32 - (sum_dy / n).reshape(bshape)
            - xhat * (sum_dy_xhat / n).reshape(bshape))
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


def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, train=False):
    """Reference ``BatchNorm`` (``mxnet_tpu/ops/nn.py:220``).  Pure: with
    ``output_mean_var`` it returns (out, batch_mean, batch_var) and the
    caller folds the batch statistics into its running averages."""
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
