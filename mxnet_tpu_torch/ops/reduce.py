"""Reductions and index reductions (counterpart of
``mxnet_tpu/ops/reduce.py``).

Result dtypes follow the reference's jnp: an integer or bool sum or
product accumulates in int32 (uint32 for unsigned types), a mean or
variance of integers is float32, argmax/argmin return float32.
"""
from __future__ import annotations

import torch

from ..dtype import normalize_dtype
from .registry import register_op

_SMALL_INT = (torch.bool, torch.int8, torch.int16, torch.int32)
_SMALL_UINT = (torch.uint8, torch.uint16, torch.uint32)


def _axes(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return None  # reduce over everything
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(sorted(a % ndim for a in axis))
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _acc_dtype(dtype):
    """jnp's sum/prod result dtype for an input dtype."""
    if dtype in _SMALL_INT:
        return torch.int32
    if dtype in _SMALL_UINT:
        return torch.uint32
    return dtype


def _inexact(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _sum(x, ax, keepdims):
    rt = _acc_dtype(x.dtype)
    if ax == ():
        return x.to(rt)
    # torch has no uint32 sum: accumulate in int64 and wrap to uint32
    acc = torch.int64 if rt == torch.uint32 else rt
    return torch.sum(x, dim=ax, keepdim=keepdims, dtype=acc).to(rt)


def _nansum(x, ax, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype), x)
    return _sum(x, ax, keepdims)


def _prod(x, ax, keepdims):
    rt = _acc_dtype(x.dtype)
    acc = torch.int64 if rt == torch.uint32 else rt
    x = x.to(acc)
    dims = range(x.ndim) if ax is None else ax
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims)
    return x.to(rt)


def _nanprod(x, ax, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype), x)
    return _prod(x, ax, keepdims)


def _mean(x, ax, keepdims):
    x = _inexact(x)
    if ax == ():
        return x
    return torch.mean(x, dim=ax, keepdim=keepdims)


def _extreme(f):
    def op(x, ax, keepdims):
        if ax == ():
            return x
        return f(x, dim=() if ax is None else ax, keepdim=keepdims)

    return op


_FNS = {"sum": _sum, "mean": _mean, "prod": _prod, "nansum": _nansum,
        "nanprod": _nanprod, "max": _extreme(torch.amax),
        "min": _extreme(torch.amin)}


def _reduce(f):
    def op(x, *, axis=None, keepdims=False, exclude=False):
        return f(x, _axes(axis, x.ndim, exclude), keepdims)

    return op


for _n, _f in _FNS.items():
    register_op(_n, aliases=(f"{_n}_axis",))(_reduce(_f))


@register_op("norm")
def norm(x, *, ord=2, axis=None, keepdims=False, out_dtype=None):
    if isinstance(axis, int):
        axis = (axis,)
    if axis is not None:
        axis = tuple(a % x.ndim for a in axis)
    if ord == 1:
        r = _sum(torch.abs(x), axis, keepdims)
    else:
        r = torch.sqrt(_inexact(_sum(torch.square(x), axis, keepdims)))
    if out_dtype is not None:
        r = r.to(normalize_dtype(out_dtype))
    return r


def _index_reduce(f):
    def op(x, *, axis=None, keepdims=False):
        if x.dtype == torch.bool:  # torch's argmax refuses bool; jnp's not
            x = x.to(torch.uint8)
        if axis is None:
            return f(x.reshape(-1), 0).to(torch.float32)
        r = f(x, int(axis))
        if keepdims:
            r = torch.unsqueeze(r, int(axis))
        return r.to(torch.float32)

    return op


register_op("argmax", differentiable=False)(_index_reduce(torch.argmax))
register_op("argmin", differentiable=False)(_index_reduce(torch.argmin))


@register_op("argmax_channel", differentiable=False)
def argmax_channel(x):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return torch.argmax(x, 1).to(torch.float32)


@register_op("cumsum", aliases=("_np_cumsum",))
def cumsum(x, *, axis=None, dtype=None):
    if dtype is not None:
        x = x.to(normalize_dtype(dtype))
    rt = torch.int32 if x.dtype == torch.bool else x.dtype
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=rt)
    return torch.cumsum(x, axis, dtype=rt)


@register_op("moments", num_outputs=2)
def moments(x, *, axes=None, keepdims=False):
    """Reference: src/operator/nn/moments.cc; the variance is jnp's two
    passes, the mean of the squared deviations."""
    if isinstance(axes, int):
        axes = (axes,)
    x = _inexact(x)
    dims = None if axes is None else tuple(axes)
    mean = torch.mean(x, dim=dims, keepdim=True)
    c = x - mean
    var = torch.mean(c * c, dim=dims, keepdim=keepdims)
    return mean.reshape(var.shape), var
