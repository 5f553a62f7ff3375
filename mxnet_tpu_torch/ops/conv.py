"""Convolution and Pooling (counterpart of ``mxnet_tpu/ops/conv.py``).

Both of the reference's layout families (``mxnet_tpu/ops/conv.py:9-13``):
channel-first NCW/NCHW/NCDHW with ``OI*k`` weights (num_filter,
C/group, *k), the default, and channel-last NWC/NHWC/NDHWC with ``O*kI``
weights (num_filter, *k, C/group).  Channel-first is PyTorch's own
layout and goes to ``F.conv{1,2,3}d`` as it is.  Channel-last is
permuted to the channel-first views those functions take; the views
have channels-last strides, so cuDNN runs its NHWC kernels and nothing
is copied.  As the reference leaves convolutions to XLA, the port
leaves them to cuDNN.  Both are registered ops under the reference's
names and keywords (``workspace``, ``cudnn_tune`` and ``cudnn_off`` are
taken and ignored, as there).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import _inexact
from .registry import register_op

__all__ = ["convolution", "pooling", "CHANNEL_LAST", "CHANNEL_FIRST"]

CHANNEL_LAST = frozenset(("NWC", "NHWC", "NDHWC"))
CHANNEL_FIRST = frozenset(("NCW", "NCHW", "NCDHW"))

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tup(v, n, default=1):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _channel_last(layout, nd, what):
    """Is ``layout`` (None = channel-first) channel-last?  Raises on a
    layout the reference does not take or that disagrees with ``nd``."""
    if nd not in _CONV:
        raise MXNetError(f"{what}: {nd} spatial dims (1 to 3 are taken)")
    if layout is None:
        return False
    if layout in CHANNEL_FIRST or layout in CHANNEL_LAST:
        if len(layout) != nd + 2:
            raise MXNetError(f"{what}: layout {layout} does not have "
                             f"{nd} spatial dims")
        return layout in CHANNEL_LAST
    raise MXNetError(f"unsupported layout {layout!r} for {nd}d {what}")


def _first(x):
    """A channel-last tensor's channel-first view (no copy)."""
    return x.movedim(-1, 1)


def _last(x):
    return x.movedim(1, -1)


@register_op("Convolution", aliases=("Convolution_v1",))
def convolution(data, weight, bias=None, *, kernel, num_filter,
                stride=None, dilate=None, pad=None, num_group=1,
                no_bias=False, workspace=1024, cudnn_tune=None,
                cudnn_off=False, layout=None):
    """Convolution in either layout family (reference ``Convolution``,
    ``mxnet_tpu/ops/conv.py:119``): symmetric ``pad``, ``stride``,
    ``dilate`` and ``num_group`` groups."""
    nd = len(kernel)
    cl = _channel_last(layout, nd, "Convolution")
    if weight.shape[0] != num_filter:
        raise MXNetError(f"Convolution: weight has {weight.shape[0]} "
                         f"filters, num_filter={num_filter}")
    x, w = (_first(data), _first(weight)) if cl else (data, weight)
    out = _CONV[nd](x, w, None, _tup(stride, nd), _tup(pad, nd, 0),
                    _tup(dilate, nd), num_group)
    if cl:
        out = _last(out)
    if not no_bias and bias is not None:
        out = out + (bias if cl else bias.reshape((1, -1) + (1,) * nd))
    return out


def _full_extra(size, kernel, stride, pad):
    """Extra right padding of ``pooling_convention="full"`` (ceil mode):
    enough that the last window fits, as the reference pads."""
    rem = (size + 2 * pad - kernel) % stride
    return (stride - rem) % stride if rem else 0


@register_op("Pooling", aliases=("Pooling_v1",))
def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, p_value=2,
            layout=None):
    """Max, average, sum or Lp pooling in either layout family
    (reference ``Pooling``, ``mxnet_tpu/ops/conv.py:214``).
    ``global_pool`` reduces all spatial dims.  ``pooling_convention``
    "full" pads the right edge so that the last window fits (ceil
    mode).  Padding never wins a max pool (-inf) and adds 0 to a sum; an
    average divides by the kernel's size, or with ``count_include_pad``
    False by the number of elements that are not padding, as there."""
    nd = data.dim() - 2
    cl = _channel_last(layout, nd, "Pooling")
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type!r}")
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"Pooling: unknown pooling_convention "
                         f"{pooling_convention!r}")
    x = _first(data) if cl else data
    if global_pool:
        spatial = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = x.amax(dim=spatial, keepdim=True)
        elif pool_type == "lp":
            out = x.abs().pow(p_value).sum(dim=spatial, keepdim=True) \
                .pow(1.0 / p_value)
        else:
            # an integer sum keeps the input's type, as reduce_window's
            out = x.sum(dim=spatial, keepdim=True, dtype=x.dtype)
            if pool_type == "avg":
                out = _inexact(out) / math.prod(x.shape[2:])
        return _last(out) if cl else out
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd)
    pad = _tup(pad, nd, 0)
    extra = [0] * nd
    if pooling_convention == "full":
        extra = [_full_extra(x.shape[2 + i], kernel[i], stride[i], pad[i])
                 for i in range(nd)]
    if pool_type in ("avg", "sum") and not x.is_floating_point():
        out = _int_pool(x, pool_type, kernel, stride, pad, extra,
                        count_include_pad)
    else:
        out = _pool(x, pool_type, kernel, stride, pad, extra,
                    count_include_pad, p_value)
    return _last(out) if cl else out


def _int_pool(x, pool_type, kernel, stride, pad, extra, count_include_pad):
    """A windowed sum or average of integer ``x``, as the reference's
    ``reduce_window`` gives it: the sum exact in the input's type, the
    average that sum in float32 over the window's size (or, without
    ``count_include_pad``, over its count of elements that are not
    padding)."""
    nd = len(kernel)
    widths = []
    for p, e in reversed(list(zip(pad, extra))):
        widths += [p, p + e]
    win = F.pad(x.to(torch.int64), widths)
    for i in range(nd):
        win = win.unfold(2 + i, kernel[i], stride[i])
    dims = tuple(range(-nd, 0))
    total = win.sum(dim=dims).to(x.dtype)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total.to(torch.float32) / math.prod(kernel)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.int64,
                            device=x.device), widths)
    for i in range(nd):
        ones = ones.unfold(2 + i, kernel[i], stride[i])
    return total.to(torch.float32) / ones.sum(dim=dims).to(torch.float32)


def _pool(x, pool_type, kernel, stride, pad, extra, count_include_pad,
          p_value):
    """Pooling of channel-first ``x``: left padding ``pad``, right
    padding ``pad + extra``."""
    nd = len(kernel)
    if (pool_type in ("max", "avg") and not any(extra)
            and all(2 * p <= k for p, k in zip(pad, kernel))):
        # what PyTorch's pooling takes as it is (padding at most half a
        # window, the same on both sides)
        if pool_type == "max":
            return _MAX_POOL[nd](x, kernel, stride, pad)
        return _AVG_POOL[nd](x, kernel, stride, pad,
                             count_include_pad=count_include_pad)
    # any padding: pad explicitly, then pool without padding
    widths = []
    for p, e in reversed(list(zip(pad, extra))):
        widths += [p, p + e]
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(x, widths, value=-math.inf), kernel,
                             stride)
    size = math.prod(kernel)
    base = x.abs().pow(p_value) if pool_type == "lp" else x
    total = _AVG_POOL[nd](F.pad(base, widths), kernel, stride) * size
    if pool_type == "sum":
        return total
    if pool_type == "lp":
        return total.pow(1.0 / p_value)
    if count_include_pad:
        return total / size
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    count = _AVG_POOL[nd](F.pad(ones, widths), kernel, stride) * size
    return total / count
