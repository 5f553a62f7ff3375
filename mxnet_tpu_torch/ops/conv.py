"""Convolution and Pooling (counterpart of ``mxnet_tpu/ops/conv.py``).

The port keeps the reference's channel-last layout at its functions:
activations NHWC, convolution weights ``O*kI`` = ``(Co, kh, kw, Ci)``
(``mxnet_tpu/ops/conv.py:9-13``).  Inside, both are permuted to the
NCHW/OIHW views ``F.conv2d`` takes; those views have channels-last
strides, so cuDNN runs its NHWC kernels and nothing is copied.  As the
reference leaves convolutions to XLA, the port leaves them to cuDNN.

Channel-first (NCHW) layouts are not ported yet (ROADMAP §A) and raise.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["convolution", "pooling", "CHANNEL_LAST", "CHANNEL_FIRST"]

CHANNEL_LAST = frozenset(("NWC", "NHWC", "NDHWC"))
CHANNEL_FIRST = frozenset(("NCW", "NCHW", "NCDHW"))


def _tup(v, n, default=1):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _check_nhwc(layout, nd, what):
    if layout in CHANNEL_LAST and nd == 2:
        return
    if layout is None or layout in CHANNEL_FIRST or layout in CHANNEL_LAST:
        raise MXNetError(
            f"{what}: layout {layout or 'NCHW'} with {nd} spatial dims is "
            "not ported yet (ROADMAP §A); build the net with "
            "layout='NHWC'")
    raise MXNetError(f"unsupported layout {layout!r} for {nd}d {what}")


def convolution(data, weight, bias=None, *, kernel, num_filter,
                stride=None, dilate=None, pad=None, num_group=1,
                no_bias=False, layout=None):
    """2-d convolution over NHWC ``data`` with an ``O*kI`` weight
    (reference ``Convolution``, ``mxnet_tpu/ops/conv.py:119``)."""
    nd = len(kernel)
    _check_nhwc(layout, nd, "Convolution")
    if weight.shape[0] != num_filter:
        raise MXNetError(f"Convolution: weight has {weight.shape[0]} "
                         f"filters, num_filter={num_filter}")
    out = F.conv2d(data.permute(0, 3, 1, 2), weight.permute(0, 3, 1, 2),
                   None, _tup(stride, nd), _tup(pad, nd, 0),
                   _tup(dilate, nd), num_group)
    out = out.permute(0, 2, 3, 1)
    if not no_bias and bias is not None:
        out = out + bias
    return out


def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Max or average pooling over NHWC ``data`` (reference ``Pooling``,
    ``mxnet_tpu/ops/conv.py:214``); ``global_pool`` reduces all of H
    and W.  Padding of a max pool never wins (-inf), as there."""
    nd = data.dim() - 2
    _check_nhwc(layout, nd, "Pooling")
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"Pooling: pool_type {pool_type!r} is not "
                         "ported yet")
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=(1, 2), keepdim=True)
        return data.sum(dim=(1, 2), keepdim=True) / (data.shape[1] *
                                                      data.shape[2])
    if pooling_convention != "valid":
        raise MXNetError(f"Pooling: pooling_convention "
                         f"{pooling_convention!r} is not ported yet")
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd)
    pad = _tup(pad, nd, 0)
    x = data.permute(0, 3, 1, 2)
    if pool_type == "max":
        out = F.max_pool2d(x, kernel, stride, pad)
    else:
        out = F.avg_pool2d(x, kernel, stride, pad,
                           count_include_pad=count_include_pad)
    return out.permute(0, 2, 3, 1)
