"""Convolution and pooling blocks (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv2D, MaxPool2D, AvgPool2D,
GlobalAvgPool2D.  ``ceil_mode`` is the op's ``pooling_convention=
"full"``.  Channel-last weights are ``O*kI``; ``in_channels=0``
defers the input channel count to the first forward."""
from __future__ import annotations

from ...ops.conv import convolution, pooling
from ..block import HybridBlock
from .activations import Activation
from .layout import is_channel_last, resolve_layout

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _tup(val, n):
    if isinstance(val, int):
        return (int(val),) * n
    return tuple(int(v) for v in val)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        ndim = len(kernel_size)
        layout = resolve_layout(layout, ndim)
        self._channels = channels
        self._groups = groups
        self._channel_last = is_channel_last(layout)
        self._kwargs = {
            "kernel": tuple(kernel_size), "stride": _tup(strides, ndim),
            "dilate": _tup(dilation, ndim), "pad": _tup(padding, ndim),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout,
        }
        with self.name_scope():
            cig = in_channels // groups if in_channels else 0
            if self._channel_last:
                wshape = (channels,) + tuple(kernel_size) + (cig,)
            else:
                wshape = (channels, cig) + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        cig = (x.shape[-1] if self._channel_last else x.shape[1]) \
            // self._groups
        k = tuple(self._kwargs["kernel"])
        self._reg_params["weight"].shape = \
            (self._channels,) + k + (cig,) if self._channel_last \
            else (self._channels, cig) + k

    def forward(self, x):
        out = convolution(x, self.weight, self.bias, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def hybrid_forward(self, F, x, weight, bias=None):
        # reference conv_layers.py:113-120
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": _tup(strides, ndim),
            "pad": _tup(padding, ndim), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": resolve_layout(layout, ndim),
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def forward(self, x):
        return pooling(x, **self._kwargs)

    def hybrid_forward(self, F, x):
        # reference conv_layers.py:262-263
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), strides, _tup(padding, 2),
                         ceil_mode, False, "max", layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), strides, _tup(padding, 2),
                         ceil_mode, False, "avg", layout, count_include_pad,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        # ceil_mode True, as the reference's (the graph's attribute)
        super().__init__((1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)
