"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
HybridSequential, Dense, Dropout, BatchNorm, Flatten."""
from __future__ import annotations

import math

import torch

from ...ops.nn import batch_norm, dropout, fully_connected
from ..block import HybridBlock, state_writes_dropped
from .activations import Activation

__all__ = ["HybridSequential", "Dense", "Dropout", "BatchNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Stack of blocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer, ``x @ W.T + b`` over the flattened input,
    then ``activation`` if given.  ``in_units=0`` defers the input width
    to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

    def forward(self, x):
        out = fully_connected(x, self.weight, self.bias,
                              no_bias=self.bias is None,
                              num_hidden=self._units, flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Dropout of ``rate`` (reference ``basic_layers.py:159``): active
    while the block trains (``autograd.record()`` on NDArrays, or
    ``block.train()``), the identity otherwise.  ``axes`` share one mask
    draw along them.  The mask comes from the input device's generator,
    or from the step's key inside ``parallel``'s train step."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        if self._rate <= 0:
            return x
        return dropout(x, p=self._rate, axes=self._axes, train=self.training)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics.  In training mode
    the batch statistics fold into the running averages
    (``m·running + (1-m)·batch``), except inside
    ``block.drop_state_writes`` — the reference's train step loses that
    write, and the port's reproduces it.  ``in_channels=0`` defers the
    channel count to the first forward.  ``cast`` to a half type keeps
    the parameters fp32, as in the reference.
    """

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        if axis is None:  # default follows the nn.default_layout scope
            from .layout import channel_axis

            axis = channel_axis()
        self._kwargs = {"axis": axis, "eps": epsilon,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._momentum = momentum
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _infer_param_shapes(self, x, *args):
        channels = x.shape[self._axis]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self._reg_params[name].shape = (channels,)

    def cast(self, dtype):
        if str(dtype).replace("torch.", "") in ("float16", "bfloat16"):
            dtype = "float32"  # statistics and affine stay fp32
        super().cast(dtype)

    def update_running(self, batch_mean, batch_var):
        """Fold batch statistics into the running averages (no-op
        inside ``drop_state_writes``)."""
        if state_writes_dropped():
            return
        m = self._momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * batch_mean)
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * batch_var)

    def forward(self, x):
        if self.training and not self._kwargs["use_global_stats"]:
            out, batch_mean, batch_var = batch_norm(
                x, self.gamma, self.beta, self.running_mean,
                self.running_var, output_mean_var=True, train=True,
                **self._kwargs)
            self.update_running(batch_mean, batch_var)
            return out
        return batch_norm(x, self.gamma, self.beta, self.running_mean,
                          self.running_var, **self._kwargs)


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)
