"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
HybridSequential, Dense, BatchNorm, Flatten."""
from __future__ import annotations

import torch

from ...ops.nn import batch_norm, fully_connected
from ..block import HybridBlock, state_writes_dropped

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten"]


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
    """Fully-connected layer, ``x @ W.T + b`` over the flattened input.
    ``in_units`` is required (no deferred shape inference)."""

    def __init__(self, units, use_bias=True, flatten=True, dtype="float32",
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype)
            else:
                self.bias = None

    def forward(self, x):
        return fully_connected(x, self.weight, self.bias,
                               no_bias=self.bias is None,
                               num_hidden=self._units, flatten=self._flatten)


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics.  In training mode
    the batch statistics fold into the running averages
    (``m·running + (1-m)·batch``), except inside
    ``block.drop_state_writes`` — the reference's train step loses that
    write, and the port's reproduces it.  ``in_channels`` is required.
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
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, differentiable=False)

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
