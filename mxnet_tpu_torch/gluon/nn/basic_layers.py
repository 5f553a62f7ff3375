"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``):
Sequential, HybridSequential, Dense, Dropout, BatchNorm, Embedding,
Flatten, Lambda, HybridLambda."""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...base import MXNetError
from ...ops.nn import batch_norm, dropout, fully_connected
from ...ops.shape_ops import embedding
from ..block import (Block, HybridBlock, _to_ndarray, _unwrap,
                     state_writes_dropped)
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "Flatten", "Lambda", "HybridLambda"]


class _Stack:
    """What the two sequential containers share: ``add``, running the
    children in order, ``len``, iteration and indexing (a slice is a new
    container of the same type over the same blocks)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers


class Sequential(_Stack, Block):
    """Stack of Blocks run in order (reference ``basic_layers.py:32``)."""


class HybridSequential(_Stack, HybridBlock):
    """Stack of HybridBlocks run in order."""


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

    def hybrid_forward(self, F, x, weight, bias=None):
        # reference basic_layers.py:139-146; without a bias the weight is
        # the last input (the reference passes None there and cannot be
        # traced, ROADMAP §C)
        args = (x, weight) if bias is None else (x, weight, bias)
        out = F.FullyConnected(*args, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


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

    def hybrid_forward(self, F, x):
        # reference basic_layers.py:165-168
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

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

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        # reference basic_layers.py:222-244, predicting (a trace is not
        # recorded); the attributes in the reference's order
        kw = self._kwargs
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           axis=kw["axis"], eps=kw["eps"],
                           momentum=self._momentum,
                           fix_gamma=kw["fix_gamma"],
                           use_global_stats=kw["use_global_stats"])


class Embedding(HybridBlock):
    """Rows of a ``(input_dim, output_dim)`` weight looked up by index
    (reference ``basic_layers.py:351``); ``sparse_grad`` is accepted and
    ignored, as the reference ignores it."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._dtype = dtype
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return embedding(x, self.weight, input_dim=self._input_dim,
                         output_dim=self._output_dim, dtype=self._dtype)

    def hybrid_forward(self, F, x, weight):
        # reference basic_layers.py:364-368
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, dtype=self._dtype)

    def __repr__(self):
        return (f"Embedding({self._input_dim} -> {self._output_dim}, "
                f"{self._dtype})")


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        # reference basic_layers.py:375-376
        return F.Flatten(x)


def _function(function):
    """``(callable, name)`` of a Lambda's function: a callable, or the
    name of an ``mx.nd`` function."""
    from ... import ndarray as nd

    if isinstance(function, str):
        if not hasattr(nd, function):
            raise MXNetError(f"Function name {function} is not found in nd.")
        return getattr(nd, function), function
    if callable(function):
        return function, function.__name__
    raise MXNetError(f"Unrecognized function in lambda: {function} of type "
                     f"{type(function)}")


def _on_ndarrays(fn, block, args):
    """``fn`` on ``args`` as NDArrays (the reference's Lambda computes
    with ``mx.nd``), recorded when torch records, in ``block``'s
    mode; the result's tensors come back."""
    with autograd._Scope(torch.is_grad_enabled(), block.training):
        return _unwrap(fn(*_to_ndarray(args)))


class Lambda(Block):
    """A function (or the name of an ``mx.nd`` function) as a Block
    (reference ``basic_layers.py:385``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._function = function
        self._func_impl, self._func_name = _function(function)

    def forward(self, *args):
        return _on_ndarrays(self._func_impl, self, args)

    def _call_symbol(self, *args, **kwargs):
        # a named function from mx.sym, or the function itself on Symbols
        from ... import symbol as F

        fn = getattr(F, self._function) if isinstance(self._function, str) \
            else self._function
        return fn(*args, **kwargs)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """A function ``f(F, x, *args)`` (or the name of an ``mx.nd``
    function) as a HybridBlock (reference ``basic_layers.py:411``);
    ``F`` is ``mx.nd``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as nd

        impl, self._func_name = _function(function)
        self._function = function
        self._func = impl if isinstance(function, str) else \
            (lambda *args: impl(nd, *args))

    def forward(self, x, *args):
        return _on_ndarrays(self._func, self, (x,) + args)

    def hybrid_forward(self, F, x, *args):
        # reference basic_layers.py:411-433
        if isinstance(self._function, str):
            return getattr(F, self._function)(x, *args)
        return self._function(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"
