"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

The reference's name-suffix dispatch (``*weight`` takes the rule,
``*bias``/``*beta``/``*running_mean`` zeros, ``*gamma``/``*running_var``
ones) and the registry by lowercase name.  Values are drawn on the host
from a ``torch.Generator`` the caller passes (None = torch's default
generator), so a seed gives the same weights on every device; the two
packages' random streams differ, so tests carry weights across with
``parallel.load_jax_params`` instead.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "create", "register", "Zero", "One",
           "Uniform", "Xavier"]

_REGISTRY: dict[str, type] = {}


def register(klass):
    """Class decorator: register an Initializer under its lowercase
    name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, *args, **kwargs):
    """An Initializer instance from an instance or a registered name."""
    if isinstance(name, Initializer):
        return name
    key = name.lower() if isinstance(name, str) else name
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _REGISTRY[key](*args, **kwargs)


class InitDesc(str):
    """A parameter's name, as the reference passes it to initializers."""


class Initializer:
    """Base: ``init(desc, shape, generator=None)`` -> fp32 host tensor."""

    def __call__(self, desc, shape, generator=None):
        name = str(desc)
        if name.endswith("weight"):
            return self._init_weight(name, shape, generator)
        if name.endswith(("bias", "beta", "running_mean", "moving_mean",
                          "min", "max")):
            return torch.zeros(shape)
        if name.endswith(("gamma", "running_var", "moving_var")):
            return torch.ones(shape)
        return self._init_weight(name, shape, generator)

    def _init_weight(self, name, shape, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}()"


@register
class Zero(Initializer):
    def _init_weight(self, name, shape, generator):
        return torch.zeros(shape)


_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, shape, generator):
        return torch.ones(shape)


_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, shape, generator):
        return torch.empty(shape).uniform_(-self.scale, self.scale,
                                           generator=generator)


@register
class Xavier(Initializer):
    """Glorot init; magnitude/factor_type semantics match the reference
    (fan_in = shape[1]·prod(shape[2:]), so an O*kI conv weight counts
    kh as its input dim, as there)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, shape, generator):
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier requires >=2D shape for {name}, got {shape}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return torch.empty(shape).uniform_(-scale, scale,
                                               generator=generator)
        if self.rnd_type == "gaussian":
            return torch.empty(shape).normal_(0.0, scale,
                                              generator=generator)
        raise MXNetError("Unknown random type")
