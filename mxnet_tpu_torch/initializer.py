"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

The reference's name-suffix dispatch (``*weight`` takes the rule,
``*bias``/``*beta``/``*running_mean`` zeros, ``*gamma``/``*running_var``
ones), the ``__init__`` attribute override of an :class:`InitDesc` and
the registry by lowercase name.  Values are drawn on the host, so a
seed gives the same weights on every device: without a generator from
numpy's global RNG with the reference's calls (``np.random.uniform``/
``normal``, float64, then cast), so ``np.random.seed(s)`` followed by
``initialize()`` gives the reference's weights bit for bit; with a
``torch.Generator`` the caller passes, from that generator.

An initializer is called as ``init(desc, shape, generator=None)`` (the
Gluon form) or as the reference's ``init(desc, shape, dtype)`` (the
Module form: a dtype name in the third place); either returns a host
tensor, float32 unless a dtype is given.
"""
from __future__ import annotations

import json
import math
import re

import numpy as onp
import torch

from .base import MXNetError
from .dtype import normalize_dtype

__all__ = ["InitDesc", "Initializer", "create", "register", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed"]

_REGISTRY: dict[str, type] = {}


def register(klass):
    """Class decorator: register an Initializer under its lowercase
    name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, *args, **kwargs):
    """An Initializer instance from an instance, a function ``fn(name,
    out)`` filling a float32 array, or a registered name."""
    if isinstance(name, Initializer):
        return name
    if callable(name) and not isinstance(name, type):
        return _WrapFn(name)
    key = name.lower() if isinstance(name, str) else name
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _REGISTRY[key](*args, **kwargs)


class InitDesc(str):
    """A parameter's name with its attributes, as the reference passes
    it to initializers (an ``__init__`` attribute names the initializer
    that takes precedence)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _uniform(low, high, shape, generator):
    """Uniform draws on the host: numpy's global RNG as the reference
    draws (float64) without a generator, else ``generator``'s."""
    if generator is None:
        return torch.from_numpy(onp.random.uniform(low, high, size=shape))
    return torch.empty(shape).uniform_(low, high, generator=generator)


def _normal(sigma, shape, generator):
    """Normal(0, sigma) draws on the host, as :func:`_uniform`."""
    if generator is None:
        return torch.from_numpy(onp.random.normal(0, sigma, size=shape))
    return torch.empty(shape).normal_(0.0, sigma, generator=generator)


def _gen_and_dtype(third, dtype):
    """(generator, dtype): the Gluon form passes a generator third, the
    Module form a dtype; float32 unless a dtype is given."""
    if third is None or isinstance(third, torch.Generator):
        return third, normalize_dtype(dtype) if dtype else torch.float32
    return None, normalize_dtype(third)


class Initializer:
    """Base: ``init(desc, shape, generator_or_dtype)`` -> host tensor."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """The ``[name, kwargs]`` JSON the reference stores in a
        variable's ``__init__`` attribute."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, shape, generator=None, dtype=None):
        generator, out_dtype = _gen_and_dtype(generator, dtype)
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        return self._dispatch(desc, tuple(shape), generator).to(out_dtype)

    def _dispatch(self, desc, shape, generator):
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            return create(klass, **kwargs)._init_weight(str(desc), shape,
                                                        generator)
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
        return f"{self.__class__.__name__}({self._kwargs})"


class _WrapFn(Initializer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def _init_weight(self, name, shape, generator):
        import numpy as onp

        out = onp.zeros(shape, dtype="float32")
        r = self._fn(name, out)
        return torch.from_numpy(onp.asarray(out if r is None else r,
                                            dtype="float32"))


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
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, generator):
        return torch.full(shape, float(self.value))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, generator):
        return _uniform(-self.scale, self.scale, shape, generator)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, generator):
        return _normal(self.sigma, shape, generator)


@register
class Orthogonal(Initializer):
    """Saxe et al. 2013 exact solutions init (reference initializer.py):
    the orthogonal factor of a random (nout, nin) matrix, scaled."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, shape, generator):
        nout = shape[0]
        nin = math.prod(shape[1:]) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = _uniform(-1.0, 1.0, (nout, nin), generator)
        else:
            tmp = _normal(1.0, (nout, nin), generator)
        # numpy's SVD, as the reference takes it (the factors' signs
        # are the LAPACK driver's)
        u, _, v = onp.linalg.svd(tmp.to(torch.float64).numpy(),
                                 full_matrices=False)
        q = u if u.shape == tuple(tmp.shape) else v
        return torch.from_numpy(self.scale * q).reshape(shape)


@register
class Xavier(Initializer):
    """Glorot init; magnitude/factor_type semantics match the reference
    (fan_in = shape[1]·prod(shape[2:]), so an O*kI conv weight counts
    kh as its input dim, as there)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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
            return _uniform(-scale, scale, shape, generator)
        if self.rnd_type == "gaussian":
            return _normal(scale, shape, generator)
        raise MXNetError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He init for PReLU nets: gaussian Xavier with magnitude
    2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel (deconv UpSampling weights)."""

    def _init_weight(self, name, shape, generator):
        n = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(n, dtype=torch.int64)
        x = (i % shape[3]).to(torch.float64)
        y = ((i // shape[3]) % shape[2]).to(torch.float64)
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        return w.to(torch.float32).reshape(shape)


@register
class LSTMBias(Initializer):
    """Forget-gate bias = forget_bias, others 0 (gate order i, f, c, o
    in the fused RNN weight layout)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, shape, generator):
        b = torch.zeros(shape)
        num_hidden = shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        return b


def _host(v):
    data = v._data if hasattr(v, "_data") else torch.as_tensor(v)
    return data.detach().to("cpu")


class Load:
    """Init from a dict of arrays (``arg:``/``aux:`` prefixes dropped),
    falling back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, shape, generator=None, dtype=None):
        gen, out_dtype = _gen_and_dtype(generator, dtype)
        if name in self.param:
            arr = _host(self.param[name])
            if tuple(arr.shape) != tuple(shape):
                raise MXNetError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {shape} vs loaded "
                    f"{tuple(arr.shape)}")
            return arr.to(out_dtype)
        if self.default_init is None:
            raise MXNetError(
                f"Cannot Initialize parameter {name}: not found in loaded "
                "params and no default initializer")
        return self.default_init(name, shape, gen, dtype=out_dtype)


class Mixed:
    """Patterns -> initializers, first regex match wins."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers length mismatch")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, shape, generator=None, dtype=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                return init(name, shape, generator, dtype=dtype)
        raise MXNetError(
            f"Parameter name {name} did not match any pattern. "
            'Consider adding a ".*" pattern at the end.')
