"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``;
reference python/mxnet/ndarray/random.py): the module-level samplers
over the random ops.  A sampler with scalar parameters creates its
output on ``ctx`` (default the current context) from that device's
generator; one with NDArray parameters samples beside them."""
from __future__ import annotations

from .ndarray import NDArray, invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "uniform_like", "normal_like"]


def _shape(shape):
    if shape is None:
        return (1,)
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if isinstance(low, NDArray):
        return invoke("sample_uniform", [low, high], out=out, dtype=dtype,
                      shape=tuple(shape) if shape else ())
    return invoke("_random_uniform", [], out=out, low=float(low),
                  high=float(high), shape=_shape(shape), dtype=dtype,
                  ctx=ctx)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if isinstance(loc, NDArray):
        return invoke("sample_normal", [loc, scale], out=out, dtype=dtype,
                      shape=tuple(shape) if shape else ())
    return invoke("_random_normal", [], out=out, loc=float(loc),
                  scale=float(scale), shape=_shape(shape), dtype=dtype,
                  ctx=ctx)


def randn(*shape, dtype=None, ctx=None, **kw):
    return invoke("_random_normal", [], loc=float(kw.get("loc", 0)),
                  scale=float(kw.get("scale", 1)), shape=tuple(shape) or (1,),
                  dtype=dtype, ctx=ctx)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    return invoke("_random_gamma", [], out=out, alpha=float(alpha),
                  beta=float(beta), shape=_shape(shape), dtype=dtype, ctx=ctx)


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    return invoke("_random_exponential", [], out=out, lam=1.0 / float(scale),
                  shape=_shape(shape), dtype=dtype, ctx=ctx)


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    return invoke("_random_poisson", [], out=out, lam=float(lam),
                  shape=_shape(shape), dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kw):
    return invoke("_random_negative_binomial", [], out=out, k=int(k),
                  p=float(p), shape=_shape(shape), dtype=dtype, ctx=ctx)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kw):
    return invoke("_random_generalized_negative_binomial", [], out=out,
                  mu=float(mu), alpha=float(alpha), shape=_shape(shape),
                  dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None, **kw):
    return invoke("_random_randint", [], out=out, low=int(low),
                  high=int(high), shape=_shape(shape), dtype=dtype, ctx=ctx)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32",
                **kw):
    return invoke("_sample_multinomial", [data], out=out, shape=shape,
                  get_prob=get_prob, dtype=dtype)


def shuffle(data, **kw):
    return invoke("_shuffle", [data])


def uniform_like(data, low=0, high=1, **kw):
    return invoke("_random_uniform_like", [data], low=low, high=high)


def normal_like(data, loc=0, scale=1, **kw):
    return invoke("_random_normal_like", [data], loc=loc, scale=scale)
