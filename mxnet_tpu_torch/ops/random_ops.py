"""Random sampling ops and the density ops (counterpart of
``mxnet_tpu/ops/random_ops.py``).

Every sampler is registered under the reference's names, aliases,
keywords and default dtypes (float32; ``randint`` and ``multinomial``
int32) with ``key_param="key"``: the dispatcher passes the
``torch.Generator`` the op draws from (``_rng.take_key``), and the
output lands on that generator's device.  The distributions are the
reference's: ``gamma``'s ``beta`` is a scale, ``exponential``'s ``lam``
a rate, the negative binomials are gamma-Poisson mixtures, and the
``sample_*`` ops draw one sample block per element of their parameter
arrays (output shape ``param.shape + shape``).  The streams are not
the reference's: JAX's counter-based keys have no PyTorch counterpart.

The ``_random_pdf_*`` ops compute (log-)densities; ``pdf_gamma``
reads ``beta`` as a rate, as the reference does.
"""
from __future__ import annotations

import math

import torch

from ..dtype import normalize_dtype
from .registry import register_op


def _dt(dtype, default="float32"):
    return normalize_dtype(dtype if dtype not in (None, "None") else default)


def _gen(key, ctx=None):
    """The op's generator: the dispatcher's, else the eager one of
    ``ctx`` (a context or device; default the current context)."""
    if key is not None:
        return key
    from .. import _rng
    from ..context import current_context, resolve_device

    return _rng.take_key(resolve_device(ctx if ctx is not None
                                        else current_context()))


def _std_gamma(alpha, g):
    """Gamma(alpha, 1) draws, one per element of ``alpha`` (float32)."""
    return torch._standard_gamma(alpha.to(torch.float32), generator=g)


def _poisson(lam, g):
    return torch.poisson(lam.to(torch.float32), generator=g)


def _full(shape, value, g):
    return torch.full(tuple(shape), float(value), dtype=torch.float32,
                      device=g.device)


@register_op("_random_uniform", aliases=("random_uniform", "uniform"),
             key_param="key", differentiable=False)
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None,
                   key=None):
    g = _gen(key, ctx)
    u = torch.rand(tuple(shape), generator=g, device=g.device,
                   dtype=_dt(dtype))
    return u * (high - low) + low


@register_op("_random_normal", aliases=("random_normal", "normal"),
             key_param="key", differentiable=False)
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None,
                  key=None):
    g = _gen(key, ctx)
    return torch.randn(tuple(shape), generator=g, device=g.device,
                       dtype=_dt(dtype)) * scale + loc


@register_op("_random_gamma", aliases=("random_gamma",), key_param="key",
             differentiable=False)
def random_gamma(*, alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None,
                 key=None):
    g = _gen(key, ctx)
    return (_std_gamma(_full(shape, alpha, g), g) * beta).to(_dt(dtype))


@register_op("_random_exponential", aliases=("random_exponential",),
             key_param="key", differentiable=False)
def random_exponential(*, lam=1.0, shape=(1,), dtype=None, ctx=None,
                       key=None):
    g = _gen(key, ctx)
    e = torch.empty(tuple(shape), dtype=torch.float32,
                    device=g.device).exponential_(1.0, generator=g)
    return (e / lam).to(_dt(dtype))


@register_op("_random_poisson", aliases=("random_poisson",), key_param="key",
             differentiable=False)
def random_poisson(*, lam=1.0, shape=(1,), dtype=None, ctx=None, key=None):
    g = _gen(key, ctx)
    return _poisson(_full(shape, lam, g), g).to(_dt(dtype))


@register_op("_random_negative_binomial",
             aliases=("random_negative_binomial",), key_param="key",
             differentiable=False)
def random_negative_binomial(*, k=1, p=1.0, shape=(1,), dtype=None, ctx=None,
                             key=None):
    g = _gen(key, ctx)
    lam = _std_gamma(_full(shape, k, g), g) * (1 - p) / p
    return _poisson(lam, g).to(_dt(dtype))


@register_op("_random_generalized_negative_binomial",
             aliases=("random_generalized_negative_binomial",),
             key_param="key", differentiable=False)
def random_gen_neg_binomial(*, mu=1.0, alpha=1.0, shape=(1,), dtype=None,
                            ctx=None, key=None):
    g = _gen(key, ctx)
    lam = _std_gamma(_full(shape, 1.0 / alpha, g), g) * (mu * alpha)
    return _poisson(lam, g).to(_dt(dtype))


@register_op("_random_randint", aliases=("random_randint", "randint"),
             key_param="key", differentiable=False)
def random_randint(*, low=0, high=None, shape=(1,), dtype=None, ctx=None,
                   key=None):
    g = _gen(key, ctx)
    return torch.randint(int(low), int(high), tuple(shape), generator=g,
                         device=g.device, dtype=_dt(dtype, "int32"))


@register_op("_sample_multinomial", aliases=("sample_multinomial",),
             key_param="key", differentiable=False)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32",
                       key=None):
    """Category indices drawn with probabilities ``data`` (one row per
    distribution); ``shape`` draws a block of that many per row."""
    g = _gen(key, data.device)
    n = shape if isinstance(shape, int) else (shape[0] if shape else 1)
    probs = torch.clamp_min(data.to(torch.float32), 1e-37)
    out = torch.multinomial(probs, n, replacement=True, generator=g)
    if not shape:
        out = out[..., 0]
    return out.to(_dt(dtype))


@register_op("_shuffle", aliases=("shuffle",), key_param="key",
             differentiable=False)
def shuffle(data, *, key=None):
    """A random permutation of ``data`` along axis 0."""
    g = _gen(key, data.device)
    perm = torch.randperm(data.shape[0], generator=g, device=g.device)
    return data[perm.to(data.device)]


def _bcast(p, s):
    """A parameter array of shape ``p.shape`` against the output shape
    ``s = p.shape + extra``."""
    return p.reshape(tuple(p.shape) + (1,) * (len(s) - p.dim()))


def _block(p, shape):
    return tuple(p.shape) + (tuple(shape) if shape else ())


@register_op("sample_uniform", key_param="key", differentiable=False)
def sample_uniform(low, high, *, shape=(), dtype=None, key=None):
    g = _gen(key, low.device)
    s = _block(low, shape)
    u = torch.rand(s, generator=g, device=g.device, dtype=_dt(dtype))
    return _bcast(low, s) + u * (_bcast(high, s) - _bcast(low, s))


@register_op("sample_normal", key_param="key", differentiable=False)
def sample_normal(mu, sigma, *, shape=(), dtype=None, key=None):
    g = _gen(key, mu.device)
    s = _block(mu, shape)
    z = torch.randn(s, generator=g, device=g.device, dtype=_dt(dtype))
    return _bcast(mu, s) + z * _bcast(sigma, s)


@register_op("sample_gamma", key_param="key", differentiable=False)
def sample_gamma(alpha, beta, *, shape=(), dtype=None, key=None):
    """One gamma block per (alpha, beta) pair; beta is the scale."""
    g = _gen(key, alpha.device)
    s = _block(alpha, shape)
    a = _bcast(alpha, s).expand(s)
    return (_std_gamma(a, g) * _bcast(beta, s)).to(_dt(dtype))


@register_op("sample_exponential", key_param="key", differentiable=False)
def sample_exponential(lam, *, shape=(), dtype=None, key=None):
    """Exponential blocks of rate ``lam``."""
    g = _gen(key, lam.device)
    s = _block(lam, shape)
    e = torch.empty(s, dtype=torch.float32,
                    device=g.device).exponential_(1.0, generator=g)
    return (e / _bcast(lam, s)).to(_dt(dtype))


@register_op("sample_poisson", key_param="key", differentiable=False)
def sample_poisson(lam, *, shape=(), dtype=None, key=None):
    g = _gen(key, lam.device)
    s = _block(lam, shape)
    return _poisson(_bcast(lam, s).expand(s), g).to(_dt(dtype))


@register_op("sample_negative_binomial", key_param="key",
             differentiable=False)
def sample_negative_binomial(k, p, *, shape=(), dtype=None, key=None):
    """Gamma-Poisson mixture with per-element (k, p)."""
    g = _gen(key, k.device)
    s = _block(k, shape)
    kb, pb = _bcast(k, s), _bcast(p, s)
    lam = _std_gamma(kb.expand(s), g) * (1 - pb) / pb
    return _poisson(lam, g).to(_dt(dtype))


@register_op("sample_generalized_negative_binomial", key_param="key",
             differentiable=False)
def sample_gen_negative_binomial(mu, alpha, *, shape=(), dtype=None,
                                 key=None):
    g = _gen(key, mu.device)
    s = _block(mu, shape)
    mub, ab = _bcast(mu, s), _bcast(alpha, s)
    lam = _std_gamma((1.0 / ab).expand(s), g) * (mub * ab)
    return _poisson(lam, g).to(_dt(dtype))


@register_op("_random_uniform_like", aliases=("uniform_like",),
             key_param="key", differentiable=False)
def uniform_like(data, *, low=0.0, high=1.0, key=None):
    g = _gen(key, data.device)
    u = torch.rand(data.shape, generator=g, device=g.device,
                   dtype=data.dtype)
    return u * (high - low) + low


@register_op("_random_normal_like", aliases=("normal_like",),
             key_param="key", differentiable=False)
def normal_like(data, *, loc=0.0, scale=1.0, key=None):
    g = _gen(key, data.device)
    return torch.randn(data.shape, generator=g, device=g.device,
                       dtype=data.dtype) * scale + loc


# ------------------------------------------------------- pdf op family
# Reference: src/operator/random/pdf_op.cc; each parameter array has
# one trailing sample axis fewer than ``sample``.
def _pdf_out(logp, is_log):
    return logp if is_log else torch.exp(logp)


def _last(p):
    return p.unsqueeze(-1)


def _xlogy(x, y):
    return torch.xlogy(x, y)


def _neg_inf(like):
    return torch.full_like(like, -math.inf)


@register_op("_random_pdf_uniform", aliases=("random_pdf_uniform",))
def pdf_uniform(sample, low, high, *, is_log=False):
    lo, hi = _last(low), _last(high)
    inside = (sample >= lo) & (sample <= hi)
    logp = torch.where(inside, -torch.log(hi - lo), _neg_inf(sample))
    return _pdf_out(logp, is_log)


@register_op("_random_pdf_normal", aliases=("random_pdf_normal",))
def pdf_normal(sample, mu, sigma, *, is_log=False):
    m, s = _last(mu), _last(sigma)
    logp = (-torch.square(sample - m) / (2 * s * s) - torch.log(s)
            - 0.5 * math.log(2 * math.pi))
    return _pdf_out(logp, is_log)


@register_op("_random_pdf_gamma", aliases=("random_pdf_gamma",))
def pdf_gamma(sample, alpha, beta, *, is_log=False):
    """``beta`` is the rate here (``a·log b − b·x``), while the sampler
    takes it as a scale: the reference keeps upstream's inconsistency."""
    a, b = _last(alpha), _last(beta)
    logp = (_xlogy(a - 1, sample) - sample * b + a * torch.log(b)
            - torch.lgamma(a))
    logp = torch.where(sample < 0, _neg_inf(logp), logp)
    return _pdf_out(logp, is_log)


@register_op("_random_pdf_exponential",
             aliases=("random_pdf_exponential",))
def pdf_exponential(sample, lam, *, is_log=False):
    lm = _last(lam)
    logp = torch.log(lm) - lm * sample
    logp = torch.where(sample < 0, _neg_inf(logp), logp)
    return _pdf_out(logp, is_log)


@register_op("_random_pdf_poisson", aliases=("random_pdf_poisson",))
def pdf_poisson(sample, lam, *, is_log=False):
    lm = _last(lam)
    logp = _xlogy(sample, lm) - lm - torch.lgamma(sample + 1.0)
    bad = (sample < 0) | (sample != torch.floor(sample))
    logp = torch.where(bad, _neg_inf(logp), logp)
    return _pdf_out(logp, is_log)


def _nb_logp(sample, r, p):
    return (torch.lgamma(sample + r) - torch.lgamma(sample + 1.0)
            - torch.lgamma(r) + r * torch.log(p)
            + sample * torch.log1p(-p))


@register_op("_random_pdf_negative_binomial",
             aliases=("random_pdf_negative_binomial",))
def pdf_negative_binomial(sample, k, p, *, is_log=False):
    return _pdf_out(_nb_logp(sample, _last(k), _last(p)), is_log)


@register_op("_random_pdf_generalized_negative_binomial",
             aliases=("random_pdf_generalized_negative_binomial",))
def pdf_gen_negative_binomial(sample, mu, alpha, *, is_log=False):
    a = 1.0 / _last(alpha)
    p = a / (a + _last(mu))
    return _pdf_out(_nb_logp(sample, a, p), is_log)


@register_op("_random_pdf_dirichlet", aliases=("random_pdf_dirichlet",))
def pdf_dirichlet(sample, alpha, *, is_log=False):
    logp = (torch.sum((alpha - 1.0) * torch.log(sample), dim=-1)
            + torch.lgamma(torch.sum(alpha, dim=-1))
            - torch.sum(torch.lgamma(alpha), dim=-1))
    return _pdf_out(logp, is_log)
