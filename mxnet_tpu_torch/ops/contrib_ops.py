"""Contrib operators: AMP's finiteness checks, boolean masking, FFT,
index ops, the gradient multiplier and the Hawkes log-likelihood
(counterpart of ``mxnet_tpu/ops/contrib_ops.py``).

``boolean_mask`` keeps the reference's fixed-size contract: the
selected rows first, in order, then zero rows, so its shape is the
input's and no value is read on the host.
"""
from __future__ import annotations

import torch

from .registry import register_op
from .shape_ops import _fill_index, _filled
from .sort_ops import stable_argsort

__all__ = ["all_finite", "multi_all_finite", "boolean_mask", "index_copy",
           "index_array", "fft", "ifft", "allclose", "gradientmultiplier",
           "hawkesll"]


def _flag(ok):
    return ok.to(torch.float32).reshape(1)


@register_op("all_finite", differentiable=False)
def all_finite(data, *, init_output=True):
    """(1,) 1.0 when every element is finite, else 0.0 (feeds AMP's loss
    scale)."""
    return _flag(torch.isfinite(data).all())


@register_op("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    ok = torch.ones((), dtype=torch.bool,
                    device=arrays[0].device if arrays else None)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return _flag(ok)


@register_op("_contrib_boolean_mask", aliases=("boolean_mask",))
def boolean_mask(data, index, *, axis=0):
    """The rows of ``data`` along ``axis`` whose ``index`` is nonzero,
    compacted to the front of an output of the input's size; the tail
    is zero.  ``index.sum()`` rows are valid."""
    idx = index.to(torch.bool)
    n = data.shape[axis]
    order = stable_argsort(~idx, 0)  # selected first, in order
    gathered = torch.index_select(data, axis, order)
    keep = torch.arange(n, device=data.device) < idx.sum()
    shape = [1] * data.dim()
    shape[axis] = n
    return gathered * keep.reshape(shape).to(data.dtype)


@register_op("_contrib_index_copy", differentiable=False)
def index_copy(old, idx, new_tensor):
    """``old`` with rows ``idx`` replaced by ``new_tensor`` (jnp's
    ``.at[idx].set``: a negative index wraps once, one out of range is
    dropped)."""
    n = old.shape[0]
    i = idx.to(torch.int32).to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    slot = torch.where((i >= 0) & (i < n), i, n)  # a spare row, dropped
    out = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
    out[slot] = new_tensor.to(old.dtype)
    return out[:n]


@register_op("_contrib_index_array", differentiable=False)
def index_array(data, *, axes=None):
    """Each element's coordinates along ``axes`` (all by default),
    int64 as upstream's (JAX without x64 narrows the reference's to
    int32)."""
    shape = data.shape
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1).to(torch.int64)


@register_op("_contrib_fft", differentiable=False)
def fft(data, *, compute_size=128):
    """The complex FFT of the last axis, packed as interleaved (real,
    imag) pairs, as cuFFT gives it."""
    out = torch.fft.fft(data.to(torch.float32))
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        *data.shape[:-1], 2 * data.shape[-1])


@register_op("_contrib_ifft", differentiable=False)
def ifft(data, *, compute_size=128):
    """The inverse of :func:`fft`'s packing, unnormalized (times n)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(*data.shape[:-1], n, 2).to(torch.float32)
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp).real.to(torch.float32) * n


@register_op("_contrib_allclose", differentiable=False)
def allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    """(1,) 1.0 when ``|a - b| <= atol + rtol |b|`` everywhere."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return _flag(torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                               equal_nan=equal_nan).all())


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scalar, None


@register_op("_contrib_gradientmultiplier")
def gradientmultiplier(data, *, scalar=1.0):
    """The identity forward; the gradient times ``scalar``."""
    return _GradientMultiplier.apply(data, scalar)


@register_op("_contrib_hawkesll", num_outputs=2)
def hawkesll(mu, alpha, beta, state, lags, marks, valid_length, max_time):
    """The log-likelihood of a marked self-exciting Hawkes process
    (hawkes_ll-inl.h:119-185), a loop over the T events of every
    sample with the decayed state carried: per valid event with
    inter-arrival gap d, intensity mu_k + alpha_k beta_k state_k
    exp(-beta_k d) and compensator sum_k [mu_k d + alpha_k state_k
    (1 - exp(-beta_k d))]; the remaining compensator runs from the last
    event to ``max_time``.  Returns (ll per sample, state at max_time)."""
    mu = mu.to(torch.float32)
    k = mu.shape[-1]
    t = lags.shape[1]
    dev = mu.device
    marks_i = marks.to(torch.int32).to(torch.int64)
    valid = torch.arange(t, device=dev)[None, :] < \
        valid_length.reshape(-1, 1)
    lags = lags.to(torch.float32)
    kk = torch.arange(k, device=dev)
    st = state.to(torch.float32)
    ll = torch.zeros(lags.shape[0], dtype=torch.float32, device=dev)
    elapsed = torch.zeros_like(ll)
    for j in range(t):
        is_valid, mark = valid[:, j], marks_i[:, j]
        d = (lags[:, j] * is_valid).reshape(-1, 1)
        ed = torch.exp(-beta * d)
        decayed = st * ed
        lam = mu + alpha * beta * decayed
        safe, ok = _fill_index(mark.reshape(-1, 1), k)  # jnp's fill mode
        lam_m = _filled(torch.gather(lam, 1, safe), ok, lam.dtype)[:, 0]
        comp = (mu * d + alpha * st * (1 - ed)).sum(-1)
        ll = ll + torch.where(is_valid, torch.log(lam_m + 1e-30) - comp,
                              0.0)
        add = (kk[None, :] == mark[:, None]).to(mu.dtype) * \
            is_valid[:, None].to(mu.dtype)
        st = decayed + add
        elapsed = elapsed + d[:, 0]
    d_rem = torch.clamp(max_time.reshape(-1, 1) - elapsed[:, None], min=0.0)
    ed_rem = torch.exp(-beta * d_rem)
    rem_comp = (mu * d_rem + alpha * st * (1 - ed_rem)).sum(-1)
    return ll - rem_comp, st * ed_rem
