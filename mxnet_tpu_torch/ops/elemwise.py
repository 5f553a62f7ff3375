"""Elementwise unary / binary / scalar operator families (counterpart
of ``mxnet_tpu/ops/elemwise.py``).

The formulas are the reference's, not torch's nearest function
(``gamma`` is ``exp(lgamma(x))``, ``rcbrt`` is ``1/cbrt``, ``fix`` is
``trunc``), and so are the result dtypes: a float function of an
integer array gives float32, a ``_scalar`` op keeps a float array's
dtype, integer division truncates back to the integer type.
"""
from __future__ import annotations

import torch

from ..dtype import normalize_dtype
from .registry import register_op

_f32 = torch.float32


def _inexact(x):
    """Integer and bool arrays promote to float32, as jnp's float
    functions promote them."""
    return x if x.is_floating_point() or x.is_complex() else x.to(_f32)


def _is_int(dtype):
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def saturating_cast(x, dtype):
    """``x.astype(dtype)`` as XLA converts: a float that an integer
    type cannot hold saturates to its bounds and NaN becomes 0 (a plain
    C conversion, torch's, is undefined there)."""
    if not (x.is_floating_point() and _is_int(dtype)):
        return x.to(dtype)
    info = torch.iinfo(dtype)
    big, small = x >= info.max, x <= info.min
    out = torch.where(big | small | torch.isnan(x),
                      torch.zeros((), dtype=x.dtype), x).to(dtype)
    out = torch.where(big, torch.tensor(info.max, dtype=dtype), out)
    return torch.where(small, torch.tensor(info.min, dtype=dtype), out)


def _unbroadcast(g, shape):
    """``g`` summed down to ``shape`` (the broadcast's transpose)."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _Cbrt(torch.autograd.Function):
    """``cbrt`` keeping the zero's sign, with jnp's gradient
    ``1 / (3 cbrt(x)²)`` (+inf at ±0, where a product of torch ops
    gives NaN)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.copysign(torch.abs(x).pow(1.0 / 3.0), x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (3.0 * y * y)


class _Rsqrt(torch.autograd.Function):
    """``rsqrt`` with jnp's gradient ``-0.5 · rsqrt(x) / x`` (−inf at −0,
    where torch's ``-0.5 · y³`` gives +inf)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.rsqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * y / x)


class _Lgamma(torch.autograd.Function):
    """``lgamma`` with jnp's gradient: digamma, NaN at ±0 (torch's
    digamma is ∓inf there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = torch.digamma(x)
        return g * torch.where(x == 0, torch.full_like(d, float("nan")), d)


class _Pow(torch.autograd.Function):
    """``x ** y`` of two float tensors with jnp's gradients: ``y ·
    x^(y−1)`` in the base unmasked (NaN at (0, 0), where torch gives 0),
    ``log(x) · x^y`` in the exponent with ``log`` read at 1 where x is
    0."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.pow(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = _unbroadcast(g * y * torch.pow(x, y - 1), x.shape)
        if ctx.needs_input_grad[1]:
            logx = torch.log(torch.where(x == 0, torch.ones_like(x), x))
            gy = _unbroadcast(g * logx * out, y.shape)
        return gx, gy


def _cbrt(x):
    return _Cbrt.apply(_inexact(x))


def _abs(x):
    """jnp's ``abs``: +0 at ±0, gradient 1 there (``x ≥ 0``); bool
    stays bool."""
    if x.dtype == torch.bool:
        return x
    if not x.is_floating_point():
        return torch.abs(x)
    return torch.where(x >= 0, x, -x) + 0.0


def _sign(x):
    """jnp's ``sign``: keeps −0 and NaN (torch gives +0 for both)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x.detach(), torch.sign(x))


def _relu(x):
    """jnp's ``relu``: +0 at −0; bool becomes int32."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    r = torch.relu(x)
    return r + 0.0 if r.is_floating_point() else r


def _lgamma(x):
    return _Lgamma.apply(_inexact(x))


def _square(x):
    return torch.square(x.to(torch.int32) if x.dtype == torch.bool else x)


def _bool_inexact(x):
    """A bool array as float32, as jnp's arithmetic promotes it (an
    integer array keeps its type)."""
    return x.to(_f32) if x.dtype == torch.bool else x


def _on_inexact(f):
    return lambda x: f(_inexact(x))


def _keep_int(f):
    """Rounding functions: the identity on integer arrays."""
    return lambda x: f(x) if x.is_floating_point() else x


# --------------------------------------------------------------- unary
_UNARY = {
    "abs": _abs,
    "sign": _sign,
    "rint": _on_inexact(torch.round),
    "round": _keep_int(torch.round),
    "ceil": _keep_int(torch.ceil),
    "floor": _keep_int(torch.floor),
    "trunc": _keep_int(torch.trunc),
    "fix": _keep_int(torch.trunc),
    "square": _square,
    "sqrt": _on_inexact(torch.sqrt),
    "rsqrt": _on_inexact(_Rsqrt.apply),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": _on_inexact(torch.exp),
    "log": _on_inexact(torch.log),
    "log10": _on_inexact(torch.log10),
    "log2": _on_inexact(torch.log2),
    "log1p": _on_inexact(torch.log1p),
    "expm1": _on_inexact(torch.expm1),
    "sin": _on_inexact(torch.sin),
    "cos": _on_inexact(torch.cos),
    "tan": _on_inexact(torch.tan),
    "arcsin": _on_inexact(torch.asin),
    "arccos": _on_inexact(torch.acos),
    "arctan": _on_inexact(torch.atan),
    "sinh": _on_inexact(torch.sinh),
    "cosh": _on_inexact(torch.cosh),
    "tanh": _on_inexact(torch.tanh),
    "arcsinh": _on_inexact(torch.asinh),
    "arccosh": _on_inexact(torch.acosh),
    "arctanh": _on_inexact(torch.atanh),
    "degrees": _on_inexact(torch.rad2deg),
    "radians": _on_inexact(torch.deg2rad),
    "negative": torch.neg,
    "reciprocal": _on_inexact(torch.reciprocal),
    "erf": _on_inexact(torch.erf),
    "erfinv": _on_inexact(torch.erfinv),
    "gamma": lambda x: torch.exp(_lgamma(x)),
    "gammaln": _lgamma,
    "sigmoid": _on_inexact(torch.sigmoid),
    "softsign": lambda x: _bool_inexact(x) / (torch.abs(_bool_inexact(x))
                                              + 1),
    "relu": _relu,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register_op(_name, aliases=(f"_np_{_name}",))(
        (lambda f: lambda x: f(x))(_f)
    )


@register_op("_copy", aliases=("identity",))
def _copy(x):
    return x.clone()


@register_op("BlockGrad", aliases=("stop_gradient",))
def block_grad(x):
    """Reference: src/operator/tensor/elemwise_unary_op_basic.cc BlockGrad."""
    return x.detach()


@register_op("make_loss")
def make_loss(x):
    """Reference make_loss: gradient of ones (src/operator/make_loss.cc)."""
    return x


@register_op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


def _weak_result(x, *scalars):
    """The dtype jnp gives ``x`` combined with Python scalars: a float
    array keeps its dtype; an integer or bool array becomes float32
    beside a float scalar, and int32 (from bool) beside an int one."""
    if x.is_floating_point():
        return x.dtype
    if any(isinstance(s, float) for s in scalars):
        return _f32
    if x.dtype == torch.bool and any(isinstance(s, int)
                                     and not isinstance(s, bool)
                                     for s in scalars):
        return torch.int32
    return x.dtype


@register_op("clip")
def clip(x, *, a_min, a_max):
    return torch.clamp(x.to(_weak_result(x, a_min, a_max)), a_min, a_max)


@register_op("smooth_l1")
def smooth_l1(x, *, scalar=1.0):
    """Reference: src/operator/tensor/elemwise_binary_scalar_op_extended.cc."""
    s2 = scalar * scalar
    x = _bool_inexact(x)
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


# --------------------------------------------------------------- binary
def _true_div(a, b):
    rt = torch.promote_types(a.dtype, b.dtype)
    if _is_int(rt):
        return saturating_cast(torch.true_divide(a.to(_f32), b.to(_f32)),
                               rt)
    return torch.true_divide(a, b)


def _hypot(a, b):
    rt = torch.promote_types(a.dtype, b.dtype)
    rt = rt if rt.is_floating_point else _f32
    return torch.hypot(a.to(rt), b.to(rt))


def _logical(f):
    return lambda a, b: f(a != 0, b != 0).to(a.dtype)


def _bool_as(a, b):
    """A bool operand beside a non-bool one takes the other's dtype, as
    jnp promotes it (torch refuses ``-`` on bool)."""
    if a.dtype == torch.bool and b.dtype != torch.bool:
        a = a.to(b.dtype)
    if b.dtype == torch.bool and a.dtype != torch.bool:
        b = b.to(a.dtype)
    return a, b


def _sub(a, b):
    return torch.sub(*_bool_as(a, b))


def _both_bool_int32(a, b):
    """jnp computes ``power``/``fmod`` of two bools in int32."""
    if a.dtype == torch.bool and b.dtype == torch.bool:
        return a.to(torch.int32), b.to(torch.int32)
    return a, b


def _mod(a, b):
    """``fmod``; an integer remainder by 0 is 0, as jnp's (torch raises
    on the CPU)."""
    a, b = _both_bool_int32(a, b)
    rt = torch.promote_types(a.dtype, b.dtype)
    if not _is_int(rt):
        return torch.fmod(a, b)
    zero = b == 0
    r = torch.fmod(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


def _power(a, b):
    a, b = _both_bool_int32(a, b)
    if a.is_floating_point() and b.is_floating_point() and a.dtype == b.dtype:
        return _Pow.apply(a, b)
    return torch.pow(a, b)


_BINARY = {
    "add": torch.add,
    "sub": _sub,
    "mul": torch.mul,
    "div": _true_div,
    "mod": _mod,
    "power": _power,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": _hypot,
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
}

_BINARY_ALIASES = {
    "add": ("elemwise_add", "_plus", "_add"),
    "sub": ("elemwise_sub", "_minus", "_sub"),
    "mul": ("elemwise_mul", "_mul"),
    "div": ("elemwise_div", "_div"),
    "mod": ("_mod",),
    "power": ("_power",),
    "maximum": ("_maximum",),
    "minimum": ("_minimum",),
    "hypot": ("_hypot",),
    "logical_and": ("_logical_and",),
    "logical_or": ("_logical_or",),
    "logical_xor": ("_logical_xor",),
}

for _name, _f in _BINARY.items():
    register_op(f"broadcast_{_name}", aliases=_BINARY_ALIASES[_name])(
        (lambda f: lambda a, b: f(a, b))(_f)
    )

_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}

for _name, _f in _CMP.items():
    register_op(f"broadcast_{_name}", aliases=(f"_{_name}",),
                differentiable=False)(
        (lambda f: lambda a, b: f(a, b).to(_f32))(_f)
    )


@register_op("_hypot_scalar")
def _hypot_scalar(x, *, scalar):
    return _hypot(x, torch.tensor(scalar, dtype=_weak_result(x, scalar)))


# --------------------------------------------------------------- scalar
def _scalar_tensor(x, s):
    """The reference's ``jnp.asarray(scalar, dtype)``: the array's dtype
    for a float array, else the scalar's promotion with it.  A 0-d CPU
    tensor, which torch takes beside a tensor on any device."""
    dtype = x.dtype if x.is_floating_point() else _weak_result(x, s)
    return torch.tensor(s, dtype=dtype)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: torch.true_divide(x, s),
    "_rdiv_scalar": lambda x, s: torch.true_divide(s, x),
    "_mod_scalar": lambda x, s: torch.fmod(x, s),
    "_rmod_scalar": lambda x, s: torch.fmod(s.to(x.device), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s.to(x.device), x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, s),
    "_minimum_scalar": lambda x, s: torch.minimum(x, s),
}

for _name, _f in _SCALAR.items():
    register_op(_name)(
        (lambda f: lambda x, *, scalar: f(x, _scalar_tensor(x, scalar)))(_f)
    )

_SCALAR_CMP = {
    "_equal_scalar": torch.eq,
    "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt,
    "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt,
    "_lesser_equal_scalar": torch.le,
}

for _name, _f in _SCALAR_CMP.items():
    register_op(_name, differentiable=False)(
        (lambda f: lambda x, *, scalar: f(x, scalar).to(_f32))(_f)
    )


@register_op("add_n", aliases=("ElementWiseSum",))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register_op("Cast", aliases=("cast",))
def cast(x, *, dtype):
    return saturating_cast(x, normalize_dtype(dtype))


@register_op("amp_cast")
def amp_cast(x, *, dtype):
    return saturating_cast(x, normalize_dtype(dtype))


@register_op("amp_multicast", num_outputs=lambda p: p.get("num_outputs", 1))
def amp_multicast(*args, num_outputs):
    """Cast all inputs to the widest input dtype (reference
    src/operator/tensor/amp_cast.cc)."""
    widest = args[0].dtype
    for a in args[1:]:
        widest = torch.promote_types(widest, a.dtype)
    return tuple(a.to(widest) for a in args)


@register_op("where")
def where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register_op("_getitem")
def _getitem(x, *, key):
    from .shape_ops import index

    return index(x, key)
