"""Shape manipulation, indexing, gather/scatter and the matmul family
(counterpart of ``mxnet_tpu/ops/shape_ops.py``).

Index semantics are jnp's where torch's differ: a slice may step
backwards (``x[::-1]``), ``take`` clamps its indices (or wraps them),
``pick``/``batch_take``/``Embedding`` wrap negative indices and fill a
position whose index is out of range (NaN, or the integer type's
extreme), ``gather_nd`` clamps, ``one_hot`` gives a row of
``off_value``.  No op indexes out of range on the device: an index is
made safe first and the fill put in with ``torch.where``, since a
CUDA gather out of range is a device-side assert.  The dense products go to
``torch.matmul``/``torch.tensordot``, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..dtype import normalize_dtype
from .elemwise import saturating_cast
from .registry import register_op


def _consumed(k):
    """How many input dimensions one index item consumes."""
    if k is None or k is Ellipsis:
        return 0
    if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
        return k.ndim
    return 1


def forward_key(x, key):
    """``(flips, key)``: numpy's ``x[key]`` is torch's
    ``torch.flip(x, flips)[key]`` — a slice with a negative step
    becomes a flip and a forward slice (torch refuses negative steps);
    lists and numpy arrays inside a tuple key become index tensors."""
    if not isinstance(key, tuple):
        key = (key,)
    key = tuple(torch.as_tensor(k, device=x.device)
                if isinstance(k, (list, onp.ndarray)) else k for k in key)
    explicit = sum(_consumed(k) for k in key)
    dim, flips, new = 0, [], []
    for k in key:
        if k is Ellipsis:
            dim += x.ndim - explicit
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            n = x.shape[dim]
            start, stop, step = k.indices(n)
            flips.append(dim)
            k = slice(n - 1 - start, n - 1 - stop, -step)
        new.append(k)
        dim += _consumed(k)
    return flips, tuple(new)


def index(x, key):
    """``x[key]`` with numpy's semantics (:func:`forward_key`)."""
    flips, key = forward_key(x, key)
    return (torch.flip(x, flips) if flips else x)[key]


@register_op("Reshape", aliases=("reshape",))
def reshape(x, *, shape=None, reverse=False):
    """Supports the reference's special codes 0 / -1 / -2 / -3 / -4 and
    reverse=True right-to-left matching (matrix_op.cc Reshape docs)."""
    if shape is None:
        return x
    if reverse:
        tgt = _resolve_reshape_spec(list(x.shape)[::-1],
                                    list(shape)[::-1])[::-1]
        return torch.reshape(x, tuple(tgt))
    return torch.reshape(x, tuple(_resolve_reshape_spec(list(x.shape),
                                                        list(shape))))


def _resolve_reshape_spec(src, shape):
    out = []
    i = 0  # index into src
    j = 0
    while j < len(shape):
        d = shape[j]
        if d == 0:
            out.append(src[i]); i += 1
        elif d == -1:
            out.append(-1); i += 1
        elif d == -2:
            out.extend(src[i:]); i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif d == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(d); i += 1
        j += 1
    return out  # a -1 entry is resolved by torch.reshape


@register_op("reshape_like")
def reshape_like(x, y):
    return torch.reshape(x, y.shape)


@register_op("Flatten", aliases=("flatten",))
def flatten(x):
    return torch.reshape(x, (x.shape[0], -1))


@register_op("transpose")
def transpose(x, *, axes=None):
    if axes is None or axes == ():
        axes = tuple(reversed(range(x.ndim)))
    return x.permute(*axes)


@register_op("expand_dims")
def expand_dims(x, *, axis):
    if isinstance(axis, int):
        return torch.unsqueeze(x, axis)
    ndim = x.ndim + len(axis)
    for a in sorted(a % ndim for a in axis):
        x = torch.unsqueeze(x, a)
    return x


@register_op("squeeze")
def squeeze(x, *, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, axis)


@register_op("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, *, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register_op("flip", aliases=("reverse",))
def flip(x, *, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@register_op("tile")
def tile(x, *, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register_op("repeat")
def repeat(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of an edge- or reflect-padded axis of length n
    (numpy's ``edge`` and ``reflect`` modes)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(j >= n, period - j, j)


@register_op("Pad", aliases=("pad",))
def pad(x, *, mode="constant", pad_width=None, constant_value=0.0):
    """Reference: src/operator/pad.cc — pad_width is 2*ndim flat list."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(x.ndim)]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    mode = {"edge": "edge", "reflect": "reflect"}[mode]
    for d, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


@register_op("broadcast_to")
def broadcast_to(x, *, shape):
    shape = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, *, axis=None, size=None):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(x.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


@register_op("broadcast_like")
def broadcast_like(x, y, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(x, y.shape)
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = y.shape[ra]
    return torch.broadcast_to(x, tuple(tgt))


@register_op("slice", aliases=("crop",))
def slice_op(x, *, begin, end, step=None):
    step = step or [None] * len(begin)
    return index(x, tuple(slice(b, e, s)
                          for b, e, s in zip(begin, end, step)))


@register_op("slice_axis")
def slice_axis(x, *, axis, begin, end):
    idx = [slice(None)] * x.ndim
    if end is not None and end < 0:
        end = x.shape[axis] + end
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register_op("slice_like")
def slice_like(x, y, *, axes=()):
    axes = axes or tuple(range(min(x.ndim, y.ndim)))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


def _along(x, idx, axis):
    """``x`` gathered along ``axis`` at ``idx`` (jnp's
    ``take``: output shape ``x.shape[:axis] + idx.shape + ...``)."""
    axis = axis % x.ndim
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _wrap_negative(idx, n):
    return torch.where(idx < 0, idx + n, idx)


@register_op("take")
def take(x, indices, *, axis=0, mode="clip"):
    n = x.shape[axis % x.ndim]
    idx = indices.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    return _along(x, idx.clamp(0, n - 1), axis)


def _fill_value(dtype):
    """What jnp's gather puts at an index out of range (its ``"fill"``
    mode): NaN for a float, the most negative value of a signed integer
    type, the largest of an unsigned one, True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _fill_index(indices, n):
    """``(safe, valid)`` for jnp's fill mode along an extent ``n``: an
    index in [-n, n) is valid (a negative one wraps once); ``safe`` is
    the wrapped index clamped into range, so a gather never leaves the
    array."""
    idx = indices.to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    return _wrap_negative(idx, n).clamp(0, max(n - 1, 0)), valid


def _filled(r, valid, dtype):
    return torch.where(valid, r, _fill_value(dtype))


@register_op("batch_take")
def batch_take(x, indices):
    idx, valid = _fill_index(indices, x.shape[1])
    return _filled(torch.gather(x, 1, idx[:, None])[:, 0], valid, x.dtype)


@register_op("pick")
def pick(x, indices, *, axis=-1, keepdims=False, mode="clip"):
    """Reference ``pick`` (``mxnet_tpu/ops/shape_ops.py:197``): jnp's
    ``take_along_axis``, so an index out of range gives the fill value
    whatever ``mode`` says."""
    ax = axis % x.ndim
    idx, valid = _fill_index(indices, x.shape[ax])
    r = _filled(torch.gather(x, ax, torch.unsqueeze(idx, ax)),
                torch.unsqueeze(valid, ax), x.dtype)
    if not keepdims:
        r = torch.squeeze(r, ax)
    return r


@register_op("gather_nd")
def gather_nd(data, indices):
    """Reference ``gather_nd``: ``data[tuple(indices)]`` as jnp indexes
    it, a negative index wrapped once, then clamped into range; the
    gradient, as jnp's scatter, drops the positions whose index was out
    of range."""
    idx = indices.to(torch.int64)
    shape = torch.tensor(data.shape[:idx.shape[0]], dtype=torch.int64,
                         device=idx.device).reshape(
                             (-1,) + (1,) * (idx.dim() - 1))
    valid = ((idx >= -shape) & (idx < shape)).all(dim=0)
    idx = torch.minimum(_wrap_negative(idx, shape).clamp_min(0), shape - 1)
    out = data[tuple(idx)]
    if not out.requires_grad:
        return out
    valid = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return torch.where(valid, out, out.detach())


@register_op("scatter_nd")
def scatter_nd(data, indices, *, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return torch.index_put(out, tuple(indices.to(torch.int64)), data,
                           accumulate=True)


@register_op("one_hot", differentiable=False)
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    idx = indices.to(torch.int32)
    oh = (idx[..., None] == torch.arange(depth, dtype=torch.int32,
                                         device=idx.device)).to(torch.float32)
    return saturating_cast(oh * (on_value - off_value) + off_value,
                           normalize_dtype(dtype))


@register_op("Embedding")
def embedding(data, weight, *, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Reference: src/operator/tensor/indexing_op.cc Embedding, as the
    reference takes it (``jnp.take``): a negative index wraps once, a row
    out of range is the fill value."""
    idx, valid = _fill_index(data, weight.shape[0])
    return _filled(weight[idx], valid.unsqueeze(-1), weight.dtype)


@register_op("Concat", aliases=("concat",))
def concat_op(*args, dim=1, num_args=None):
    return torch.cat(args, dim=dim)


@register_op("rnn_param_concat")
def rnn_param_concat(*args, dim=0, num_args=None):
    return torch.cat([a.reshape(-1) for a in args], dim=0)


@register_op("stack")
def stack_op(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


def _split_count(p):
    return int(p.get("num_outputs", 1))


@register_op("SliceChannel", aliases=("split",), num_outputs=_split_count)
def slice_channel(x, *, num_outputs, axis=1, squeeze_axis=False):
    n = x.shape[axis]
    if n % num_outputs:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {n} by {num_outputs}")
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register_op("split_v2", num_outputs=lambda p: p["_num"])
def split_v2(x, *, indices, axis=0, squeeze_axis=False, _num=None):
    parts = torch.tensor_split(x, list(indices), dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


@register_op("depth_to_space")
def depth_to_space(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w)
    y = y.permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register_op("diag")
def diag(x, *, k=0, axis1=0, axis2=1):
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, k, axis1, axis2)


@register_op("shape_array", differentiable=False)
def shape_array(x):
    # the reference asks for int64 and gets int32 (JAX without x64)
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register_op("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


# ------------------------------------------------------------- matmul
def _reverse_axes(x):
    return x.permute(*reversed(range(x.ndim)))


@register_op("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False,
        forward_stype=None):
    """Reference semantics (tensor/dot-inl.h): contract last axis of lhs
    with first axis of rhs; transpose flags reverse all axes first."""
    if transpose_a:
        lhs = _reverse_axes(lhs)
    if transpose_b:
        rhs = _reverse_axes(rhs)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=1)


@register_op("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False,
              forward_stype=None):
    if transpose_a:
        lhs = torch.swapaxes(lhs, -1, -2)
    if transpose_b:
        rhs = torch.swapaxes(rhs, -1, -2)
    return torch.matmul(lhs, rhs)


@register_op("_npi_matmul", aliases=("matmul",))
def matmul(a, b):
    return torch.matmul(a, b)


@register_op("khatri_rao")
def khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out
