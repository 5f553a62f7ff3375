"""int8 and fp8 quantization operators (counterpart of
``mxnet_tpu/ops/quantization_ops.py``).

The reference computes its int8 and fp8 products outside any Pallas
kernel (``lax.dot_general`` / ``lax.conv_general_dilated`` with an int32
or f32 ``preferred_element_type``), so here too they are library GEMMs:

- int8 x int8 -> int32 runs ``torch._int_mm`` (cuBLASLt IMMA) on a CUDA
  tensor; ``m`` is padded past 16 rows and ``k``, ``n`` to multiples of
  8 with zeros, which is exact in int32, and the padding is sliced off;
- e4m3 x e4m3 -> f32 runs ``torch._scaled_mm`` with the descale
  ``(d_amax/448)*(w_amax/448)`` as its scale, every dimension padded
  to a multiple of 16;
- a convolution is ``[M, K]`` patches times ``[K, N]`` weights: the
  patches are ``Tensor.unfold`` views gathered by one copy (it works
  for any dtype; fp8 is moved as its bytes);
- on the host the products accumulate exactly in int64 (wrapped to
  int32, as an int32 accumulator wraps) or in float32.

A CUDA tensor runs int8 (or fp8) or raises: nothing falls back to a
float product.  Quantizing multiplies by ``127/amax`` (or
``448/amax``), rounds half to even and clips, in the reference's
order, so the int8 codes are the reference's bit for bit.  Nothing here
reads a value on the host, so the ops run inside a captured CUDA graph.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .conv import pooling as _pooling
from .registry import register_op

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "quantized_fully_connected", "quantized_conv", "quantize_fp8",
           "fp8_fully_connected", "fp8_conv", "quantized_pooling",
           "quantized_flatten", "counts", "reset_counts"]

_INT8_RANGE = 127.0
_INT32_RANGE = float(2 ** 31 - 1)  # 2147483648.0 in float32
_FP8_MAX = 448.0  # e4m3fn's largest finite value (the format has no inf)
_F32 = torch.float32

#: launches of the library GEMMs by the ops on a CUDA tensor
_COUNTS = {"int_mm": 0, "scaled_mm": 0}


def counts():
    """``{"int_mm": n, "scaled_mm": n}``: library GEMM launches since the
    last :func:`reset_counts`."""
    return dict(_COUNTS)


def reset_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def _minmax_scale(mn, mx):
    """``(127/amax, amax)`` with ``amax = max(|mn|, |mx|)``; the factor
    is 1.0 where amax is 0."""
    amax = torch.maximum(mn.abs(), mx.abs())
    return (torch.where(amax > 0, _INT8_RANGE / amax,
                        torch.ones_like(amax)), amax)


def _f32(x):
    """``x`` as float32 where jnp computes in float32 (a half type meets
    a float32 scale; an integer one is promoted)."""
    return x if x.dtype in (_F32, torch.float64) else x.to(_F32)


def _const(value, like):
    """A float32 scalar tensor of ``value`` on ``like``'s device (a fill,
    so it is captured in a CUDA graph)."""
    return torch.full((), value, dtype=_F32, device=like.device)


def _amax(mn, mx):
    return torch.maximum(mn.abs(), mx.abs()).reshape(())


def _calibrated(min_calib_range, max_calib_range):
    return min_calib_range is not None and max_calib_range is not None


def _host_amax(min_calib_range, max_calib_range):
    """``max(|f32(min)|, |f32(max)|)`` of a calibrated range, as a numpy
    float32 (the device computes the same value)."""
    return max(abs(onp.float32(min_calib_range)),
               abs(onp.float32(max_calib_range)))


def _to_int8(real, factor):
    """``clip(round(real * factor), -127, 127)`` as int8; ``factor`` a
    float32 tensor or a float32 value (a calibrated scale, computed on
    the host in float32: one multiply fewer launches, the same bits)."""
    if not isinstance(factor, torch.Tensor):
        factor = float(factor)
    return torch.clamp(torch.round(real * factor), -127, 127).to(torch.int8)


def _saturate_int32(v):
    """float32 -> int32 as XLA converts it: out-of-range values saturate
    and NaN becomes 0 (all on the device: no host scalar, so a CUDA
    graph captures it)."""
    v = torch.nan_to_num(v, nan=0.0)
    big = v >= 2147483648.0
    out = v.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return out.masked_fill(big, 2 ** 31 - 1)


@register_op("_contrib_quantize", num_outputs=3, differentiable=False)
def quantize(data, min_range, max_range, *, out_type="uint8"):
    """float -> quantized with the given range (reference
    ``quantize.cc``): uint8 affine ``[min, max] -> [0, 255]``, int8
    symmetric."""
    mn = min_range.reshape(()).to(_F32)
    mx = max_range.reshape(()).to(_F32)
    data = _f32(data)
    if out_type == "uint8":
        scale = 255.0 / torch.clamp(mx - mn, min=1e-12)
        q = torch.clamp(torch.round((data - mn) * scale), 0, 255).to(
            torch.uint8)
    else:
        scale, _ = _minmax_scale(mn, mx)
        q = _to_int8(data, scale)
    return q, mn.reshape(1), mx.reshape(1)


@register_op("_contrib_quantize_v2", num_outputs=3, differentiable=False)
def quantize_v2(data, *, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """Symmetric int8 with a calibrated range or the data's own
    (reference ``quantize_v2.cc``); the range out is ``(-amax, amax)``."""
    if _calibrated(min_calib_range, max_calib_range):
        amax = _host_amax(min_calib_range, max_calib_range)
        scale = onp.float32(_INT8_RANGE) / amax if amax > 0 \
            else onp.float32(1.0)
        return (_to_int8(_f32(data), scale), _const(-amax, data).reshape(1),
                _const(amax, data).reshape(1))
    scale, amax = _minmax_scale(data.min().to(_F32), data.max().to(_F32))
    return _to_int8(_f32(data), scale), (-amax).reshape(1), amax.reshape(1)


@register_op("_contrib_dequantize", differentiable=False)
def dequantize(data, min_range, max_range, *, out_type="float32"):
    """Reference ``dequantize.cc``: uint8 affine; int8 maps to +-127 and
    an int32 accumulator to +-(2^31-1)."""
    mn = min_range.reshape(()).to(_F32)
    mx = max_range.reshape(()).to(_F32)
    if data.dtype == torch.uint8:
        scale = torch.clamp(mx - mn, min=1e-12) / 255.0
        return data.to(_F32) * scale + mn
    denom = _INT8_RANGE if data.dtype == torch.int8 else _INT32_RANGE
    # int times a float32 scalar tensor: one pass, the product of the
    # code's float32 value and the scale, as data.astype(f32) * scale
    return torch.mul(data, torch.maximum(mn.abs(), mx.abs()) / denom)


@register_op("_contrib_requantize", num_outputs=3, differentiable=False)
def requantize(data, min_range, max_range, *, out_type="int8",
               min_calib_range=None, max_calib_range=None):
    """int32 accumulators back to int8 with a calibrated output range,
    or the data's own (reference ``requantize.cc``)."""
    real = torch.mul(data, _amax(min_range.to(_F32), max_range.to(_F32))
                     / _INT32_RANGE)
    if _calibrated(min_calib_range, max_calib_range):
        omax = onp.float32(max(abs(min_calib_range), abs(max_calib_range)))
        return (_to_int8(real, onp.float32(_INT8_RANGE) / omax),
                _const(-omax, data).reshape(1), _const(omax, data).reshape(1))
    omax = torch.clamp(real.abs().max(), min=1e-12)
    return (_to_int8(real, _INT8_RANGE / omax), (-omax).reshape(1),
            omax.reshape(1))


# ------------------------------------------------------------- products
def _pad2(t, rows, cols):
    """``t`` ([r, c]) zero-padded to ``[rows, cols]`` (itself when it
    fits)."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:r, :c] = t
    return out


def _ceil(n, m):
    return -(-n // m) * m


def _int8_gemm(a, w):
    """``a @ w.T`` of int8 ``a`` ([m, k]) and ``w`` ([n, k]), exact in
    int32."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda:
        mp, kp, np_ = max(m, 17), _ceil(k, 8), _ceil(n, 8)
        a_p = _pad2(a.contiguous(), mp, kp)
        w_p = _pad2(w.contiguous(), np_, kp)
        _COUNTS["int_mm"] += 1
        acc = torch._int_mm(a_p, w_p.t())
        return acc[:m, :n]
    return (a.to(torch.int64) @ w.to(torch.int64).t()).to(torch.int32)


def _fp8_gemm(a, w, scale):
    """``(a @ w.T) * scale`` of e4m3 ``a`` ([m, k]) and ``w`` ([n, k]),
    accumulated in float32; ``scale`` is a float32 scalar tensor."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda:
        mp, kp, np_ = _ceil(m, 16), _ceil(k, 16), _ceil(n, 16)
        a_p = _pad2(a.contiguous().view(torch.uint8), mp, kp).view(a.dtype)
        w_p = _pad2(w.contiguous().view(torch.uint8), np_, kp).view(w.dtype)
        _COUNTS["scaled_mm"] += 1
        out = torch._scaled_mm(a_p, w_p.t(), scale_a=scale.reshape(()),
                               scale_b=torch.ones((), dtype=_F32,
                                                  device=a.device),
                               out_dtype=_F32)
        return out[:m, :n]
    return (a.to(_F32) @ w.to(_F32).t()) * scale


def _patches(x, kernel, stride, pad, dilate):
    """The im2col matrix ``[N*OH*OW, C*kh*kw]`` of channel-first ``x``
    (1-D or 2-D spatial), columns in the weight's (C, kernel) order, and
    the output's spatial shape.  Any dtype: views, one copy."""
    nd = len(kernel)
    raw = x.view(torch.uint8) if x.dtype.is_floating_point \
        and x.element_size() == 1 else x
    if any(pad):
        widths = []
        for p in reversed(pad):
            widths += [p, p]
        raw = torch.nn.functional.pad(raw, widths)
    win = raw
    for i in range(nd):
        span = dilate[i] * (kernel[i] - 1) + 1
        win = win.unfold(2 + i, span, stride[i])
    if any(d > 1 for d in dilate):
        idx = (slice(None),) * (2 + nd) + tuple(
            slice(None, None, d) for d in dilate)
        win = win[idx]
    n, c = x.shape[:2]
    out_sp = tuple(win.shape[2:2 + nd])
    # [N, C, *out, *k] -> [N, *out, C, *k]
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) + tuple(
        range(2 + nd, 2 + 2 * nd))
    cols = win.permute(perm).reshape(n * math.prod(out_sp),
                                     c * math.prod(kernel))
    if raw is not x:
        cols = cols.view(x.dtype)
    return cols, out_sp


def _conv_product(data, weight, gemm, *, kernel, stride, pad, dilate,
                  num_group):
    """A grouped convolution as patch products: ``gemm(cols, w2d)`` per
    group, back to channel-first [N, O, *out]."""
    nd = len(kernel)
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    n, c = data.shape[:2]
    o = weight.shape[0]
    cg, og = c // num_group, o // num_group
    outs = []
    for g in range(num_group):
        xg = data if num_group == 1 else data[:, g * cg:(g + 1) * cg]
        wg = weight if num_group == 1 else weight[g * og:(g + 1) * og]
        cols, out_sp = _patches(xg, kernel, stride, pad, dilate)
        outs.append(gemm(cols, wg.reshape(og, -1)))
    acc = outs[0] if num_group == 1 else torch.cat(outs, dim=1)
    # [N*out, O] -> [N, O, *out] (a channel-last view)
    return acc.reshape((n,) + out_sp + (o,)).permute(
        (0, nd + 1) + tuple(range(1, nd + 1)))


def _out_scale(data_min, data_max, weight_min, weight_max):
    return (_amax(data_min, data_max) / _INT8_RANGE) \
        * (_amax(weight_min, weight_max) / _INT8_RANGE)


def _bias_int32(bias, bias_min, bias_max, out_scale):
    b_real = bias.to(_F32) * (_amax(bias_min, bias_max) / _INT8_RANGE)
    return _saturate_int32(torch.round(
        b_real / torch.clamp(out_scale, min=1e-30)))


def _q_triple(acc, out_scale):
    omax = out_scale * _INT32_RANGE
    return acc, (-omax).reshape(1), omax.reshape(1)


@register_op("_contrib_quantized_fully_connected", num_outputs=3,
             differentiable=False)
def quantized_fully_connected(data, weight, bias, data_min, data_max,
                              weight_min, weight_max, bias_min, bias_max,
                              *, num_hidden, no_bias=False, flatten=True):
    """int8 x int8 -> int32 FC (reference
    ``quantized_fully_connected.cc``); the range out is the int32
    accumulator's."""
    d = data.reshape(data.shape[0], -1) if flatten else data
    lead = d.shape[:-1]
    acc = _int8_gemm(d.reshape(-1, d.shape[-1]).to(torch.int8),
                     weight.to(torch.int8)).reshape(lead + (-1,))
    out_scale = _out_scale(data_min, data_max, weight_min, weight_max)
    if not no_bias:
        acc = acc + _bias_int32(bias, bias_min, bias_max, out_scale)
    return _q_triple(acc, out_scale)


@register_op("_contrib_quantized_conv", num_outputs=3,
             differentiable=False)
def quantized_conv(data, weight, bias, data_min, data_max, weight_min,
                   weight_max, bias_min, bias_max, *, kernel, num_filter,
                   stride=None, pad=None, dilate=None, num_group=1,
                   no_bias=False, layout=None):
    """int8 convolution with int32 accumulation, channel-first
    (reference ``quantized_conv.cc``)."""
    acc = _conv_product(data.to(torch.int8), weight.to(torch.int8),
                        _int8_gemm, kernel=kernel, stride=stride, pad=pad,
                        dilate=dilate, num_group=num_group)
    out_scale = _out_scale(data_min, data_max, weight_min, weight_max)
    if not no_bias:
        b = _bias_int32(bias, bias_min, bias_max, out_scale)
        acc = acc + b.reshape((1, -1) + (1,) * len(kernel))
    return _q_triple(acc, out_scale)


# ----------------------------------------------- fp8: e4m3, f32 accumulation
@register_op("_contrib_quantize_fp8", num_outputs=2, differentiable=False)
def quantize_fp8(data, *, min_calib_range=None, max_calib_range=None):
    """float -> (e4m3, amax (1,)): scaled onto +-448 and clipped there
    BEFORE the cast, since e4m3fn overflows to NaN."""
    if _calibrated(min_calib_range, max_calib_range):
        amax = max(_host_amax(min_calib_range, max_calib_range),
                   onp.float32(1e-12))
        factor = float(onp.float32(_FP8_MAX) / amax)
        amax = _const(amax, data)
    else:
        amax = torch.clamp(torch.maximum(data.min().to(_F32).abs(),
                                         data.max().to(_F32).abs()),
                           min=1e-12)
        factor = _FP8_MAX / amax
    q = torch.clamp(data.to(_F32) * factor, -_FP8_MAX,
                    _FP8_MAX).to(torch.float8_e4m3fn)
    return q, amax.reshape(1)


def _fp8_scale(data_amax, weight_amax):
    return (data_amax.reshape(()).to(_F32) / _FP8_MAX) \
        * (weight_amax.reshape(()).to(_F32) / _FP8_MAX)


@register_op("_contrib_fp8_fully_connected", differentiable=False)
def fp8_fully_connected(data, weight, bias, data_amax, weight_amax, *,
                        num_hidden, no_bias=False, flatten=True):
    """e4m3 x e4m3 -> f32 FC; the descale recovers the real domain and
    the bias is added there."""
    d = data.reshape(data.shape[0], -1) if flatten else data
    lead = d.shape[:-1]
    e4m3 = torch.float8_e4m3fn
    out = _fp8_gemm(d.reshape(-1, d.shape[-1]).to(e4m3), weight.to(e4m3),
                    _fp8_scale(data_amax, weight_amax)).reshape(
                        lead + (-1,))
    if not no_bias:
        out = out + bias.to(_F32)
    return out


@register_op("_contrib_fp8_conv", differentiable=False)
def fp8_conv(data, weight, bias, data_amax, weight_amax, *, kernel,
             num_filter, stride=None, pad=None, dilate=None, num_group=1,
             no_bias=False, layout=None):
    """fp8 convolution: e4m3 operands, f32 accumulation, real-domain f32
    output."""
    e4m3 = torch.float8_e4m3fn
    scale = _fp8_scale(data_amax, weight_amax)
    out = _conv_product(data.to(e4m3), weight.to(e4m3),
                        lambda a, w: _fp8_gemm(a, w, scale), kernel=kernel,
                        stride=stride, pad=pad, dilate=dilate,
                        num_group=num_group)
    if not no_bias:
        out = out + bias.to(_F32).reshape((1, -1) + (1,) * len(kernel))
    return out


# ------------------------------------------------------ range-preserving
@register_op("_contrib_quantized_pooling", num_outputs=3,
             differentiable=False)
def quantized_pooling(data, data_min, data_max, *, kernel=(),
                      pool_type="max", global_pool=False, stride=None,
                      pad=None, pooling_convention="valid"):
    """Pooling that keeps the quantization range (reference
    ``quantized_pooling.cc``).  The average is taken over the exact
    integer sum and rounded to nearest back to the codes' type."""
    kw = dict(kernel=kernel, pool_type=pool_type, global_pool=global_pool,
              stride=stride, pad=pad, pooling_convention=pooling_convention)
    if pool_type == "avg":
        out = torch.round(_pooling(data.to(torch.int32), **kw))
    else:
        # max of 8-bit codes, exact in float32 (CUDA pools floats only)
        out = _pooling(data.to(_F32), **kw)
    return out.to(data.dtype), data_min, data_max


@register_op("_contrib_quantized_flatten", num_outputs=3,
             differentiable=False)
def quantized_flatten(data, data_min, data_max):
    return data.reshape(data.shape[0], -1), data_min, data_max
