"""Example operator plugin for ``mx.library.load`` — the lib_api.h
analog (counterpart of ``example/plugin/pallas_ops.py``).

Registers a scaled residual add with a hand-written CUDA kernel
(``mxnet_tpu_torch/csrc/scaled_add.cu``) and a plain PyTorch op; loaded
ops appear in ``mx.nd`` at once:

    import mxnet_tpu_torch as mx
    mx.library.load("mxnet_tpu_torch/example/plugin/cuda_ops.py")
    mx.nd.plugin_scaled_add(a, b, scale=2.0)

``plugin_scaled_add(x, y, scale=s)`` is ``x + y * s`` with ``s`` rounded
to x's dtype, and ``x`` and ``y`` broadcast and promoted against each
other, as the reference computes it.  The op broadcasts and casts
first, then runs :func:`scaled_add` on same-shape, same-dtype buffers:
on a CUDA tensor the kernel (or a raised ``MXNetError``), on a CPU
tensor its plain version.  Its backward is ``dx = g``, ``dy = g * s``
in plain PyTorch (the reference has no backward kernel either).
"""
import ctypes
import functools
import struct
import threading

import torch

from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError

#: the kernel's dtype codes (csrc/scaled_add.cu)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.int32: 3, torch.int64: 4}
_count_lock = threading.Lock()


def _scale_tensor(scale, dtype):
    """The scale rounded to ``dtype``: a 0-d CPU tensor (torch takes it
    beside a tensor on any device without a copy to the card)."""
    return torch.tensor(scale, dtype=dtype)


@functools.lru_cache(maxsize=256)
def _cached_scale(key, dtype):
    scale = struct.unpack("<d", key)[0] if isinstance(key, bytes) else key
    return _scale_tensor(scale, dtype).item()


def _scale_value(scale, dtype):
    """The scale rounded to ``dtype`` as a Python number, the value of
    :func:`_scale_tensor`; a plain number is rounded once per (value,
    dtype) and then looked up.  A float is looked up by its bits, so
    that -0.0 and 0.0 (equal as keys) stay apart, and an int by its
    value, never as the float it equals."""
    if isinstance(scale, float):
        return _cached_scale(struct.pack("<d", scale), dtype)
    if isinstance(scale, int):
        return _cached_scale(int(scale), dtype)
    return _scale_tensor(scale, dtype).item()


def _scaled_add_plain(x, y, s):
    """The plain version: two PyTorch ops, each rounded to the dtype."""
    return x + y * s


@functools.cache
def _kernel():
    """The C entry point of ``csrc/scaled_add.cu``, built on first use."""
    fn = _kernels.load("scaled_add").mxt_scaled_add
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
        ctypes.c_void_p]
    return fn


def _dense_order(t):
    """The dimension order in which ``t`` is contiguous (a permuted
    dense tensor, e.g. a transposed one, needs no copy for an
    elementwise kernel), or None."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return order if t.permute(order).is_contiguous() else None


def scaled_add(x, y, scale):
    """``x + y * scale`` for ``x`` and ``y`` of one shape, dtype and
    device, the scale rounded to that dtype first.  A CPU tensor takes
    the plain version; a CUDA tensor the kernel, which
    ``scaled_add.launches`` counts (an empty array launches nothing),
    and a dtype the kernel lacks raises.  The kernel walks memory in
    order: inputs laid out alike and densely (contiguous, or permuted
    as a transposed view is) go as they are and the output takes their
    layout, as PyTorch's elementwise ops give it; others are copied
    to contiguous first."""
    dev = x.device
    if dev.type == "cpu":
        return _scaled_add_plain(x, y, _scale_tensor(scale, x.dtype))
    if y.shape != x.shape or y.dtype != x.dtype or y.device != dev:
        raise MXNetError(f"scaled_add takes x and y of one shape, dtype "
                         f"and device, got {tuple(x.shape)} {x.dtype} "
                         f"{dev} and {tuple(y.shape)} {y.dtype} "
                         f"{y.device}")
    code = _KERNEL_DTYPES.get(x.dtype)
    if code is None:
        raise MXNetError(f"scaled_add kernel takes "
                         f"{'/'.join(map(str, _KERNEL_DTYPES))}, not "
                         f"{x.dtype}")
    if x.is_contiguous() and y.is_contiguous():  # the common case
        out = o = torch.empty_like(x)
    else:
        order = _dense_order(x)
        if order is None or y.stride() != x.stride():
            x, y = x.contiguous(), y.contiguous()
            order = list(range(x.dim()))
        out = torch.empty_like(x)  # x's strides: x, y, out align in memory
        x, y, o = (t.permute(order) for t in (x, y, out))  # contiguous
    n = x.numel()
    if n == 0:
        return out
    s = _scale_value(scale, x.dtype)
    is_int = code >= 3
    # the raw handle of the device's current stream, without building a
    # torch.cuda.Stream object
    args = (x.data_ptr(), y.data_ptr(), o.data_ptr(), n, code,
            0.0 if is_int else s, s if is_int else 0,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = _kernel()(*args)
    else:
        with torch.cuda.device(dev):
            rc = _kernel()(*args)
    if rc != 0:
        raise MXNetError(f"scaled_add kernel launch failed (cudaError_t "
                         f"{rc}) on {n} {x.dtype} elements")
    with _count_lock:
        scaled_add.launches += 1
    return out


scaled_add.launches = 0


class _ScaledAdd(torch.autograd.Function):
    """:func:`scaled_add` of ``x`` and ``y`` (one dtype) broadcast
    against each other, with its gradient: ``dx`` the head gradient
    summed to x's shape, ``dy`` that summed to y's shape times the
    scale (the reference's order).  Saves only the scale and the two
    shapes."""

    @staticmethod
    def forward(ctx, x, y, scale):
        ctx.scale, ctx.shapes = scale, (x.shape, y.shape)
        if x.shape != y.shape:
            shape = torch.broadcast_shapes(x.shape, y.shape)
            x, y = x.broadcast_to(shape), y.broadcast_to(shape)
        return scaled_add(x, y, scale)

    @staticmethod
    def backward(ctx, g):
        xs, ys = ctx.shapes
        return (g.sum_to_size(xs),
                g.sum_to_size(ys) * _scale_tensor(ctx.scale, g.dtype), None)


def register_ops(registry):
    @registry.register_op("plugin_scaled_add")
    def plugin_scaled_add(x, y, *, scale=1.0):
        dt = torch.promote_types(x.dtype, y.dtype)
        s = _scale_value(scale, x.dtype)  # jnp.asarray(scale, x.dtype)
        return _ScaledAdd.apply(x.to(dt), y.to(dt), s)

    @registry.register_op("plugin_swish")
    def plugin_swish(x, *, beta=1.0):
        return x * torch.sigmoid(beta * x)
