"""Fused flat-bucket optimizer update (counterpart of
``mxnet_tpu/ops/pallas_opt.py``).

:func:`bucket_update` runs the whole update of one flat bucket — the
gradient prep (rescale, clip), the SGD rule with or without momentum,
and optionally the loss-scale verdict (the count of non-finite raw
gradient elements) — in one pass over (w, g, state).  On a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/bucket_sgd.cu``
through :func:`bucket_sgd_mom` / :func:`bucket_sgd`, the ports of the
reference's Pallas ``_sgd_mom_kernel`` / ``_sgd_kernel`` with
``_nf_accumulate``; on a CPU tensor those wrappers compute the plain
version, :func:`_sgd_reference`.  A CUDA tensor never falls back.

The kernel is bit-identical to the plain version on the card: every
operation is rounded on its own in the reference's order, as PyTorch's
one-op-per-kernel evaluation rounds it.  The verdict stays on the
device (no host sync).

:func:`scale_bookkeeping` is the dynamic loss scale's update rule,
verbatim.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from ..optimizer.optimizer import scalar_as

__all__ = ["supported", "bucket_update", "bucket_sgd", "bucket_sgd_mom",
           "scale_bookkeeping"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def supported(opt, dtype):
    """None when the kernels can run ``opt`` on a bucket of ``dtype``;
    otherwise the reason."""
    from ..optimizer.optimizer import SGD

    name = type(opt).__name__
    if name in ("Adam", "LARS"):
        return f"{name.lower()} bucket kernel not ported yet (ROADMAP §B)"
    if type(opt) is not SGD:
        return f"no bucket kernel for {name}"
    if dtype not in _KERNEL_DTYPES:
        return f"sgd kernel supports float32/bfloat16 buckets, not {dtype}"
    return None


# ------------------------------------------------------------ plain twin
def _sgd_reference(w, g, m, lr, wd, momentum, rescale, clip, with_finite):
    """The update in plain PyTorch: ``(new_w, new_m or None, nf)`` with
    ``nf`` the int32 count of non-finite raw ``g`` (None unless
    ``with_finite``).  Hyper-parameters are taken as given (the caller
    rounds them to w's dtype)."""
    nf = None
    if with_finite:
        nf = (~torch.isfinite(g.to(torch.float32))).sum(dtype=torch.int32)
    gp = g.to(w.dtype) * rescale
    if clip is not None:
        gp = torch.clamp(gp, -clip, clip)
    step = lr * (gp + wd * w)
    if m is None:
        return w - step, None, nf
    mom = momentum * m - step
    return w + mom, mom, nf


# ------------------------------------------------------------ the kernel
def _check_bucket(w, g, m, out):
    if w.dim() != 1 or g.shape != w.shape or w.numel() == 0:
        raise MXNetError(f"bucket kernel takes non-empty flat buckets of "
                         f"one length, got w {tuple(w.shape)}, g "
                         f"{tuple(g.shape)}")
    if w.dtype not in _KERNEL_DTYPES or g.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"bucket kernel takes float32/bfloat16 w and g, "
                         f"got {w.dtype}/{g.dtype}")
    for t in [m, *out]:
        if t is not None and (t.shape != w.shape or t.dtype != w.dtype):
            raise MXNetError(f"bucket kernel state/outputs must match w "
                             f"{tuple(w.shape)} {w.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in [g, m, *out]:
        if t is not None and t.device != w.device:
            raise MXNetError(f"bucket kernel operands on several devices: "
                             f"{w.device}, {t.device}")
    if not all(t.is_contiguous() for t in [w, g, m, *out] if t is not None):
        raise MXNetError("bucket kernel takes contiguous buckets")


def _sgd_cuda(w, g, m, out_w, out_m, lr, wd, momentum, rescale, clip,
              with_finite):
    """Launch ``csrc/bucket_sgd.cu``; writes out_w (and out_m), which may
    be w (and m) for an in-place update.  Returns the count tensor."""
    from .. import _kernels

    _check_bucket(w, g, m, [out_w, out_m])
    fn = _kernels.load("bucket_sgd").mxt_bucket_sgd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int,
                                                    ctypes.c_void_p]
    nf = torch.zeros((), dtype=torch.int32, device=w.device) \
        if with_finite else None
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), g.data_ptr(),
                None if m is None else m.data_ptr(), out_w.data_ptr(),
                None if out_m is None else out_m.data_ptr(),
                None if nf is None else nf.data_ptr(), w.numel(),
                _KERNEL_DTYPES[w.dtype], _KERNEL_DTYPES[g.dtype],
                int(m is not None), int(with_finite), lr, wd, momentum,
                rescale, 0.0 if clip is None else clip,
                int(clip is not None), stream)
    if rc != 0:
        raise MXNetError(f"bucket_sgd kernel launch failed (cudaError_t "
                         f"{rc}) for {w.numel()} {w.dtype} elements")
    return nf


def bucket_sgd_mom(w, g, m, *, lr, wd, momentum, rescale=1.0, clip=None,
                   with_finite=False, out=None):
    """SGD-momentum over a flat bucket: ``(new_w, new_m, nf)``.
    ``out=(w_out, m_out)`` writes the results there (the inputs
    themselves for an in-place update).  CUDA tensor: the kernel
    (``bucket_sgd_mom.launches`` counts it); CPU tensor: the plain
    version."""
    if w.device.type == "cpu":
        new_w, new_m, nf = _sgd_reference(w, g, m, lr, wd, momentum,
                                          rescale, clip, with_finite)
        if out is not None:
            new_w = out[0].copy_(new_w)
            new_m = out[1].copy_(new_m)
        return new_w, new_m, nf
    if m is None:
        raise MXNetError("bucket_sgd_mom needs the momentum bucket")
    out_w, out_m = out if out is not None else (torch.empty_like(w),
                                                torch.empty_like(m))
    nf = _sgd_cuda(w, g, m, out_w, out_m, lr, wd, momentum, rescale, clip,
                   with_finite)
    with _count_lock:
        bucket_sgd_mom.launches += 1
    return out_w, out_m, nf


def bucket_sgd(w, g, *, lr, wd, rescale=1.0, clip=None, with_finite=False,
               out=None):
    """SGD without momentum over a flat bucket: ``(new_w, nf)``;
    ``out`` is the tensor to write (w itself for in place).
    ``bucket_sgd.launches`` counts kernel launches."""
    if w.device.type == "cpu":
        new_w, _, nf = _sgd_reference(w, g, None, lr, wd, 0.0, rescale,
                                      clip, with_finite)
        return (new_w if out is None else out.copy_(new_w)), nf
    out_w = out if out is not None else torch.empty_like(w)
    nf = _sgd_cuda(w, g, None, out_w, None, lr, wd, 0.0, rescale, clip,
                   with_finite)
    with _count_lock:
        bucket_sgd.launches += 1
    return out_w, nf


bucket_sgd_mom.launches = 0
bucket_sgd.launches = 0


def bucket_update(opt, w, g, state, t, *, with_finite=False, out=None):
    """One fused pass over a flat bucket: ``(new_w, new_state, finite)``
    with ``finite`` a 0-dim bool tensor (the raw gradient had no
    non-finite element) or None unless ``with_finite``.  ``out``
    (tensors shaped like ``(w, *state)``) receives the results, for an
    in-place update.  Returns None when :func:`supported` says the
    kernel cannot run this bucket (the reference's contract)."""
    del t  # SGD does not use the step count
    if supported(opt, w.dtype) is not None:
        return None
    dt = w.dtype
    rescale = scalar_as(opt.rescale_grad, dt)
    clip = None if opt.clip_gradient is None else \
        scalar_as(opt.clip_gradient, dt)
    lr, wd = scalar_as(opt.learning_rate, dt), scalar_as(opt.wd, dt)
    if float(opt.momentum) == 0.0:
        new_w, nf = bucket_sgd(w, g, lr=lr, wd=wd, rescale=rescale,
                               clip=clip, with_finite=with_finite,
                               out=None if out is None else out[0])
        # momentum zeroed live: any state slot passes through untouched
        new_state = state
    else:
        (mom,) = state
        new_w, new_m, nf = bucket_sgd_mom(
            w, g, mom, lr=lr, wd=wd, momentum=scalar_as(opt.momentum, dt),
            rescale=rescale, clip=clip, with_finite=with_finite, out=out)
        new_state = (new_m,)
    return new_w, new_state, (nf == 0) if with_finite else None


def scale_bookkeeping(finite, scale, good, growth_interval=2000):
    """Dynamic-loss-scale update (reference ``scale_bookkeeping``,
    ``mxnet_tpu/ops/pallas_opt.py:478``): overflow halves the scale
    (floor 1.0); ``growth_interval`` consecutive finite steps double it
    and reset the counter.  All on the device."""
    good = torch.where(finite, good + 1, torch.zeros_like(good))
    new_scale = torch.where(
        finite, torch.where(good >= growth_interval, scale * 2.0, scale),
        torch.clamp_min(scale * 0.5, 1.0))
    good = torch.where(good >= growth_interval, torch.zeros_like(good), good)
    return new_scale.to(torch.float32), good
