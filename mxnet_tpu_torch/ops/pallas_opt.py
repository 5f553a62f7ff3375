"""Fused flat-bucket optimizer update (counterpart of
``mxnet_tpu/ops/pallas_opt.py``).

:func:`bucket_update` runs the whole update of one flat bucket — the
gradient prep (rescale, clip), the rule, and optionally the loss-scale
verdict (the count of non-finite raw gradient elements) — on the
device, with no host sync.  Each rule has a wrapper that launches a
hand-written Hopper kernel on a CUDA tensor and computes its plain
version, beside it here, on a CPU tensor.  A CUDA tensor never falls
back.

- SGD, with or without momentum: :func:`bucket_sgd_mom` /
  :func:`bucket_sgd` (``csrc/bucket_sgd.cu``; the reference's
  ``_sgd_mom_kernel`` / ``_sgd_kernel`` with ``_nf_accumulate``), fp32
  and bf16 buckets.
- Adam: :func:`bucket_adam` (``csrc/bucket_adam.cu``; ``_adam_kernel``),
  fp32 buckets.  The bias-corrected rate is computed on the host
  (:func:`~mxnet_tpu_torch.optimizer.optimizer.adam_lr_t`).
- LARS, per tensor of the bucket (segment ids from
  ``parallel.zero.bucket_segments``): :func:`bucket_lars_norms` (the
  per-segment squared norms and the trust ratios, two kernels:
  ``_lars_norms_kernel`` and the reference's jnp trust math) and
  :func:`bucket_lars_update` (``_lars_update_kernel``), both in
  ``csrc/bucket_lars.cu``; fp32 buckets of at most ``MAX_SEGMENTS``
  tensors.

The elementwise kernels are bit-identical to their plain versions on
the card: every operation is rounded on its own in the reference's
order, as PyTorch's one-op-per-kernel evaluation rounds it.  The LARS
norms are a tree of fp32 sums, held to the plain version's float64
sums: the whole LARS update agrees with its plain version to rtol/atol
1e-6 (the reference's own tolerance between its kernel and its jnp
rule), and is deterministic: no float atomics.

:func:`scale_bookkeeping` is the dynamic loss scale's update rule,
verbatim, and :func:`fp8_delayed_scale` / :func:`fp8_qdq` the dtype
ladder's fp8 rung beside it (elementwise PyTorch, as the reference's
are jnp).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from ..optimizer import optimizer as _opt
from ..optimizer.optimizer import scalar_as

__all__ = ["supported", "bucket_update", "bucket_sgd", "bucket_sgd_mom",
           "bucket_adam", "bucket_lars_norms", "bucket_lars_update",
           "scale_bookkeeping", "MAX_SEGMENTS", "E4M3_MAX", "E5M2_MAX",
           "fp8_delayed_scale", "fp8_qdq"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most tensors a LARS bucket may hold (the reference's
#: ``_MAX_SEGMENTS``; the kernels keep one partial per segment)
MAX_SEGMENTS = 128
_count_lock = threading.Lock()


def supported(opt, dtype, nseg=None):
    """None when the kernels can run ``opt`` on a bucket of ``dtype``
    (of ``nseg`` segments, for LARS); otherwise the reason."""
    from ..optimizer.optimizer import LARS, SGD, Adam

    if type(opt) is SGD:
        if dtype not in _KERNEL_DTYPES:
            return f"sgd kernel supports float32/bfloat16 buckets, not " \
                   f"{dtype}"
        return None
    if type(opt) in (Adam, LARS):
        name = type(opt).__name__.lower()
        if dtype != torch.float32:
            return f"{name} kernel supports float32 buckets, not {dtype}"
        if name == "lars" and nseg is not None and nseg > MAX_SEGMENTS:
            return f"lars bucket has {nseg} segments (> {MAX_SEGMENTS})"
        return None
    return f"no bucket kernel for {type(opt).__name__}"


# ------------------------------------------------------------ plain twins
def _nonfinite(g):
    """int32 count of the non-finite elements of the raw gradient."""
    return (~torch.isfinite(g.to(torch.float32))).sum(dtype=torch.int32)


def _prep(g, rescale, clip):
    """``Optimizer._prep``: ``g * rescale``, then the symmetric clip."""
    g = g * rescale
    return g if clip is None else torch.clamp(g, -clip, clip)


def _sgd_reference(w, g, m, lr, wd, momentum, rescale, clip, with_finite):
    """The update in plain PyTorch: ``(new_w, new_m or None, nf)`` with
    ``nf`` the int32 count of non-finite raw ``g`` (None unless
    ``with_finite``).  Hyper-parameters are taken as given (the caller
    rounds them to w's dtype)."""
    nf = _nonfinite(g) if with_finite else None
    gp = _prep(g.to(w.dtype), rescale, clip)
    step = lr * (gp + wd * w)
    if m is None:
        return w - step, None, nf
    mom = momentum * m - step
    return w + mom, mom, nf


def _adam_reference(w, g, m, v, lr_t, wd, beta1, beta2, eps, rescale,
                    clip, with_finite):
    """Adam over an fp32 bucket: ``(new_w, new_m, new_v, nf)``, with the
    kernel's constants (:func:`_adam_consts`)."""
    nf = _nonfinite(g) if with_finite else None
    c = _adam_consts(wd, beta1, beta2, eps)
    new_w, new_m, new_v = _opt._adam_step(
        w, m, v, _prep(g.to(w.dtype), _f32(rescale), _f32_or_none(clip)),
        _f32(lr_t), **c)
    return new_w, new_m, new_v, nf


def _lars_norms_reference(w, g, seg, nseg, rescale, clip, with_finite):
    """Phase (a): the per-segment ``Σw²`` and ``Σ(prepped g)²`` and the
    non-finite count.  The fp32 squares are summed in float64 and the
    sums rounded once: an fp32 ``index_add_`` into one slot drifts by
    up to 2e-3 over a tensor of 2.36 M elements (measured on an H100),
    far more than the kernel's tree of fp32 sums, which is held to
    this."""
    nf = _nonfinite(g) if with_finite else None
    gp = _prep(g.to(torch.float32), _f32(rescale), _f32_or_none(clip))
    return tuple(_opt.segment_sum((x * x).double(), seg, nseg).float()
                 for x in (w, gp)) + (nf,)


def _lars_trust_reference(w_ss, g_ss, lr, wd, eta, eps):
    """Phase (b): ``lr·trust`` per segment."""
    return _opt._lars_scaled_lr(w_ss, g_ss, _f32(lr), _f32(wd), _f32(eta),
                                _f32(eps))


def _lars_update_reference(w, g, m, seg, slr, wd, momentum, rescale, clip):
    """Phase (c): ``mom = momentum·m + slr[seg]·(g + wd·w)``, ``w −
    mom``."""
    gp = _prep(g.to(torch.float32), _f32(rescale), _f32_or_none(clip))
    return _opt._lars_momentum(w, m, gp, slr[seg], _f32(wd), _f32(momentum))


def _f32(x):
    return scalar_as(x, torch.float32)


def _f32_or_none(x):
    return None if x is None else _f32(x)


def _adam_consts(wd, beta1, beta2, eps):
    """The Adam kernel's fp32 constants.  ``1 − beta`` is taken from the
    Python float and then rounded, as the reference kernel's weak-typed
    ``(1 - beta1)`` is: f32(0.1), not ``1 − f32(0.9)`` = 0.100000024."""
    return dict(wd=_f32(wd), beta1=_f32(beta1), beta2=_f32(beta2),
                one_m_beta1=_f32(1.0 - beta1), one_m_beta2=_f32(1.0 - beta2),
                eps=_f32(eps))


# ------------------------------------------------------------ the kernels
def _check_bucket(w, g, state, out, dtypes=_KERNEL_DTYPES):
    """Refuse what the bucket kernels do not take: w and g flat,
    non-empty and of one length, of ``dtypes``; state and outputs (None
    entries skipped) shaped and typed like w; one device; contiguous."""
    if w.dim() != 1 or g.shape != w.shape or w.numel() == 0:
        raise MXNetError(f"bucket kernel takes non-empty flat buckets of "
                         f"one length, got w {tuple(w.shape)}, g "
                         f"{tuple(g.shape)}")
    if w.dtype not in dtypes or g.dtype not in dtypes:
        raise MXNetError(f"bucket kernel takes {'/'.join(map(str, dtypes))}"
                         f" w and g, got {w.dtype}/{g.dtype}")
    others = [t for t in [*state, *out] if t is not None]
    for t in others:
        if t.shape != w.shape or t.dtype != w.dtype:
            raise MXNetError(f"bucket kernel state/outputs must match w "
                             f"{tuple(w.shape)} {w.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in [g, *others]:
        if t.device != w.device:
            raise MXNetError(f"bucket kernel operands on several devices: "
                             f"{w.device}, {t.device}")
    if not all(t.is_contiguous() for t in [w, g, *others]):
        raise MXNetError("bucket kernel takes contiguous buckets")


def _c_fn(lib, name, argtypes):
    """The C entry point ``name`` of ``csrc/<lib>.cu`` (built on first
    use), typed: every pointer a ``c_void_p``, returning an int."""
    from .. import _kernels

    fn = getattr(_kernels.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _launched(rc, what):
    if rc != 0:
        raise MXNetError(f"{what} kernel launch failed (cudaError_t {rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _sgd_cuda(w, g, m, out_w, out_m, lr, wd, momentum, rescale, clip,
              with_finite):
    """Launch ``csrc/bucket_sgd.cu``; writes out_w (and out_m), which may
    be w (and m) for an in-place update.  Returns the count tensor."""
    _check_bucket(w, g, [m], [out_w, out_m])
    fn = _c_fn("bucket_sgd", "mxt_bucket_sgd",
               [_P] * 6 + [ctypes.c_longlong] + [_I] * 4 + [_F] * 5
               + [_I, _P])
    nf = torch.zeros((), dtype=torch.int32, device=w.device) \
        if with_finite else None
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), g.data_ptr(),
                _ptr(m), out_w.data_ptr(), _ptr(out_m), _ptr(nf), w.numel(),
                _KERNEL_DTYPES[w.dtype], _KERNEL_DTYPES[g.dtype],
                int(m is not None), int(with_finite), lr, wd, momentum,
                rescale, 0.0 if clip is None else clip,
                int(clip is not None), stream)
    _launched(rc, f"bucket_sgd ({w.numel()} {w.dtype} elements)")
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


# ------------------------------------------------------------ Adam
def bucket_adam(w, g, m, v, *, lr_t, wd, beta1, beta2, eps, rescale=1.0,
                clip=None, with_finite=False, out=None):
    """Adam over an fp32 flat bucket: ``(new_w, new_m, new_v, nf)``.
    Hyper-parameters are the optimizer's Python floats (``lr_t`` the
    bias-corrected rate); ``out=(w, m, v)`` writes the results in place.
    CUDA tensor: ``csrc/bucket_adam.cu`` (``bucket_adam.launches``
    counts it); CPU tensor: the plain version."""
    _check_bucket(w, g, [m, v], out or [], dtypes=(torch.float32,))
    if w.device.type == "cpu":
        res = _adam_reference(w, g, m, v, lr_t, wd, beta1, beta2, eps,
                              rescale, clip, with_finite)
        if out is not None:
            res = tuple(o.copy_(r) for o, r in zip(out, res[:3])) + res[3:]
        return res
    out_w, out_m, out_v = out if out is not None else (
        torch.empty_like(w), torch.empty_like(m), torch.empty_like(v))
    c = _adam_consts(wd, beta1, beta2, eps)
    nf = torch.zeros((), dtype=torch.int32, device=w.device) \
        if with_finite else None
    fn = _c_fn("bucket_adam", "mxt_bucket_adam",
               [_P] * 8 + [ctypes.c_longlong, _I] + [_F] * 9 + [_I, _P])
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                out_w.data_ptr(), out_m.data_ptr(), out_v.data_ptr(),
                _ptr(nf), w.numel(), int(with_finite), _f32(lr_t), c["wd"],
                c["beta1"], c["beta2"], c["one_m_beta1"], c["one_m_beta2"],
                c["eps"], _f32(rescale), _f32(0.0 if clip is None else clip),
                int(clip is not None),
                torch.cuda.current_stream(w.device).cuda_stream)
    _launched(rc, f"bucket_adam ({w.numel()} elements)")
    with _count_lock:
        bucket_adam.launches += 1
    return out_w, out_m, out_v, nf


# ------------------------------------------------------------ LARS
def _check_seg(w, seg, nseg):
    if seg.dtype != torch.int32 or seg.shape != w.shape or \
            seg.device != w.device or not seg.is_contiguous():
        raise MXNetError(f"lars kernels take contiguous int32 segment ids "
                         f"shaped like w {tuple(w.shape)} on {w.device}, "
                         f"got {seg.dtype} {tuple(seg.shape)} on "
                         f"{seg.device}")
    if not 1 <= nseg <= MAX_SEGMENTS:
        raise MXNetError(f"lars kernels take 1..{MAX_SEGMENTS} segments, "
                         f"got {nseg}")


def bucket_lars_norms(w, g, seg, nseg, *, lr, wd, eta, eps, rescale=1.0,
                      clip=None, with_finite=False, axis=None):
    """LARS phases (a) and (b) over an fp32 flat bucket whose element
    ``i`` belongs to tensor ``seg[i]`` (int32, below ``nseg`` ≤
    ``MAX_SEGMENTS``): ``(slr, w_ss, g_ss, nf)`` with ``w_ss``/``g_ss``
    the per-segment squared norms of w and of the prepped gradient and
    ``slr = lr·trust`` per segment.  ``axis`` (an
    ``ops.collective_ops.Exchange`` or an axis name) makes ``w`` a shard
    of a bucket split over processes: the norms and the count sum over
    them before the trust, as the reference's psum does
    (``mxnet_tpu/ops/pallas_opt.py:429-431``).

    CUDA tensor: ``csrc/bucket_lars.cu`` — per-CTA partials (counted by
    ``bucket_lars_norms.launches``), then their fixed-order reduce and
    the trust ratios in one launch (``trust_launches``); with ``axis``
    the reduce (``reduce_launches``), one all-reduce of the sums and
    the count, and the trust from the summed norms (``trust_launches``).
    CPU tensor: the plain version, summed over ``axis`` alike."""
    from .collective_ops import all_reduce_sum

    _check_bucket(w, g, [], [], dtypes=(torch.float32,))
    _check_seg(w, seg, nseg)
    if w.device.type == "cpu":
        w_ss, g_ss, nf = _lars_norms_reference(w, g, seg, nseg, rescale,
                                               clip, with_finite)
        if axis is not None:
            sums = torch.cat([w_ss, g_ss] + (
                [nf.reshape(1).to(torch.float32)] if with_finite else []))
            all_reduce_sum(sums, axis)
            w_ss, g_ss = sums[:nseg], sums[nseg:2 * nseg]
            if with_finite:
                nf = sums[2 * nseg].to(torch.int32)
        return (_lars_trust_reference(w_ss, g_ss, lr, wd, eta, eps), w_ss,
                g_ss, nf)
    n = w.numel()
    blocks = _c_fn("bucket_lars", "mxt_lars_norm_blocks",
                   [ctypes.c_longlong])(n)
    part = torch.empty((2, blocks, nseg), dtype=torch.float32,
                       device=w.device)
    part_nf = torch.empty((blocks,), dtype=torch.int32, device=w.device)
    # the sums of a split launch keep the count after them (2·nseg + 1)
    sq = torch.empty((2 * nseg + (axis is not None),), dtype=torch.float32,
                     device=w.device)
    slr = torch.empty((nseg,), dtype=torch.float32, device=w.device)
    nf = torch.empty((), dtype=torch.int32, device=w.device) \
        if with_finite else None
    norms = _c_fn("bucket_lars", "mxt_lars_norms",
                  [_P] * 5 + [ctypes.c_longlong] + [_I] * 2 + [_F] * 2
                  + [_I] * 2 + [_P])
    hyper = (_f32(lr), _f32(wd), _f32(eta), _f32(eps))
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = norms(w.data_ptr(), g.data_ptr(), seg.data_ptr(),
                   part.data_ptr(), part_nf.data_ptr(), n, nseg,
                   int(with_finite), _f32(rescale),
                   _f32(0.0 if clip is None else clip), int(clip is not None),
                   blocks, stream)
        _launched(rc, f"bucket_lars norms ({n} elements, {nseg} segments)")
        with _count_lock:
            bucket_lars_norms.launches += 1
        if axis is None:
            trust = _c_fn("bucket_lars", "mxt_lars_trust",
                          [_P] * 5 + [_I] * 3 + [_F] * 4 + [_P])
            rc = trust(part.data_ptr(), part_nf.data_ptr(), sq.data_ptr(),
                       slr.data_ptr(), _ptr(nf), blocks, nseg,
                       int(with_finite), *hyper, stream)
            _launched(rc, f"bucket_lars trust ({nseg} segments)")
            with _count_lock:
                bucket_lars_norms.trust_launches += 1
            return slr, sq[:nseg], sq[nseg:], nf
        reduce = _c_fn("bucket_lars", "mxt_lars_reduce",
                       [_P] * 3 + [_I] * 3 + [_P])
        rc = reduce(part.data_ptr(), part_nf.data_ptr(), sq.data_ptr(),
                    blocks, nseg, int(with_finite), stream)
        _launched(rc, f"bucket_lars reduce ({nseg} segments)")
        with _count_lock:
            bucket_lars_norms.reduce_launches += 1
    all_reduce_sum(sq, axis)
    trust = _c_fn("bucket_lars", "mxt_lars_trust_sums",
                  [_P] * 3 + [_I] * 2 + [_F] * 4 + [_P])
    with torch.cuda.device(w.device):
        rc = trust(sq.data_ptr(), slr.data_ptr(), _ptr(nf), nseg,
                   int(with_finite), *hyper,
                   torch.cuda.current_stream(w.device).cuda_stream)
        _launched(rc, f"bucket_lars trust from sums ({nseg} segments)")
        with _count_lock:
            bucket_lars_norms.trust_launches += 1
    return slr, sq[:nseg], sq[nseg:2 * nseg], nf


def bucket_lars_update(w, g, m, seg, slr, *, wd, momentum, rescale=1.0,
                       clip=None, out=None):
    """LARS phase (c) over an fp32 flat bucket: ``mom = momentum·m +
    slr[seg]·(g + wd·w)``; ``(w − mom, mom)``.  ``out=(w, m)`` writes in
    place.  CUDA tensor: ``csrc/bucket_lars.cu``
    (``bucket_lars_update.launches`` counts it); CPU tensor: the plain
    version."""
    _check_bucket(w, g, [m], out or [], dtypes=(torch.float32,))
    _check_seg(w, seg, slr.numel())
    if slr.dtype != torch.float32 or slr.dim() != 1 or \
            slr.device != w.device or not slr.is_contiguous():
        raise MXNetError(f"lars update takes a float32 vector slr on "
                         f"{w.device}, got {slr.dtype} {tuple(slr.shape)}")
    if w.device.type == "cpu":
        res = _lars_update_reference(w, g, m, seg, slr, wd, momentum,
                                     rescale, clip)
        if out is not None:
            res = tuple(o.copy_(r) for o, r in zip(out, res))
        return res
    out_w, out_m = out if out is not None else (torch.empty_like(w),
                                                torch.empty_like(m))
    fn = _c_fn("bucket_lars", "mxt_lars_update",
               [_P] * 7 + [ctypes.c_longlong, _I] + [_F] * 4 + [_I, _P])
    with torch.cuda.device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), seg.data_ptr(),
                slr.data_ptr(), out_w.data_ptr(),
                out_m.data_ptr(), w.numel(), slr.numel(), _f32(wd),
                _f32(momentum), _f32(rescale),
                _f32(0.0 if clip is None else clip), int(clip is not None),
                torch.cuda.current_stream(w.device).cuda_stream)
    _launched(rc, f"bucket_lars update ({w.numel()} elements)")
    with _count_lock:
        bucket_lars_update.launches += 1
    return out_w, out_m


bucket_adam.launches = 0
bucket_lars_norms.launches = 0
bucket_lars_norms.reduce_launches = 0
bucket_lars_norms.trust_launches = 0
bucket_lars_update.launches = 0


def bucket_update(opt, w, g, state, t, *, seg=None, axis_name=None,
                  with_finite=False, out=None):
    """One fused update of a flat bucket: ``(new_w, new_state, finite)``
    with ``finite`` a 0-dim bool tensor (the raw gradient had no
    non-finite element) or None unless ``with_finite``.  ``t`` is the
    1-based step count (Adam's bias correction); ``seg`` = ``(ids,
    nseg)``, the bucket's segment ids (LARS), and ``axis_name`` the
    processes over which a shard's LARS norms sum (see
    :func:`bucket_lars_norms`).  ``out`` (tensors shaped
    like ``(w, *state)``) receives the results, for an in-place update.
    Returns None when :func:`supported` says the kernels cannot run
    this bucket, or for LARS without segment ids (the reference's
    contract)."""
    from ..optimizer.optimizer import LARS, SGD, adam_lr_t

    nseg = None if seg is None else int(seg[1])
    if supported(opt, w.dtype, nseg) is not None or (
            type(opt) is LARS and seg is None):
        return None
    if type(opt) is SGD:
        new_w, new_state, nf = _sgd_bucket(opt, w, g, state, with_finite,
                                           out)
    else:
        h = dict(wd=opt.wd, rescale=opt.rescale_grad,
                 clip=opt.clip_gradient)
        g = g.to(torch.float32)
        if type(opt) is LARS:
            (mom,) = state
            slr, _, _, nf = bucket_lars_norms(
                w, g, seg[0], nseg, lr=opt.learning_rate, eta=opt.eta,
                eps=opt.epsilon, with_finite=with_finite, axis=axis_name,
                **h)
            new_w, new_m = bucket_lars_update(
                w, g, mom, seg[0], slr, momentum=opt.momentum, out=out, **h)
            new_state = (new_m,)
        else:
            m, v = state
            new_w, new_m, new_v, nf = bucket_adam(
                w, g, m, v, lr_t=adam_lr_t(opt.learning_rate, opt.beta1,
                                           opt.beta2, t),
                beta1=opt.beta1, beta2=opt.beta2, eps=opt.epsilon,
                with_finite=with_finite, out=out, **h)
            new_state = (new_m, new_v)
    return new_w, new_state, (nf == 0) if with_finite else None


def _sgd_bucket(opt, w, g, state, with_finite, out):
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
        return new_w, state, nf
    (mom,) = state
    new_w, new_m, nf = bucket_sgd_mom(
        w, g, mom, lr=lr, wd=wd, momentum=scalar_as(opt.momentum, dt),
        rescale=rescale, clip=clip, with_finite=with_finite, out=out)
    return new_w, (new_m,), nf


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


# ------------------------------------------------------- the fp8 rung
#: largest finite value of each fp8 format: e4m3fn is the forward and
#: weight format, e5m2 the gradient format
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp8_delayed_scale(hist, new_amax, fmax=E4M3_MAX, margin=2.0):
    """One step of the fp8 delayed-scaling recipe (reference
    ``fp8_delayed_scale``, ``mxnet_tpu/ops/pallas_opt.py:494``): roll
    ``new_amax`` (this step's observed |t|_inf) into the amax history
    and derive the scale the next step quantizes with, ``fmax / (margin
    * max(history))`` — the scale lags the observation by one step, so
    no step waits on its own amax and nothing syncs with the host.  A
    non-finite observation enters the history as twice the previous
    maximum (at least 1), so the next scale backs off by half instead
    of the history being poisoned.  Returns ``(new_hist, next_scale)``,
    both float32."""
    hist = hist.to(torch.float32)
    new_amax = torch.as_tensor(new_amax, dtype=torch.float32,
                               device=hist.device)
    prev = hist.max()
    safe = torch.where(torch.isfinite(new_amax), new_amax,
                       torch.clamp_min(prev, 1.0) * 2.0)
    new_hist = torch.cat([hist[1:], safe.reshape(1)])
    amax = torch.clamp_min(new_hist.max(), 1e-12)
    # a true division: ``fmax / tensor`` would be fmax * (1 / tensor),
    # one rounding more than the reference's
    return new_hist, torch.div(torch.full_like(amax, fmax), margin * amax)


def _fp8_qdq_cast(v, scale, fmax, f8):
    """Quantize-dequantize through an fp8 grid: clip to ±fmax first (an
    out-of-range e4m3 cast is NaN), cast, and return to ``v``'s dtype,
    so the surrounding program is unchanged."""
    wide = v.to(torch.float32) * scale
    q = torch.clamp(wide, -fmax, fmax).to(f8)
    return (q.to(torch.float32) / scale).to(v.dtype)


class _Fp8Qdq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, scale, gscale):
        ctx.save_for_backward(gscale)
        return _fp8_qdq_cast(v, scale, E4M3_MAX, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        (gscale,) = ctx.saved_tensors
        return (g if gscale is None else fp8_grad_qdq(g, gscale),
                None, None)


def fp8_grad_qdq(g, gscale):
    """A gradient snapped to the ``float8_e5m2`` grid at ``gscale``: the
    backward of :func:`fp8_qdq`."""
    return _fp8_qdq_cast(g, gscale, E5M2_MAX, torch.float8_e5m2)


def fp8_qdq(v, scale, gscale):
    """The dtype ladder's fp8 rung (reference ``fp8_qdq``,
    ``mxnet_tpu/ops/pallas_opt.py:530``): the forward snaps ``v`` to the
    ``float8_e4m3fn`` grid at ``scale``, the backward snaps the incoming
    gradient to the ``float8_e5m2`` grid at ``gscale`` — straight
    through in both directions, so a matmul or convolution sees
    fp8-valued operands while everything around it stays wide.  The
    scales are 0-d float32 tensors (``opt_state['_fp8']``,
    :func:`fp8_delayed_scale`); neither takes a gradient.  ``gscale``
    None passes the gradient through unsnapped, for a caller that snaps
    the summed gradient itself (:func:`fp8_grad_qdq`).  Elementwise
    PyTorch on either device, as the reference's is jnp."""
    return _Fp8Qdq.apply(v, scale, gscale)


# ------------------------------------------------------- registry ops
from .registry import register_op  # noqa: E402


def _mk_opt(kind, params):
    from ..optimizer.optimizer import LARS, SGD, Adam

    if kind == "sgd_mom":
        return SGD(momentum=params.get("momentum", 0.9),
                   learning_rate=params.get("lr", 0.1),
                   wd=params.get("wd", 0.0))
    if kind == "adam":
        return Adam(learning_rate=params.get("lr", 0.001),
                    wd=params.get("wd", 0.0))
    return LARS(momentum=params.get("momentum", 0.9),
                learning_rate=params.get("lr", 0.1),
                wd=params.get("wd", 0.0))


def _op_bucket_update(op_name, opt, w, g, state, seg=None):
    """The registry ops' dispatch through :func:`bucket_update` (a CUDA
    tensor launches the kernel, a CPU tensor takes its plain version);
    a bucket the kernels cannot run raises, naming the plain op."""
    nseg = None if seg is None else int(seg[1])
    reason = supported(opt, w.dtype, nseg=nseg)
    res = None if reason else bucket_update(opt, w, g, state, 1.0, seg=seg)
    if res is None:
        raise MXNetError(
            f"{op_name}: the bucket kernel cannot run this input "
            f"({reason or 'no kernel form for this bucket'}); use the "
            "plain op (_fused_bucket_*) instead")
    return res


@register_op("_pallas_bucket_sgd_mom_update", num_outputs=2,
             differentiable=False, platform_sensitive=True)
def pallas_bucket_sgd_mom_update(weight, grad, mom, *, lr, momentum=0.9,
                                 wd=0.0):
    """``_fused_bucket_sgd_mom_update`` through ``csrc/bucket_sgd.cu``."""
    opt = _mk_opt("sgd_mom", dict(lr=lr, momentum=momentum, wd=wd))
    new_w, (new_m,), _ = _op_bucket_update(
        "_pallas_bucket_sgd_mom_update", opt, weight, grad, (mom,))
    return new_w, new_m


@register_op("_pallas_bucket_adam_update", num_outputs=3,
             differentiable=False, platform_sensitive=True)
def pallas_bucket_adam_update(weight, grad, mean, var, *, lr, wd=0.0):
    """``_fused_bucket_adam_update`` (t = 1) through
    ``csrc/bucket_adam.cu``."""
    opt = _mk_opt("adam", dict(lr=lr, wd=wd))
    new_w, (new_m, new_v), _ = _op_bucket_update(
        "_pallas_bucket_adam_update", opt, weight, grad, (mean, var))
    return new_w, new_m, new_v


@register_op("_pallas_bucket_lars_update", num_outputs=2,
             differentiable=False, platform_sensitive=True)
def pallas_bucket_lars_update(weight, grad, mom, seg_ids, *, lr,
                              num_segments, momentum=0.9, wd=0.0):
    """``_fused_bucket_lars_update`` (eta 0.001, eps 0) through
    ``csrc/bucket_lars.cu``."""
    opt = _mk_opt("lars", dict(lr=lr, momentum=momentum, wd=wd))
    new_w, (new_m,), _ = _op_bucket_update(
        "_pallas_bucket_lars_update", opt, weight, grad, (mom,),
        seg=(seg_ids.to(torch.int32).contiguous(), int(num_segments)))
    return new_w, new_m
