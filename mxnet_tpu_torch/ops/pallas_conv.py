"""Fused BatchNorm → ReLU → 1×1 convolution (counterpart of
``mxnet_tpu/ops/pallas_conv.py``).

ResNet bottlenecks chain ``y = conv1x1(relu(batchnorm(u)))`` with the
relu activation private to the conv.  :func:`fused_bn_relu_conv1x1`
computes it with batch statistics, channel-last, as a
``torch.autograd.Function`` whose backward runs pass 1 in one function
over (dy, u)::

    d_act   = dy @ W^T
    d_bnout = d_act * (bnout > 0)     (streamed out in the act dtype)
    dW      = relu(bnout)^T @ dy      (fp32)
    s1      = sum_rows d_bnout        (BatchNorm backward reduction)
    s2      = sum_rows d_bnout * xhat (BatchNorm backward reduction)

then pass 2, the elementwise BatchNorm input gradient, in plain
PyTorch (XLA fuses it in the reference).

Pass 1 is :func:`bnreluconv_bwd`: on a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/bnreluconv_bwd.cu``, the port of the
reference's Pallas ``_bwd_kernel``; on a CPU tensor it computes
:func:`_bwd_pass1_reference`, the plain twin of ``_bwd_pass1_jnp``.  A
CUDA tensor never falls back: the kernel launches or the wrapper
raises.  Which backward runs is the reference's ``pallas_bnreluconv``
decision (:func:`_use_pallas`).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..base import MXNetError
from ..telemetry import runlog as _runlog
from .nn import _bn_grad_sums, _bn_stats, _bn_stats_global, bn_group
from .registry import register_op

__all__ = ["enabled", "fused_bn_relu_conv1x1", "bn_relu_conv_op",
           "bnreluconv_bwd"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's tiles per dtype (``csrc/bnreluconv_bwd.cu``): rows of a
#: d_act block, (Ci, Co) of a dW tile, and the d_act Ci tile.  bf16 runs
#: on the tensor cores, fp32 on the CUDA cores
_TILES = {torch.bfloat16: dict(rows=128, ci=64, co=128, dact_ci=64),
          torch.float32: dict(rows=64, ci=64, co=64, dact_ci=64)}
#: a dW split's rows are a multiple of this (``kSplitAlign``)
_SPLIT_ALIGN = 32
#: CTAs the plan aims each pass at: two waves of three CTAs on each of an
#: H100's 132 SMs
_TARGET_CTAS = 2 * 3 * 132
#: fewest rows a dW split takes, so that a split's partial is worth its
#: write and its read in the reduce
_MIN_SPLIT_ROWS = 256
_count_lock = threading.Lock()


def enabled():
    """Is the fused block used by model code?  The ``pallas_bnreluconv``
    variant (``stock`` = the unfused layer path, ``jnp``/``pallas`` =
    the fused op with that backward) from a force scope,
    ``MXNET_BNRELUCONV_VARIANT`` or the cached per-shape winner of the
    in-step race that the entry points' ``program_scope`` applies, then
    ``MXNET_FUSED_BNRELUCONV`` (1 = fused), default off — the
    reference's order (``enabled``, ``mxnet_tpu/ops/pallas_conv.py:49``).
    Read on every call: toggle before the call, not inside it."""
    from ..autotune import variant_choice

    choice = variant_choice("pallas_bnreluconv")
    if choice in ("jnp", "pallas", True):
        return True
    if choice in ("stock", False):
        return False
    env = os.environ.get("MXNET_FUSED_BNRELUCONV")
    if env is not None:
        return env == "1"
    return False


def _use_pallas(x):
    """Kernel backward or plain backward for a fused block on ``x``:
    ``MXNET_PALLAS=0`` never, ``=1`` wherever the kernel can run (a
    CUDA tensor), else the ``pallas_bnreluconv`` variant (a force scope,
    the env override or a winner applied by ``program_scope``), else
    the kernel on a CUDA tensor (the reference's ``_use_pallas``).  On a
    CPU tensor the kernel arm computes the plain version, as the
    reference runs its kernel in interpret mode off the TPU."""
    env = os.environ.get("MXNET_PALLAS")
    if env == "0":
        return False
    feasible = x.device.type == "cuda"
    if env == "1":
        return feasible
    from ..autotune import variant_choice

    choice = variant_choice("pallas_bnreluconv")
    if choice is not None:
        return choice in ("pallas", True)
    return feasible


# ------------------------------------------------------------ pass 1
def _bwd_pass1_reference(dy, u, w2, g, b, mu, inv):
    """Plain PyTorch pass 1 (``_bwd_pass1_jnp``): dy [M, Co], u [M, Ci]
    in the act dtype, w2 [Ci, Co], g/b/mu/inv [1, Ci] fp32.  Products of
    act-dtype values accumulate in fp32."""
    u32 = u.to(torch.float32)
    bnout = u32 * g + b
    act = bnout.to(dy.dtype)
    mask = act.to(torch.float32) > 0.0
    d_act = dy.to(torch.float32) @ w2.to(torch.float32).t()
    d_bnout32 = torch.where(mask, d_act, 0.0)
    relu_act = torch.where(mask, act, torch.zeros_like(act))
    dw = relu_act.to(torch.float32).t() @ dy.to(torch.float32)
    xhat = (u32 - mu) * inv
    s1 = d_bnout32.sum(dim=0, keepdim=True)
    s2 = (d_bnout32 * xhat).sum(dim=0, keepdim=True)
    return d_bnout32.to(dy.dtype), dw, s1, s2


def _split_rows(m, splits):
    """Rows per dW split, as the kernel computes them (``split_rows``):
    split ``s`` covers ``[s * rows, (s + 1) * rows)`` clipped to M."""
    rows = -(-m // splits)
    return -(-rows // _SPLIT_ALIGN) * _SPLIT_ALIGN


def _group_blocks(n_blocks, groups):
    """Row blocks per d_act group, as the kernel computes them: group
    ``g`` walks blocks ``[g * per, (g + 1) * per)`` clipped to the
    count."""
    return -(-n_blocks // groups)


def _bwd_plan(m, ci, co, dtype):
    """(row groups of the d_act pass, M splits of the dW pass) for the
    kernel's ``dtype`` tiles: about ``_TARGET_CTAS`` CTAs in each pass,
    no split under ``_MIN_SPLIT_ROWS`` rows, and neither a group nor a
    split left without rows (each is trimmed to the count its share
    needs, which sizes the scratch exactly)."""
    t = _TILES[dtype]
    n_blocks = -(-m // t["rows"])
    dact_tiles = -(-ci // t["dact_ci"])
    groups = max(1, min(n_blocks, -(-_TARGET_CTAS // dact_tiles)))
    groups = -(-n_blocks // _group_blocks(n_blocks, groups))
    dw_tiles = -(-ci // t["ci"]) * -(-co // t["co"])
    splits = max(1, min(-(-m // _MIN_SPLIT_ROWS),
                        -(-_TARGET_CTAS // dw_tiles)))
    splits = -(-m // _split_rows(m, splits))
    return groups, splits


def _check_operands(dy, u, w2, vecs):
    if dy.dim() != 2 or u.dim() != 2 or w2.dim() != 2:
        raise MXNetError("bnreluconv_bwd takes dy [M, Co], u [M, Ci], "
                         "w2 [Ci, Co]")
    m, co = dy.shape
    ci = u.shape[1]
    if u.shape[0] != m or tuple(w2.shape) != (ci, co) or m == 0:
        raise MXNetError(f"bnreluconv_bwd shapes disagree: dy "
                         f"{tuple(dy.shape)}, u {tuple(u.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    if dy.dtype not in _KERNEL_DTYPES or u.dtype != dy.dtype or \
            w2.dtype != dy.dtype:
        raise MXNetError(f"bnreluconv_bwd kernel takes float32 or "
                         f"bfloat16 dy/u/w2 of one dtype, got "
                         f"{dy.dtype}/{u.dtype}/{w2.dtype}")
    for v in vecs:
        if v.dtype != torch.float32 or v.numel() != ci or \
                not v.is_contiguous():
            raise MXNetError("bnreluconv_bwd takes contiguous float32 "
                             f"per-channel vectors of {ci}, got "
                             f"{v.dtype} {tuple(v.shape)}")
    for t in (u, w2, *vecs):
        if t.device != dy.device:
            raise MXNetError(f"bnreluconv_bwd operands on several "
                             f"devices: {dy.device}, {t.device}")
    if not (dy.is_contiguous() and u.is_contiguous() and
            w2.t().is_contiguous()):
        raise MXNetError("bnreluconv_bwd kernel takes contiguous dy and "
                         "u, and w2 as the transpose of a contiguous "
                         "[Co, Ci] weight")


def _bwd_pass1_cuda(dy, u, w2, g, b, mu, inv):
    """Launch ``csrc/bnreluconv_bwd.cu`` on the current stream of dy's
    device."""
    from .. import _kernels

    _check_operands(dy, u, w2, (g, b, mu, inv))
    m, co = dy.shape
    ci = u.shape[1]
    groups, splits = _bwd_plan(m, ci, co, dy.dtype)
    fn = _kernels.load("bnreluconv_bwd").mxt_bnreluconv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    f32 = dict(dtype=torch.float32, device=dy.device)
    d_bn = torch.empty_like(u)
    dw = torch.empty((ci, co), **f32)
    s = torch.empty((2, ci), **f32)
    s_part = torch.empty((2, groups, ci), **f32)
    dw_part = torch.empty((splits, ci, co), **f32)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        rc = fn(dy.data_ptr(), u.data_ptr(), w2.t().data_ptr(),
                g.data_ptr(), b.data_ptr(), mu.data_ptr(), inv.data_ptr(),
                d_bn.data_ptr(), dw.data_ptr(), s.data_ptr(),
                s_part.data_ptr(), dw_part.data_ptr(), m, ci, co, groups,
                splits, _KERNEL_DTYPES[dy.dtype], stream)
    if rc != 0:
        raise MXNetError(f"bnreluconv_bwd kernel launch failed "
                         f"(cudaError_t {rc}) for M={m} Ci={ci} Co={co} "
                         f"{dy.dtype}")
    with _count_lock:
        bnreluconv_bwd.launches += 1
    # the plain version's two products, d_act = dy·Wᵀ and dW = uᵀ·dy,
    # for a program report (FlopCounterMode cannot see a ctypes launch)
    _runlog.kernel_flops(4 * m * ci * co)
    return d_bn, dw, s[0:1], s[1:2]


def bnreluconv_bwd(dy, u, w2, g, b, mu, inv):
    """Pass 1 of the fused block's backward: ``(d_bnout, dW, s1, s2)``.
    On a CUDA tensor it launches the kernel (or raises); on a CPU tensor
    it computes the plain version.  ``bnreluconv_bwd.launches`` counts
    kernel launches."""
    if dy.device.type == "cpu":
        return _bwd_pass1_reference(dy, u, w2, g, b, mu, inv)
    return _bwd_pass1_cuda(dy, u, w2, g, b, mu, inv)


bnreluconv_bwd.launches = 0


# ------------------------------------------------------------ composite
def _fwd_math(u2, gamma, beta, w2, eps, fix_gamma, ex=None):
    """The forward on the [M, Ci] view; ``ex``: the global batch's
    statistics over its processes (``nn.bn_group_scope``), whose count
    is returned last (None without)."""
    n = None
    if ex is None:
        mean, var = _bn_stats(u2, 1)
    else:
        mean, var, n = _bn_stats_global(u2, 1, ex)
    inv = torch.rsqrt(var + eps)
    g32 = torch.ones_like(inv) if fix_gamma else gamma.to(torch.float32)
    scale = inv * g32
    shift = beta.to(torch.float32) - mean * scale
    u32 = u2.to(torch.float32)
    # cast THEN relu, matching the BatchNorm-layer + Activation path
    act = torch.clamp_min((u32 * scale + shift).to(u2.dtype), 0.0)
    return act @ w2, mean, var, inv, scale, shift, n


class _BNReluConv1x1(torch.autograd.Function):
    """``conv1x1(relu(batchnorm(u2)))`` on the [M, Ci] view; returns
    (y [M, Co], batch_mean, batch_var).

    Which pass 1 the backward runs is decided here, in the forward's
    thread and scope, as the reference decides it while it traces the
    step: the autograd engine runs a CUDA backward on a thread of its
    own, where an ``autotune.force`` scope of the caller does not hold.
    ``kernel`` True takes :func:`bnreluconv_bwd` whatever
    :func:`_use_pallas` says (the kernel on a CUDA tensor, its plain
    version on a CPU one)."""

    @staticmethod
    def forward(ctx, u2, gamma, beta, w2, eps, fix_gamma, kernel=False):
        ctx.ex = bn_group()
        y, mean, var, inv, scale, shift, ctx.n = _fwd_math(
            u2, gamma, beta, w2, eps, fix_gamma, ctx.ex)
        ctx.save_for_backward(u2, gamma, w2, mean, inv, scale, shift)
        ctx.fix_gamma = fix_gamma
        ctx.kernel = kernel or _use_pallas(u2)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        u2, gamma, w2, mean, inv, scale, shift = ctx.saved_tensors
        m = u2.shape[0]
        if dy is None:
            dy = torch.zeros((m, w2.shape[1]), dtype=u2.dtype,
                             device=u2.device)
        dy = dy.contiguous()
        g = scale.reshape(1, -1)
        b = shift.reshape(1, -1)
        mu = mean.reshape(1, -1)
        iv = inv.reshape(1, -1)
        pass1 = bnreluconv_bwd if ctx.kernel else _bwd_pass1_reference
        d_bnout, dw, s1, s2 = pass1(dy, u2, w2, g, b, mu, iv)
        s1 = s1.reshape(-1)
        s2 = s2.reshape(-1)
        # the global batch's sums for the input gradient; dgamma/dbeta
        # stay this process's (the step all-reduces them)
        gs1, gs2 = s1, s2
        if ctx.ex is not None:
            m = ctx.n
            gs1, gs2, dmean_ct, dvar_ct = _bn_grad_sums(
                ctx.ex, (s1, s2, dmean_ct, dvar_ct))
        # pass 2: the elementwise BatchNorm input gradient
        u32 = u2.to(torch.float32)
        xhat = (u32 - mu) * iv
        du32 = g * (d_bnout.to(torch.float32)
                    - (gs1 / m).reshape(1, -1)
                    - xhat * (gs2 / m).reshape(1, -1))
        if dmean_ct is not None:
            du32 = du32 + (dmean_ct / m).reshape(1, -1)
        if dvar_ct is not None:
            du32 = du32 + (dvar_ct * 2.0 / m).reshape(1, -1) * (u32 - mu)
        dgamma = torch.zeros_like(gamma) if ctx.fix_gamma \
            else s2.to(gamma.dtype)
        dbeta = s1.to(gamma.dtype)
        # dW accumulates in fp32 and takes the weight's dtype
        return (du32.to(u2.dtype), dgamma, dbeta, dw.to(w2.dtype), None,
                None, None)


def fused_bn_relu_conv1x1(u, gamma, beta, weight, *, eps=1e-5,
                          fix_gamma=False):
    """``conv1x1(relu(batchnorm(u)))`` with batch statistics,
    channel-last.

    u: [N, *spatial, Ci]; weight: [Co, *(1,)*nd, Ci] (``O*kI``).
    Returns (y [N, *spatial, Co], batch_mean [Ci], batch_var [Ci]); the
    caller folds the batch statistics into its running averages like
    the BatchNorm layer."""
    return _fused(u, gamma, beta, weight, eps, fix_gamma, kernel=False)


@register_op("_contrib_BNReluConv", num_outputs=3, platform_sensitive=True)
def bn_relu_conv_op(u, gamma, beta, weight, *, eps=1e-5, fix_gamma=False):
    """The fused block as an op, reachable as ``mx.nd._contrib_BNReluConv``
    and ``mx.sym._contrib_BNReluConv`` (reference
    ``mxnet_tpu/ops/pallas_conv.py:396``).  Its backward's pass 1 is
    always :func:`bnreluconv_bwd`: the kernel on a CUDA tensor, never
    the plain version there."""
    return _fused(u, gamma, beta, weight, eps, fix_gamma, kernel=True)


def _fused(u, gamma, beta, weight, eps, fix_gamma, kernel):
    ci = u.shape[-1]
    co = weight.shape[0]
    lead = tuple(u.shape[:-1])
    u2 = u.reshape(-1, ci)
    w2 = weight.reshape(co, ci)
    # the kernel contracts over Co: pass W as [Ci, Co]
    y2, mean, var = _BNReluConv1x1.apply(u2, gamma, beta, w2.t(),
                                         float(eps), bool(fix_gamma), kernel)
    return y2.reshape(lead + (co,)), mean, var
