"""Attention (counterpart of ``mxnet_tpu/ops/flash_attention.py``).

:func:`flash_attention` is the fused causal/non-causal attention the
generative server's prefill runs on every layer.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/flash_attention.cu``,
the port of the reference's Pallas ``_flash_kernel``; on a CPU tensor
it computes :func:`flash_attention_reference`, the plain PyTorch
version of the same math.  A CUDA tensor never falls back: the kernel
launches, or the wrapper raises.

:func:`paged_decode_attention` is the decode step's attention over the
paged KV cache.  It is plain ``jnp`` in the reference, so it is plain
PyTorch here, with both of its walks (``gather`` and ``paged``).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_reference",
           "paged_decode_attention"]

#: the reference's variant names.  ``naive`` is the plain version; the
#: three kernel variants (block sizes and the padding shim on the TPU)
#: all mean the one hand-written kernel on a CUDA tensor
_VARIANTS = ("naive", "pallas", "pallas_b256", "pallas_pad")
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def flash_attention_reference(q, k, v, causal=False, sm_scale=None,
                              kv_valid=None, q_valid=None):
    """Masked softmax attention in fp32 over ``(batch, heads, seq,
    head_dim)``, the math of the reference's ``_naive_attention``.

    Causal masking keeps key j for query i when ``j <= i + (eff_k -
    eff_q)`` (bottom-right alignment), the effective lengths being
    ``kv_valid``/``q_valid`` where given (the padding-shim contract),
    and keys at or past ``kv_valid`` never score.  A fully masked row
    is exactly 0, as in the kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    qlen, klen = s.shape[-2], s.shape[-1]
    kpos = torch.arange(klen, device=s.device)
    keep = torch.ones((qlen, klen), dtype=torch.bool, device=s.device)
    if causal:
        eff_k = klen if kv_valid is None else kv_valid
        eff_q = qlen if q_valid is None else q_valid
        qpos = torch.arange(qlen, device=s.device)
        keep = kpos[None, :] <= qpos[:, None] + (eff_k - eff_q)
    if kv_valid is not None and kv_valid < klen:
        keep = keep & (kpos < kv_valid)[None, :]
    s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, dim=-1)
    # a fully masked row softmaxes to NaN; zero it the way the kernel's
    # l = 0 guard does
    p = torch.where(keep.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _check_kernel_operands(q, k, v):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention takes (batch, heads, seq, "
                         "head_dim) operands")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise MXNetError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise MXNetError(f"flash_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError(f"flash_attention kernel takes float32 or "
                         f"bfloat16 operands of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise MXNetError(f"flash_attention operands on several devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and
            v.is_contiguous()):
        raise MXNetError("flash_attention kernel takes contiguous "
                         "operands")
    if q.numel() == 0 or k.numel() == 0:
        raise MXNetError("flash_attention kernel takes non-empty "
                         "operands")


def _flash_forward_cuda(q, k, v, causal, sm_scale):
    """Launch ``csrc/flash_attention.cu`` on the current stream of q's
    device; q/k/v are viewed as ``(batch*heads, seq, head_dim)``."""
    from .. import _kernels

    _check_kernel_operands(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    fn = _kernels.load("flash_attention").mxt_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, sq, sk, d, _KERNEL_DTYPES[q.dtype], int(causal),
                float(sm_scale), stream)
    if rc != 0:
        raise MXNetError(f"flash_attention kernel launch failed "
                         f"(cudaError_t {rc}) for q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}")
    with _count_lock:
        flash_attention.launches += 1
    return out


def _resolve_variant(variant):
    """Explicit argument > the autotune decision (force scope, then
    ``MXNET_FLASH_ATTENTION``) > the kernel."""
    if variant is None:
        from ..autotune import variant_choice

        variant = variant_choice("flash_attention", default="pallas")
    if variant not in _VARIANTS:
        raise MXNetError(f"unknown flash_attention variant {variant!r} "
                         f"(one of {_VARIANTS})")
    return variant


def flash_attention(q, k, v, causal=False, sm_scale=None, variant=None):
    """Fused attention over ``(batch, heads, seq, head_dim)`` operands.

    On a CUDA tensor every kernel variant (``pallas``, ``pallas_b256``,
    ``pallas_pad``, or None) launches the hand-written kernel and
    ``naive`` computes the plain version; on a CPU tensor the plain
    version runs whatever the variant.  ``flash_attention.launches``
    counts kernel launches."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    variant = _resolve_variant(variant)
    if q.device.type == "cpu" or variant == "naive":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    return _flash_forward_cuda(q, k, v, causal, sm_scale)


flash_attention.launches = 0


def _resolve_paged_variant(variant):
    if variant is None:
        from ..autotune import variant_choice

        variant = variant_choice("paged_decode_attention",
                                 default="gather")
    if variant not in ("gather", "paged"):
        raise MXNetError(f"unknown paged_decode_attention variant "
                         f"{variant!r} (gather or paged)")
    return variant


def _dequant_block(blk, scale):
    """fp32 view of a gathered KV block; ``scale`` is the int8 cache's
    per-(token, head) factor, None for a float pool."""
    if scale is None:
        return blk.to(torch.float32)
    return blk.to(torch.float32) * scale.to(torch.float32)[..., None]


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens,
                           sm_scale=None, k_scale=None, v_scale=None,
                           variant=None):
    """Single-token decode attention over a paged KV cache.

    Operands::

      q          (slots, heads, head_dim)   one query token per slot
      k_pages    (pages, page_tokens, heads, head_dim)  physical pool
      v_pages    (pages, page_tokens, heads, head_dim)
      page_table (slots, max_pages) integer  logical -> physical pages
      seq_lens   (slots,) integer           valid tokens per slot

    ``k_scale``/``v_scale`` (pages, page_tokens, heads) mark an int8
    pool, dequantized after the gather.  A slot with seq_len 0 is
    inactive: every key masks out and its output row is exactly zero.
    ``gather`` materializes each slot's K/V with one indexed gather,
    ``paged`` walks the page list with an online-softmax accumulator;
    both are exact."""
    slots, heads, head_dim = q.shape
    page_tokens = k_pages.shape[1]
    max_pages = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    variant = _resolve_paged_variant(variant)
    qf = q.to(torch.float32)
    page_table = page_table.long()
    lens = seq_lens.long()[:, None, None]
    neg_inf = torch.tensor(-math.inf, device=q.device)
    zero = torch.tensor(0.0, device=q.device)

    if variant == "paged":
        m = torch.full((slots, heads), -math.inf, device=q.device)
        l = torch.zeros((slots, heads), device=q.device)
        acc = torch.zeros((slots, heads, head_dim), device=q.device)
        tok = torch.arange(page_tokens, device=q.device)
        for i in range(max_pages):
            phys = page_table[:, i]
            k_blk = _dequant_block(
                k_pages[phys], None if k_scale is None else k_scale[phys])
            v_blk = _dequant_block(
                v_pages[phys], None if v_scale is None else v_scale[phys])
            s = torch.einsum("shd,sthd->sht", qf, k_blk) * sm_scale
            pos = i * page_tokens + tok
            s = torch.where(pos[None, None, :] < lens, s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, zero)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                zero)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + \
                torch.einsum("sht,sthd->shd", p, v_blk)
            m = m_new
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    k = _dequant_block(
        k_pages[page_table],
        None if k_scale is None else k_scale[page_table])
    v = _dequant_block(
        v_pages[page_table],
        None if v_scale is None else v_scale[page_table])
    total = max_pages * page_tokens
    k = k.reshape(slots, total, heads, head_dim)
    v = v.reshape(slots, total, heads, head_dim)
    s = torch.einsum("shd,sthd->sht", qf, k) * sm_scale
    pos = torch.arange(total, device=q.device)
    s = torch.where(pos[None, None, :] < lens, s, neg_inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, zero)
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, zero)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("sht,sthd->shd", p, v) / torch.clamp(
        l[..., 0], min=1e-30)[..., None]
    return out.to(q.dtype)
