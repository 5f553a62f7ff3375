"""Attention (counterpart of ``mxnet_tpu/ops/flash_attention.py``).

:func:`flash_attention` is the fused causal/non-causal attention the
generative server's prefill runs on every layer.  On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/flash_attention.cu``,
the port of the reference's Pallas ``_flash_kernel``; on a CPU tensor
it computes :func:`flash_attention_reference`, the plain PyTorch
version of the same math.  A CUDA tensor never falls back: the kernel
launches, or the wrapper raises.  The kernel has tiles for head dims 8,
16, 32, 64 and 128, and runs a depth that is a multiple of 128 in
128-wide slabs of the output (one CTA per slab, each summing Q K^T over
128-deep chunks).  Any other head_dim runs at the next of those depths,
q, k and v zero-padded (which adds exact zeros to every score) and the
output sliced back.  It has no backward yet, so on a CUDA tensor an
operand that requires grad raises rather than getting none.

:func:`paged_decode_attention` is the decode step's attention over the
paged KV cache.  It is plain ``jnp`` in the reference, so it is plain
PyTorch here, with both of its walks (``gather`` and ``paged``).
"""
from __future__ import annotations

import ctypes
import functools
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
#: the depths the kernel has tiles for; other head dims up to the last
#: pad to the next
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
#: a deeper head runs in slabs of this many output columns (the deepest
#: tiles), its depth padded to a multiple of it
_SLAB = _KERNEL_HEAD_DIMS[-1]
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
    if d < 1:
        raise MXNetError(f"flash_attention kernel takes head_dim >= 1, "
                         f"got {d}")
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
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise MXNetError("flash_attention kernel takes 16-byte aligned "
                         "operands (its cp.async copies need them); got a "
                         "view at an odd storage offset")


def _check_no_grad(q, k, v):
    """Raise where autograd would need the kernel's backward, which is
    not written yet: grad mode on and an operand that requires grad.
    Without this the output would carry no autograd node, and q, k and
    v would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise MXNetError("flash_attention's CUDA kernel has no backward "
                         "yet: call it under torch.no_grad() or on "
                         "operands that do not require grad, or ask for "
                         "the plain version with variant='naive'")


def _kernel_depth(d):
    """The kernel depth a head_dim of ``d`` runs at: the next depth with
    tiles up to 128, else the next multiple of 128."""
    if d > _SLAB:
        return -(-d // _SLAB) * _SLAB
    return next(x for x in _KERNEL_HEAD_DIMS if x >= d)


def _slabs(depth):
    """The output columns ``[(start, stop), ...]`` that the kernel's CTAs
    of one work item write at a kernel depth of ``depth``: one range up
    to 128, else one per 128-wide slab (the grid's second axis)."""
    width = min(depth, _SLAB)
    return [(c, c + width) for c in range(0, depth, width)]


def _pad_depth(x, depth):
    """``x`` zero-padded along its last axis to ``depth`` (contiguous)."""
    return torch.nn.functional.pad(x, (0, depth - x.shape[-1]))


@functools.cache
def _kernel():
    """The C entry points of ``csrc/flash_attention.cu``, built on first
    use: ``(mxt_flash_attention_fwd, mxt_flash_block_sizes)``."""
    from .. import _kernels

    lib = _kernels.load("flash_attention")
    fwd = lib.mxt_flash_attention_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    sizes = lib.mxt_flash_block_sizes
    sizes.restype = ctypes.c_int
    sizes.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)]
    return fwd, sizes


@functools.cache
def _block_sizes(code, head_dim):
    """(query rows, keys) per tile of the kernel for dtype ``code`` at a
    kernel depth of ``head_dim`` (the D = 128 tiles for every slab)."""
    bq, bk = ctypes.c_int(), ctypes.c_int()
    rc = _kernel()[1](code, head_dim, ctypes.byref(bq), ctypes.byref(bk))
    if rc != 0:
        raise MXNetError(f"flash_attention kernel has no tiles for dtype "
                         f"code {code}, head_dim {head_dim}")
    return bq.value, bk.value


def _split_plan(bh, sq, sk, causal, block_q, block_k, n_sm):
    """The kernel's work items: ``(items, ranges, split)``.

    Query tile ``qt`` sees key tiles ``[0, tiles[qt])`` (causal: up to
    the diagonal of its last row; a tile with no visible key has 0).
    Each q tile is one item unless ``bh`` times the q tiles is below
    ``n_sm``: then the key range of every q tile is cut into near-equal
    chunks of at most ``chunk`` tiles, each chunk an item that writes a
    partial for the combine kernel.  ``chunk`` is the one, among those
    giving at least ``n_sm`` CTAs, with the fewest waves of ``n_sm``
    CTAs times tiles per CTA (then the fewest items); 1 when none
    gives ``n_sm`` CTAs.  An item is ``(qt, kt0, kt1, slot)``, the slots
    of one q tile contiguous; items are ordered heaviest first
    (stable), which is the launch order.  ``ranges[qt]`` is ``(first
    slot, count)``; ``split`` says whether any q tile has more than one
    item."""
    n_qt = -(-sq // block_q)
    diag = sk - sq
    tiles = []
    for qt in range(n_qt):
        last = sk - 1
        if causal:
            last = min(last, min((qt + 1) * block_q, sq) - 1 + diag)
        tiles.append(last // block_k + 1 if last >= 0 else 0)

    def parts(t, c):
        return max(1, -(-t // c))

    chunk = max(max(tiles), 1)
    if bh * n_qt < n_sm:
        costs = []
        for c in range(1, chunk + 1):
            n_items = sum(parts(t, c) for t in tiles)
            if bh * n_items >= n_sm:
                longest = max(-(-t // parts(t, c)) for t in tiles)
                costs.append((-(-bh * n_items // n_sm) * longest, n_items,
                              c))
        chunk = min(costs)[2] if costs else 1
    items, ranges = [], []
    for qt, t in enumerate(tiles):
        n = parts(t, chunk)
        ranges.append((len(items), n))
        for p in range(n):
            items.append((qt, t * p // n, t * (p + 1) // n, len(items)))
    items.sort(key=lambda it: it[1] - it[2])
    return items, ranges, len(items) > n_qt


@functools.lru_cache(maxsize=1024)
def _plan_on(device, bh, sq, sk, causal, code, head_dim):
    """``(plan tensor on device, n_items, split, block_q)`` for a call at
    kernel depth ``head_dim``; the plan is int32 ``items`` rows then
    ``ranges`` rows, the kernel's layout.  Each item runs one CTA per
    batch*head and slab, so the split is planned over their product."""
    bq, bk = _block_sizes(code, head_dim)
    items, ranges, split = _split_plan(bh * len(_slabs(head_dim)), sq, sk,
                                       causal, bq, bk, _sm_count(device))
    flat = [x for it in items for x in it] + [x for r in ranges for x in r]
    plan = torch.tensor(flat, dtype=torch.int32, device=device)
    return plan, len(items), split, bq


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _flash_forward_cuda(q, k, v, causal, sm_scale):
    """Launch ``csrc/flash_attention.cu`` on the current stream of q's
    device; q/k/v are viewed as ``(batch*heads, seq, head_dim)``.  A
    head_dim the kernel does not take as it is runs at the next depth it
    takes (:func:`_kernel_depth`), zero-padded, and the output is sliced
    back."""
    _check_kernel_operands(q, k, v)
    _check_no_grad(q, k, v)
    b, h, sq, head_dim = q.shape
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    d = _kernel_depth(head_dim)
    if d != head_dim:
        q, k, v = (_pad_depth(t, d) for t in (q, k, v))
    code = _KERNEL_DTYPES[q.dtype]
    fwd = _kernel()[0]
    plan, n_items, split, bq = _plan_on(q.device, b * h, sq, sk,
                                        bool(causal), code, d)
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * n_items * bq * (d + 2),
                          dtype=torch.float32, device=q.device) \
        if split else None
    dev = q.device
    # the raw handle of the device's current stream, without building a
    # torch.cuda.Stream object
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, code, int(causal), float(sm_scale),
            plan.data_ptr(), n_items,
            None if scratch is None else scratch.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = fwd(*args)
    else:
        with torch.cuda.device(dev):
            rc = fwd(*args)
    if rc != 0:
        raise MXNetError(f"flash_attention kernel launch failed "
                         f"(cudaError_t {rc}) for q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}")
    with _count_lock:
        flash_attention.launches += 1
    return out if d == head_dim else out[..., :head_dim].contiguous()


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
    version runs whatever the variant.  The kernel takes any head_dim
    and, having no backward yet, raises on an operand that requires grad
    while grad mode is on.  ``sm_scale`` defaults to
    ``1/sqrt(head_dim)`` of the operands as given.
    ``flash_attention.launches`` counts kernel launches."""
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
