"""int8 KV-cache quantization (counterpart of
``mxnet_tpu/quantization/kv.py``).

KV-cache pages stored int8 with one symmetric fp32 scale per
(token, head), along the head_dim axis one attention dot consumes.
The expressions follow the reference one for one — multiply by
``127/amax`` (never divide by the scale), round half to even, clip to
±127 — so the int8 values and scales agree bit for bit.
"""
from __future__ import annotations

import torch

from ..ops.quantization_ops import _INT8_RANGE, _minmax_scale

__all__ = ["kv_quantize", "kv_dequantize", "kv_page_bytes"]


def kv_quantize(x):
    """Symmetric int8 quantization of ``(..., head_dim)`` KV vectors.

    Returns ``(q, scale)``: ``q`` int8 with x ~= q * scale, ``scale``
    fp32 of shape ``x.shape[:-1]``.  An all-zero vector quantizes to
    zeros with scale 0 and round-trips exactly."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    inv, amax = _minmax_scale(-amax, amax)  # inv = 127/amax (1.0 at 0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(
        torch.int8)
    return q, amax / _INT8_RANGE


def kv_dequantize(q, scale):
    """Inverse of :func:`kv_quantize`: ``q * scale`` back to fp32."""
    return q.to(torch.float32) * scale[..., None].to(torch.float32)


def kv_page_bytes(layers, page_tokens, heads, head_dim, dtype):
    """Bytes one physical KV page costs in the given storage dtype.  K
    and V both stored; int8 carries one fp32 scale per (token, head)."""
    per_tok_head = {"int8": head_dim * 1 + 4,
                    "float32": head_dim * 4,
                    "bfloat16": head_dim * 2}.get(str(dtype))
    if per_tok_head is None:
        raise ValueError(f"unsupported KV-cache dtype {dtype!r}")
    return 2 * layers * page_tokens * heads * per_tok_head
