"""Ordering ops: sort / argsort / topk (counterpart of
``mxnet_tpu/ops/sort_ops.py``).

The orders are the reference's, tie for tie:

- ``sort`` and ``argsort`` are jnp's stable sort: -0 and +0 are equal,
  every NaN is equal to every other and after +inf; descending is the
  stable ascending order flipped, so among ties the highest index
  comes first.
- ``topk`` is ``lax.top_k``: a total order (-NaN < -inf < ... < -0 <
  +0 < ... < +inf < +NaN), ties lowest index first in both directions
  (ascending is ``top_k`` of the negation).

Both sort integer keys made from the values' bits, stably, so the
order does not depend on how a device's sort treats signed zeros and
NaNs.  No op reads a value on the host.
"""
from __future__ import annotations

import torch

from ..dtype import normalize_dtype
from .registry import register_op

__all__ = ["sort", "argsort", "topk", "stable_argsort"]

_INT_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
           torch.float32: torch.int32, torch.float64: torch.int64}


def _total_key(x):
    """Integers in the IEEE total order of ``x``'s values (bits with the
    magnitude bits of negative values flipped); integers stay as they
    are, bools become 0/1."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if not x.is_floating_point():
        return x
    bits = x.contiguous().view(_INT_OF[x.dtype])
    nbits = torch.iinfo(bits.dtype).bits
    return bits ^ ((bits >> (nbits - 1)) & torch.iinfo(bits.dtype).max)


def _sort_key(x):
    """jnp.sort's order as integers: the total order after -0 becomes +0
    and every NaN the canonical one."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full((), float("nan"),
                                                   dtype=x.dtype,
                                                   device=x.device), x + 0.0)
    return _total_key(x)


def stable_argsort(x, dim=-1):
    """``jnp.argsort(x, axis=dim)``: the stable ascending order (int64)."""
    return torch.sort(_sort_key(x), dim=dim, stable=True)[1]


def _flat(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@register_op("sort")
def sort(x, *, axis=-1, is_ascend=True):
    x, ax = _flat(x, axis)
    idx = stable_argsort(x, ax)
    if not is_ascend:
        idx = torch.flip(idx, dims=(ax,))
    return torch.gather(x, ax, idx)


@register_op("argsort", differentiable=False)
def argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    x, ax = _flat(x, axis)
    idx = stable_argsort(x, ax)
    if not is_ascend:
        idx = torch.flip(idx, dims=(ax,))
    return idx.to(normalize_dtype(dtype))


def _topk_nout(p):
    rt = p.get("ret_typ", "indices")
    return 2 if rt == "both" else 1


@register_op("topk", num_outputs=_topk_nout, differentiable=False)
def topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """``lax.top_k`` along ``axis`` (of ``-x`` when ascending): the
    first ``k`` of a stable descending sort of total-order keys."""
    dt = normalize_dtype(dtype)
    x, ax = _flat(x, axis)
    ax = ax % x.dim()
    key = _total_key(-x if is_ascend else x)
    idxs = torch.sort(key, dim=ax, descending=True, stable=True)[1]
    idxs = idxs.narrow(ax, 0, k)
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter_(ax, idxs, 1)
    vals = torch.gather(x, ax, idxs)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs.to(dt)
    return idxs.to(dt)
