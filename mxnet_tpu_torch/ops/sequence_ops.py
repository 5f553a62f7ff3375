"""Sequence ops: SequenceMask / SequenceLast / SequenceReverse
(counterpart of ``mxnet_tpu/ops/sequence_ops.py``).

Layout is the reference's: time-major (T, N, ...) with optional
per-batch lengths, truncated to int32.  Three of the reference's
behaviours are kept as it has them:

- ``SequenceReverse`` ignores ``axis`` and always flips axis 0;
- ``SequenceLast`` at length 0 takes index -1, the last step (a
  negative index wraps once, as jnp's gather wraps it);
- a position whose index falls outside the sequence (a length above T)
  takes jnp's fill value (NaN, or the integer type's extreme), as
  ``take_along_axis`` gives it.
"""
from __future__ import annotations

import torch

from .registry import register_op
from .shape_ops import _fill_index, _filled

__all__ = ["sequence_mask", "sequence_last", "sequence_reverse"]


def _lengths(seq_len):
    """The lengths as the reference reads them: truncated to int32."""
    return seq_len.to(torch.int32).to(torch.int64)


def _take_time(x, idx):
    """``take_along_axis(x, idx, axis=0)`` with jnp's fill mode: ``idx``
    (T', N) indexes axis 0 of ``x`` (T, N, ...)."""
    safe, valid = _fill_index(idx, x.shape[0])
    tail = (1,) * (x.dim() - 2)
    safe = safe.reshape(safe.shape + tail).expand(
        (safe.shape[0],) + x.shape[1:])
    valid = valid.reshape(valid.shape + tail)
    return _filled(torch.gather(x, 0, safe), valid, x.dtype)


@register_op("SequenceMask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    x = torch.swapaxes(data, 0, axis) if axis != 0 else data
    pos = torch.arange(x.shape[0], device=x.device)[:, None]
    m = pos < _lengths(sequence_length)[None, :]
    m = m.reshape(m.shape + (1,) * (x.dim() - 2))
    out = torch.where(m, x, torch.tensor(value, dtype=x.dtype,
                                         device=x.device))
    return torch.swapaxes(out, 0, axis) if axis != 0 else out


@register_op("SequenceLast")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    x = torch.swapaxes(data, 0, axis) if axis != 0 else data
    if not use_sequence_length or sequence_length is None:
        return x[-1]
    idx = (_lengths(sequence_length) - 1)[None, :]
    return _take_time(x, idx)[0]


@register_op("SequenceReverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    lens = _lengths(sequence_length)[None, :]
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    # within-length positions are mirrored, the rest stay in place
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    return _take_time(data, rev)
