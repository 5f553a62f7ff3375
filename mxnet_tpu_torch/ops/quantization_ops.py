"""The int8 range convention of ``mxnet_tpu/ops/quantization_ops.py``
(``_INT8_RANGE`` and ``_minmax_scale``), the part the KV-cache
quantizer shares."""
from __future__ import annotations

import torch

_INT8_RANGE = 127.0


def _minmax_scale(mn, mx):
    """``(127/amax, amax)`` with ``amax = max(|mn|, |mx|)``; the factor
    is 1.0 where amax is 0."""
    amax = torch.maximum(mn.abs(), mx.abs())
    return (torch.where(amax > 0, _INT8_RANGE / amax,
                        torch.ones_like(amax)), amax)
