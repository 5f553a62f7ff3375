"""The nearest-rank percentile of ``mxnet_tpu/telemetry/opstats.py``,
kept identical so TTFT percentiles mean the same in both packages."""
from __future__ import annotations

import math

__all__ = ["percentile"]


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list (q in [0, 1])."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return float(sorted_vals[rank - 1])
