"""Shared foundations (counterpart of ``mxnet_tpu/base.py``): the
framework's error type."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""
