"""Shared foundations (counterpart of ``mxnet_tpu/base.py``): the
framework's error type and the scalar type tuples the front end
dispatches on."""
from __future__ import annotations

import numpy as onp

__all__ = ["MXNetError", "string_types", "numeric_types", "integer_types"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


string_types = (str,)
integer_types = (int, onp.integer)
numeric_types = (float, int, onp.generic)
