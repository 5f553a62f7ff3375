"""Dtype mapping and the reference's on-disk type flags (counterpart of
``mxnet_tpu/dtype.py``).

Type flag values mirror mshadow (3rdparty/mshadow/mshadow/base.h:307-314)
so ``.params`` files are bit-compatible with the reference.  bfloat16
and the float8 types have no flag: they are saved as float32.

``normalize_dtype`` takes a string, a numpy dtype or a ``torch.dtype``
and returns the ``torch.dtype``.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["TYPE_FLAG_TO_NP", "NP_TO_TYPE_FLAG", "normalize_dtype",
           "dtype_name", "to_numpy_dtype", "float8_supported",
           "attr_dtype_name"]

# mshadow type_flag <-> numpy dtype (base.h:307-314)
TYPE_FLAG_TO_NP = {
    0: onp.dtype("float32"),
    1: onp.dtype("float64"),
    2: onp.dtype("float16"),
    3: onp.dtype("uint8"),
    4: onp.dtype("int32"),
    5: onp.dtype("int8"),
    6: onp.dtype("int64"),
    7: onp.dtype("bool"),
}
NP_TO_TYPE_FLAG = {v: k for k, v in TYPE_FLAG_TO_NP.items()}

_STR_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    # fp8 spellings; bare "fp8"/"float8" means the forward/weight
    # format e4m3 (e5m2 is the gradient format and is always named)
    "fp8": "float8_e4m3fn",
    "float8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn",
    "fp8_e4m3": "float8_e4m3fn",
    "float8_e4m3": "float8_e4m3fn",
    "e5m2": "float8_e5m2",
    "fp8_e5m2": "float8_e5m2",
}

#: torch dtypes that numpy (without ml_dtypes) has no type for
_NO_NUMPY = {"bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
_TORCH_BY_NAME = dict(_NO_NUMPY, bool=torch.bool, uint8=torch.uint8,
                      int8=torch.int8, int16=torch.int16,
                      int32=torch.int32, int64=torch.int64,
                      uint16=torch.uint16, uint32=torch.uint32,
                      uint64=torch.uint64, float16=torch.float16,
                      float32=torch.float32, float64=torch.float64,
                      complex64=torch.complex64,
                      complex128=torch.complex128)
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}
_FLOAT8_NAMES = ("float8_e4m3fn", "float8_e5m2")


def float8_supported() -> bool:
    """True when this torch build carries the float8 types."""
    return all(hasattr(torch, n) for n in _FLOAT8_NAMES)


def _float8(name):
    """The torch float8 dtype, or a loud MXNetError (never a silent
    fp32 fallback) when this build lacks it."""
    if not float8_supported():
        raise MXNetError(
            f"dtype {name!r} requires float8 support, which this torch "
            f"build does not provide; use a torch with float8_e4m3fn/"
            f"float8_e5m2 or use bfloat16")
    return getattr(torch, name)


def normalize_dtype(dtype, default="float32") -> torch.dtype:
    """str / numpy dtype / torch dtype / None -> ``torch.dtype``."""
    if dtype is None:
        dtype = default
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAME_BY_TORCH:
            raise MXNetError(f"unsupported dtype {dtype}")
        return dtype
    if isinstance(dtype, str):
        dtype = _STR_ALIASES.get(dtype, dtype)
        if dtype in _FLOAT8_NAMES:
            return _float8(dtype)
        if dtype in _NO_NUMPY:
            return _NO_NUMPY[dtype]
    try:
        name = onp.dtype(dtype).name
    except TypeError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
    if name not in _TORCH_BY_NAME:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH_BY_NAME[name]


def dtype_name(dtype) -> str:
    return _NAME_BY_TORCH[normalize_dtype(dtype)]


def to_numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16 and float8 (which
    numpy lacks) give float32, their exact widening."""
    name = dtype_name(dtype)
    return onp.dtype("float32" if name in _NO_NUMPY else name)


def attr_dtype_name(value, default="float32"):
    """The dtype name a symbol variable's ``__dtype__`` attribute gives:
    a name (``int8``, as the port writes it) or an mshadow type flag
    (``"5"``, as upstream writes it); ``default`` for none or one this
    package cannot read."""
    if value is None:
        return default
    try:
        if str(value).isdigit():
            return dtype_name(TYPE_FLAG_TO_NP[int(value)])
        return dtype_name(value)
    except (KeyError, MXNetError):
        return default
