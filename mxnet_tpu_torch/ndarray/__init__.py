"""``mx.nd`` — the eager op namespace, generated from the registry
(counterpart of ``mxnet_tpu/ndarray/__init__.py``).

Every registered op becomes a module-level function taking positional
NDArray inputs plus hyper-parameter kwargs, like the reference's
generated wrappers (python/mxnet/ndarray/register.py:116).  Ops that
``mx.library.load`` registers later are added by
:func:`_expose_new_ops`.
"""
from __future__ import annotations

import inspect
import sys
import types

import numpy as _onp

from ..ops import collective_ops as _collective_ops  # noqa: F401
from ..ops import contrib_ops as _contrib_ops  # noqa: F401  (registers ops)
from ..ops import conv as _conv  # noqa: F401
from ..ops import detection_ops as _detection_ops  # noqa: F401
from ..ops import elemwise as _elemwise  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import pallas_opt as _pallas_opt  # noqa: F401
from ..ops import pallas_conv as _pallas_conv  # noqa: F401
from ..ops import quantization_ops as _quantization_ops  # noqa: F401
from ..ops import random_ops as _random_ops  # noqa: F401
from ..ops import reduce as _reduce  # noqa: F401
from ..ops import rnn as _rnn  # noqa: F401
from ..ops import sequence_ops as _sequence_ops  # noqa: F401
from ..ops import shape_ops as _shape_ops  # noqa: F401
from ..ops import sort_ops as _sort_ops  # noqa: F401
from ..ops.registry import get_op, list_ops
from .ndarray import (  # noqa: F401
    NDArray,
    arange,
    array,
    concat,
    concatenate,
    empty,
    eye,
    full,
    invoke,
    linspace,
    load,
    load_buffer,
    ones,
    ones_like,
    save,
    save_buffer,
    split,
    stack,
    waitall,
    zeros,
    zeros_like,
)


def _kw_names(opdef):
    return [p.name for p in inspect.signature(opdef.fn).parameters.values()
            if p.kind is inspect.Parameter.KEYWORD_ONLY]


def _tensor_names(opdef):
    sig = inspect.signature(opdef.fn)
    names, variadic = [], False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD:
            names.append(p.name)
        elif p.kind is inspect.Parameter.VAR_POSITIONAL:
            variadic = True
    return names, variadic


def _make_op_func(opdef, name):
    tnames, variadic = _tensor_names(opdef)
    kw_names = _kw_names(opdef)

    def f(*args, out=None, **kwargs):
        args = list(args)
        if args and isinstance(args[0], (list, tuple)) and variadic:
            args = list(args[0]) + args[1:]
        inputs, ki = [], 0
        for a in args:
            if isinstance(a, (NDArray, _onp.ndarray)) or (
                variadic and not isinstance(a, (int, float, str, bool))
            ):
                inputs.append(a)
            else:
                # positional hyper-param (reference generated wrappers
                # accept params positionally after the tensor inputs)
                while ki < len(kw_names) and kw_names[ki] in kwargs:
                    ki += 1
                kwargs[kw_names[ki]] = a
                ki += 1
        if not variadic:
            for tn in tnames[len(inputs):]:
                if tn in kwargs:
                    inputs.append(kwargs.pop(tn))
                else:
                    break
        return invoke(opdef, inputs, out=out, **kwargs)

    f.__name__ = name
    f.__qualname__ = name
    f.__doc__ = opdef.doc or f"Operator {name} (see ops registry)."
    return f


_this = sys.modules[__name__]
op = types.ModuleType(__name__ + ".op")
_internal = types.ModuleType(__name__ + "._internal")
sys.modules[op.__name__] = op
sys.modules[_internal.__name__] = _internal


def _expose_new_ops():
    """Generate a wrapper for every registered op that has none yet
    (all of them at import; after ``mx.library.load`` the new ones):
    existing wrapper objects stay stable."""
    for name in list_ops():
        if not name.isidentifier() or hasattr(op, name):
            continue
        fn = _make_op_func(get_op(name), name)
        setattr(op, name, fn)
        if name.startswith("_"):
            setattr(_internal, name, fn)
        if not hasattr(_this, name):
            setattr(_this, name, fn)


_expose_all = _expose_new_ops
_expose_all()


# ---------------------------------------------------------------- methods
#: the reference's method list (mxnet_tpu/ndarray/__init__.py)
_METHOD_OPS = [
    "sum", "nansum", "mean", "max", "min", "prod", "nanprod", "argmax",
    "argmin", "norm", "abs", "sign", "round", "rint", "fix", "floor",
    "ceil", "trunc", "sqrt", "rsqrt", "cbrt", "rcbrt", "square", "exp",
    "log", "log10", "log2", "log1p", "expm1", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "degrees", "radians", "reciprocal", "sigmoid",
    "relu", "softmax", "log_softmax", "clip", "expand_dims", "squeeze",
    "take", "pick", "one_hot", "topk", "sort", "argsort", "broadcast_to",
    "broadcast_like", "tile", "repeat", "pad", "flip", "slice_axis",
    "slice_like", "swapaxes", "split", "flatten", "diag",
]


def _make_method(opname):
    opdef = get_op(opname)
    kw_names = _kw_names(opdef)

    def m(self, *args, **kwargs):
        inputs = [self]
        ai = 0
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            else:
                kwargs[kw_names[ai]] = a
                ai += 1
        return invoke(opdef, inputs, **kwargs)

    m.__name__ = opname
    return m


_registered = set(list_ops())
for _name in _METHOD_OPS:
    if _name in _registered and not hasattr(NDArray, _name):
        setattr(NDArray, _name, _make_method(_name))


def _nd_transpose(self, *axes, **kwargs):
    kw_axes = kwargs.pop("axes", None)
    if kwargs:
        raise TypeError(
            f"transpose() got unexpected keyword arguments "
            f"{sorted(kwargs)}")
    if kw_axes is not None:  # reference kwarg form
        axes = tuple(kw_axes)
    elif len(axes) == 1 and isinstance(axes[0], (list, tuple)):
        axes = tuple(axes[0])
    return invoke("transpose", [self], axes=axes or None)


NDArray.transpose = _nd_transpose


from . import contrib  # noqa: E402,F401
from . import random  # noqa: E402,F401
