"""Generate ``mx.sym.<Op>`` functions from the registry (counterpart of
``mxnet_tpu/symbol/_op_namespace.py``).

Reference parity: python/mxnet/symbol/register.py generates Python source
per registered op at import time; here closures (the pattern of
:mod:`mxnet_tpu_torch.ndarray`).
"""
from __future__ import annotations

import inspect

from ..ops.registry import get_op, list_ops
from .symbol import Symbol, _make_op_symbol

__all__ = []


def _tensor_names(opdef):
    sig = inspect.signature(opdef.fn)
    names, variadic = [], False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD:
            names.append(p.name)
        elif p.kind is inspect.Parameter.VAR_POSITIONAL:
            variadic = True
    return names, variadic


def _make_sym_func(opname):
    opdef = get_op(opname)
    tnames, variadic = _tensor_names(opdef)

    def sym_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        inputs = list(args)
        # split kwargs into tensor inputs (by name) and hyper-params; every
        # hyper-param is kept as an attribute, as the reference keeps it
        named_inputs = {k: kwargs.pop(k) for k, v in list(kwargs.items())
                        if isinstance(v, Symbol)}
        attrs = dict(kwargs)
        if named_inputs and not variadic:
            # order named tensor inputs per signature
            merged = list(inputs)
            for tn in tnames[len(inputs):]:
                if tn in named_inputs:
                    merged.append(named_inputs.pop(tn))
            # common alias: 'data' as first input
            if named_inputs:
                for k in list(named_inputs):
                    merged.append(named_inputs.pop(k))
            inputs = merged
        elif named_inputs:
            inputs.extend(named_inputs.values())
        if not all(isinstance(s, Symbol) for s in inputs):
            raise TypeError(
                f"sym.{opname} inputs must be Symbols, got "
                f"{[type(s).__name__ for s in inputs]}")
        attrs = {k: v for k, v in attrs.items() if v is not None}
        return _make_op_symbol(opname, inputs, attrs, name)

    sym_func.__name__ = opname
    sym_func.__doc__ = opdef.doc
    return sym_func


# NOTE: an op is literally named "_mod" — assign via globals() so no
# module-alias variable can be shadowed by a generated function
def _expose_new_ops():
    """(Re)generate sym.<Op> functions — idempotent; called again by
    mx.library.load for plugin ops.  Also patches the parent package
    (mxnet_tpu_torch.symbol), whose star-import copy of this namespace was
    frozen at import time."""
    import sys

    pkg = sys.modules.get("mxnet_tpu_torch.symbol")
    for _name in list_ops():
        if _name not in globals():
            fn = _make_sym_func(_name)
            globals()[_name] = fn
            if pkg is not None and not hasattr(pkg, _name):
                setattr(pkg, _name, fn)


for _name in list_ops():
    _f = _make_sym_func(_name)
    globals()[_name] = _f
    __all__.append(_name)
