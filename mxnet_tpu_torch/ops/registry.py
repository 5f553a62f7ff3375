"""Declarative operator registry (counterpart of
``mxnet_tpu/ops/registry.py``, the analog of NNVM op registration).

An op is a function on ``torch.Tensor``s: positional (or ``*args``)
parameters are its tensor inputs, keyword-only parameters its
hyper-parameters.  Shape and dtype inference is the function itself,
and its gradient is ``torch.autograd``'s.  The registry feeds the
generated ``mx.nd`` namespace (:mod:`mxnet_tpu_torch.ndarray`) and
``mx.library.load``.

An op named in one of AMP's policy lists (``contrib/amp/lists.py``)
casts its floating inputs while ``amp.init`` is on: the function the
decorator returns (and the registry holds) applies the policy, so a
Gluon layer calling it directly is cast as ``nd.invoke`` is.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

from ..base import MXNetError
from ..contrib import amp as _amp

__all__ = ["OpDef", "register_op", "get_op", "list_ops", "alias_op"]

_OPS: dict[str, "OpDef"] = {}


@dataclasses.dataclass
class OpDef:
    """One operator.

    fn: function (tensors in, a tensor or a tuple out); keyword-only
        arguments are the op's hyper-parameters.
    num_outputs: static output count, or a callable(params)->int for ops
        whose arity depends on hyper-params (e.g. split).
    differentiable: False for ops with no meaningful gradient (argmax,
        comparisons); their outputs are constants to autograd.
    key_param / train_param / platform_sensitive: kept from the
        reference's registry; ``key_param`` is injected with the
        ``torch.Generator`` the op draws from (``_rng.take_key``),
        ``train_param`` with ``autograd.is_training()``;
        ``platform_sensitive`` waits for the kernel-racing ops.
    """

    name: str
    fn: Callable
    num_outputs: object = 1
    differentiable: bool = True
    key_param: Optional[str] = None
    train_param: Optional[str] = None
    platform_sensitive: bool = False
    doc: str = ""

    def out_count(self, params) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    @property
    def param_names(self):
        sig = inspect.signature(self.fn)
        return [p.name for p in sig.parameters.values()
                if p.kind is inspect.Parameter.KEYWORD_ONLY]


def register_op(name=None, *, aliases=(), num_outputs=1, differentiable=True,
                key_param=None, train_param=None, platform_sensitive=False):
    """Decorator: register a tensor function as an operator."""

    def _do(fn):
        opname = name or fn.__name__
        if opname in _amp.POLICY_OPS:
            fn = _with_amp(opname, fn)
        op = OpDef(name=opname, fn=fn, num_outputs=num_outputs,
                   differentiable=differentiable, key_param=key_param,
                   train_param=train_param,
                   platform_sensitive=platform_sensitive,
                   doc=fn.__doc__ or "")
        if opname in _OPS:
            raise MXNetError(f"duplicate op registration: {opname}")
        _OPS[opname] = op
        for a in aliases:
            _OPS[a] = op
        return fn

    return _do


def _with_amp(opname, fn):
    """``fn`` with AMP's cast of its inputs while AMP is on."""

    @functools.wraps(fn)
    def op(*inputs, **params):
        if _amp.is_active():
            inputs = _amp.cast_inputs(opname, inputs)
        return fn(*inputs, **params)

    return op


def alias_op(existing: str, *aliases: str):
    op = get_op(existing)
    for a in aliases:
        _OPS[a] = op


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"operator '{name}' not registered") from None


def list_ops():
    return sorted(_OPS)
