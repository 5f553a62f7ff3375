"""Imperative autograd (counterpart of ``mxnet_tpu/autograd.py``) on
``torch.autograd``, with MXNet's semantics.

- Nothing is taped outside ``record()``: the dispatcher runs each op
  under ``torch.set_grad_enabled(is_recording())``.
- A variable (``attach_grad``/``mark_variables``) holds a leaf tensor
  that requires grad.  ``backward`` asks ``torch.autograd.grad`` for the
  gradient of every live variable and writes it into the variable's
  ``.grad`` by its ``grad_req``: ``write`` replaces, ``add``
  accumulates, ``null`` leaves nothing.  Torch's own ``.grad``, which
  only accumulates, is never used.
- ``head_grads`` default to ones.  Without ``retain_graph`` a backward
  releases the graph: a second backward from the same head raises, as
  the reference's does.
- ``is_training()`` is separate from recording (``train_mode``,
  ``predict_mode``).

The reference keeps its own tape of VJP closures
(``mxnet_tpu/autograd.py:120-380``); torch's graph replaces it, and
``grad(create_graph=True)`` is torch's double backward.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record",
    "pause",
    "train_mode",
    "predict_mode",
    "is_recording",
    "is_training",
    "set_recording",
    "set_training",
    "mark_variables",
    "backward",
    "grad",
    "get_symbol",
]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()
#: every live variable (an NDArray with a gradient buffer or grad_req)
_VARIABLES = weakref.WeakSet()
_vars_lock = threading.Lock()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _STATE.training
    _STATE.training = bool(train_mode)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._recording = recording
        self._training = training

    def __enter__(self):
        self._prev_r = (set_recording(self._recording)
                        if self._recording is not None else None)
        self._prev_t = (set_training(self._training)
                        if self._training is not None else None)
        return self

    def __exit__(self, *exc):
        if self._recording is not None:
            _STATE.recording = self._prev_r
        if self._training is not None:
            _STATE.training = self._prev_t

    # allow use as decorator, like the reference's _RecordingStateScope
    def __call__(self, fn):
        def wrapped(*a, **k):
            with _Scope(self._recording, self._training):
                return fn(*a, **k)

        return wrapped


def record(train_mode=True):
    """Scope in which op invocations are taped (reference autograd.py:122)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def as_leaf(t):
    """A variable's tensor: detached from any graph, requiring grad
    where torch allows it (floating and complex dtypes)."""
    t = t.detach()
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(True)
    return t


def _register(var):
    var._is_var = True
    var._data = as_leaf(var._data)
    with _vars_lock:
        _VARIABLES.add(var)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference autograd.py:197)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._grad = g if req != "null" else None
        var._grad_req = req
        _register(var)


def _live_variables():
    with _vars_lock:
        return [v for v in _VARIABLES if v._data.requires_grad]


def _heads(heads, head_grads):
    """``(heads, their tensors, head gradients)``: the gradients default
    to ones; an integer head of a recorded op stands as its zero-gradient
    tape tensor; a head with no recorded history that is no variable
    raises."""
    from .ndarray import NDArray  # cycle: autograd <-> ndarray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError("heads and head_grads length mismatch")
    outs, hgs = [], []
    for h, g in zip(heads, head_grads):
        if h._int_tape is not None:
            outs.append(h._int_tape)
            hgs.append(torch.zeros_like(h._int_tape))
            continue
        if h._data.grad_fn is None and not (h._is_var and
                                            h._data.requires_grad):
            raise MXNetError(
                "cannot differentiate a head that was not computed under "
                "autograd.record()")
        outs.append(h._data)
        hgs.append(torch.ones_like(h._data) if g is None
                   else g._data.to(h._data.dtype) if isinstance(g, NDArray)
                   else torch.as_tensor(g, dtype=h._data.dtype,
                                        device=h._data.device))
    return heads, outs, hgs


def _release(heads):
    """After a backward without retain_graph the heads lose their
    history (the reference clears their tape nodes)."""
    for h in heads:
        if not h._is_var:
            h._data = h._data.detach()
            h._int_tape = None


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run reverse mode from ``heads`` and write each variable's
    gradient into its ``.grad`` by its ``grad_req`` (reference
    autograd.py:246)."""
    heads, outs, grads = _heads(heads, head_grads)
    variables = _live_variables()
    if variables:
        with _Scope(None, train_mode), torch.enable_grad():
            gs = torch.autograd.grad(outs, [v._data for v in variables],
                                     grads, retain_graph=retain_graph,
                                     allow_unused=True)
        for var, g in zip(variables, gs):
            if g is not None and var._grad is not None:
                _store_grad(var, g)
    if not retain_graph:
        _release(heads)


def _store_grad(var, g):
    """grad_req='write' replaces the buffer's value, 'add' accumulates
    (include/mxnet/op_attr_types.h OpReqType); 'null' has no buffer."""
    g = g.detach().to(var._grad._data.dtype)
    if var._grad_req == "add":
        g = var._grad._data + g
    var._grad._data = g
    var._fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Functional gradient API (reference autograd.py grad()): the
    gradients of ``heads`` with respect to ``variables``, as new arrays
    (zeros for a variable the heads do not depend on).  With
    ``create_graph`` the gradients are themselves recorded, so they can
    be differentiated again."""
    from .ndarray import NDArray

    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    heads, outs, grads = _heads(heads, head_grads)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad: a variable must be marked with "
                             "attach_grad() before recording")
    retain = create_graph if retain_graph is None else retain_graph
    with _Scope(None, train_mode), torch.enable_grad():
        gs = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                 retain_graph=retain,
                                 create_graph=create_graph,
                                 allow_unused=True)
    res = []
    for v, g in zip(variables, gs):
        if g is None:
            g = torch.zeros_like(v._data, requires_grad=False)
        elif not (create_graph and is_recording()):
            g = g.detach()
        res.append(NDArray(g))
    if not retain:
        _release(heads)
    return res[0] if single else res


def get_symbol(x):
    raise MXNetError(
        "autograd.get_symbol is not supported until the Symbol API is "
        "ported; use gluon HybridBlock.export or mx.sym instead")
