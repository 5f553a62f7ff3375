"""Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A :class:`Block` is an ``nn.Module`` that keeps the reference's
name-scope scheme (``_BlockScope``), so parameter names match it
exactly (``resnetv10_stage1_conv0_weight``), and the reference's
parameter order (``_collect_all_params``: a block's own parameters in
registration order, then its children's).  Layers implement
``forward``; the reference's ``hybrid_forward(F, ...)`` indirection has
no counterpart.

A block is called two ways:

- on ``NDArray``s, the reference's imperative Gluon: the outputs are
  NDArrays on ``mx.autograd``'s tape (taped only inside
  ``autograd.record()``), and every layer of the block trains exactly
  when ``autograd.is_training()`` is true for the call, so BatchNorm
  folds batch statistics into its running averages inside ``record()``
  and predicts with them outside it;
- on torch tensors, the PyTorch way that ``parallel.functionalize`` and
  ``make_train_step`` use: the mode is ``nn.Module.training``.  Like the
  reference, a block predicts unless asked to train: every Block
  starts in eval mode (``block.train()`` or
  ``parallel.functionalize(..., train=True)`` switch it).

A layer built without ``in_channels``/``in_units`` has a deferred
shape: its first call (or :meth:`HybridBlock.infer_shape`) resolves it
from the input and runs the initialization ``initialize`` recorded.

``HybridBlock.hybridize`` is a no-op for now: PyTorch runs eagerly and
the CachedOp analog (a shape-keyed compiled program) is queued
(ROADMAP §A 14); the results are the reference's.

NDArrays may come nested in lists and tuples (a recurrent layer's
``lstm(x, [h, c])``); they are unwrapped for ``forward`` and its
tensors, nested as they come back, wrapped again.  ``params=`` shares
the parameters of another block (by full name) as in the reference:
the shared :class:`Parameter` is registered on every block that uses
it, one tensor.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "state_writes_dropped",
           "drop_state_writes"]


class _BlockScope:
    """Name-scope manager producing reference-compatible prefixes."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """``(prefix, ParameterDict)`` of a new block: a ``params`` dict
        given is shared (its parameters are looked up by full name), and
        a child inherits its parent's shared dict."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NM.get(hint) + "_"
            if params is None:
                return prefix, ParameterDict(prefix)
            return prefix, ParameterDict(params.prefix, params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class _NameManager(threading.local):
    def __init__(self):
        self._counter = {}

    def get(self, hint):
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"


_NM = _NameManager()
_tls = threading.local()


def state_writes_dropped():
    """True inside :func:`drop_state_writes` (layers then skip their
    running-statistics update)."""
    return getattr(_tls, "drop_state", False)


@contextlib.contextmanager
def drop_state_writes():
    """Scope in which layers compute but do not store state updates.

    The reference's ``parallel.functionalize`` swaps traced values into
    the block and runs its forward; the BatchNorm layer's running-stat
    ``_adopt`` lands on those traced values and is lost, so a
    ``make_train_step`` step leaves running statistics unchanged
    (ROADMAP §C).  The port's ``functionalize`` reproduces that with
    this scope."""
    prev = state_writes_dropped()
    _tls.drop_state = True
    try:
        yield
    finally:
        _tls.drop_state = prev


class Block(nn.Module):
    """Base class for all layers and models."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = OrderedDict()
        self._deferred_pending = False
        self.training = False

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value._bind(self, name)
            self._reg_params[name] = value
            if not value._shape_known():
                self._deferred_pending = True
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    @property
    def _children(self):
        return OrderedDict((k, v) for k, v in self._modules.items()
                           if v is not None)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def collect_params(self, select=None):
        """The :class:`ParameterDict` ``{full name: Parameter}`` of this
        block and its descendants, in :func:`_collect_all_params` order;
        ``select`` keeps the names a regex matches."""
        ret = ParameterDict(self._params.prefix)
        ret.update(OrderedDict((p.name, p)
                               for p in _collect_all_params(self)))
        return ret if select is None else ret.select(select)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, device=None, generator=None):
        """Initialize every parameter on ``ctx`` (or ``device``; default
        the current context, ``gpu(0)`` unless a ``with mx.cpu():``
        scope is open; a CUDA device without a card raises).

        A parameter's own initializer (BatchNorm's ``ones``/``zeros``)
        wins; the others take ``init`` (default ``Uniform()``), which
        dispatches on the name suffix like the reference.  Values are
        drawn on the host from ``generator`` (a ``torch.Generator``;
        None = numpy's global RNG, as the reference draws), in parameter
        order, then placed on the device.  A parameter whose shape is deferred is initialized
        at the block's first forward."""
        if ctx is not None and device is not None:
            raise MXNetError("pass ctx or device, not both")
        self.collect_params().initialize(
            init, ctx if ctx is not None else device, verbose,
            force_reinit, generator=generator)
        return self

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` (BatchNorm keeps fp32 for
        half types)."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    # ------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        if self._deferred_pending:
            self._finish_deferred(*args)
        if _has_ndarray(args):
            return self._call_ndarray(args, kwargs)
        return super().__call__(*args, **kwargs)

    def _finish_deferred(self, *args):
        """Resolve this block's deferred shapes from its inputs and run
        the initialization ``initialize`` recorded."""
        pending = [p for p in self._reg_params.values()
                   if p._tensor() is None]
        if pending:
            self._infer_param_shapes(*args)
            for p in pending:
                if p._deferred_init is None:
                    p._check_init()
                p._finish_deferred_init()
        self._deferred_pending = False

    def _infer_param_shapes(self, *args):
        """Set the deferred parameter shapes from the inputs (layers
        with deferrable shapes override)."""
        raise DeferredInitializationError(
            f"{self.name}: parameter shapes unknown and block does not "
            "implement shape inference")

    def _call_ndarray(self, args, kwargs):
        """The imperative Gluon call: NDArrays in and out; taped when
        ``autograd.is_recording()``, every layer in training mode when
        ``autograd.is_training()``."""
        with self._imperative():
            out = super().__call__(*_unwrap(args), **kwargs)
        return _to_ndarray(out)

    @contextlib.contextmanager
    def _imperative(self):
        """The scope of an imperative call on NDArrays: every initialized
        parameter's array is a variable of ``mx.autograd``, torch records
        when ``autograd.is_recording()``, and every layer of the block
        trains exactly when ``autograd.is_training()``."""
        for p in _collect_all_params(self):
            if p._initialized:
                p._wrap()  # its array is a variable backward writes
        training = autograd.is_training()
        modules = list(self.modules())
        modes = [m.training for m in modules]
        for m in modules:
            m.training = training
        try:
            with torch.set_grad_enabled(autograd.is_recording()):
                yield
        finally:
            for m, mode in zip(modules, modes):
                m.training = mode

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``: each parameter under the
        attribute path that reaches it (``features.0.weight``), the keys
        that the reference's ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter to a ``.params`` file keyed by its
        structural name (``features.0.weight``), the reference's
        ``Block.save_parameters`` bytes."""
        from ..ndarray.ndarray import save

        save(filename, {k: p.data() for k, p in
                        self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, allow_missing=False,
                        ignore_extra=False):
        """Copy the arrays of a ``.params`` file into the parameters, in
        place, each cast to its parameter's dtype on its device (reference
        ``Block.load_parameters``; a deferred shape takes the file's).
        The file is keyed by structural name (the reference's
        ``save_parameters``) or, as older files and ``ParameterDict.save``
        are, by full name (``resnetv10_conv0_weight``), with or without
        the block's prefix; ``arg:``/``aux:`` prefixes are dropped.  A
        missing, extra or mis-shaped entry raises unless allowed."""
        from ..context import cpu
        from ..ndarray.ndarray import load

        loaded = load(filename, ctx=cpu())
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} holds no parameter names")
        loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                  else k: v for k, v in loaded.items()}
        if loaded and not any("." in k for k in loaded):
            params = self.collect_params()
            if not any(k in params for k in loaded):
                # names without the block's prefix (a top-level layer's
                # own save_parameters): the reference restores it
                loaded = {self.prefix + k: v for k, v in loaded.items()}
        else:
            params = self._collect_params_with_prefix()
        missing = [n for n in params if n not in loaded]
        extra = [n for n in loaded if n not in params]
        if missing and not allow_missing:
            raise MXNetError(f"Parameter '{missing[0]}' is missing in file "
                             f"'{filename}'")
        if extra and not ignore_extra:
            raise MXNetError(f"Parameter '{extra[0]}' loaded from file "
                             f"'{filename}' is not present in this Block")
        for name, param in params.items():
            if name not in loaded:
                continue
            src = loaded[name]._data
            if param._shape_known() and tuple(src.shape) != param.shape:
                raise MXNetError(f"Parameter '{name}' has shape "
                                 f"{tuple(src.shape)} in '{filename}', "
                                 f"{param.shape} here")
            param._load(src)


class HybridBlock(Block):
    """A Block the reference can compile (``hybridize``); the port runs
    it eagerly."""

    def infer_shape(self, *args):
        """Resolve every deferred shape of the subtree from example
        inputs: one forward under ``autograd.pause()`` (no layer trains,
        no running statistic moves)."""
        with autograd.pause():
            self(*(NDArray(a) if isinstance(a, torch.Tensor) else a
                   for a in args))


def _has_ndarray(x):
    """Whether ``x`` is, or nests in lists and tuples, an NDArray."""
    if isinstance(x, (list, tuple)):
        return any(_has_ndarray(a) for a in x)
    return isinstance(x, NDArray)


def _unwrap(x):
    """``x`` with every NDArray (nested in lists and tuples) replaced by
    its tensor."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(a) for a in x)
    return x


def imperative(method):
    """Decorate a block method that computes on tensors so that it also
    takes NDArrays (nested in lists and tuples), as ``__call__`` does:
    the tensors run in :meth:`Block._imperative`'s scope and what comes
    back is wrapped as NDArrays."""

    def wrapped(self, *args, **kwargs):
        if not (_has_ndarray(args) or _has_ndarray(list(kwargs.values()))):
            return method(self, *args, **kwargs)
        with self._imperative():
            out = method(self, *_unwrap(args),
                         **{k: _unwrap(v) for k, v in kwargs.items()})
        return _to_ndarray(out)

    wrapped.__name__ = method.__name__
    wrapped.__doc__ = method.__doc__
    return wrapped


def _to_ndarray(out):
    """Tensors in a block's output (nested tuples/lists) as NDArrays."""
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_to_ndarray(o) for o in out)
    return out


def _collect_all_params(block):
    """Flat list of subtree Parameters in deterministic registry order —
    the order the reference's functionalize and bucket plan use."""
    result = list(block._reg_params.values())
    for child in block._children.values():
        result.extend(_collect_all_params(child))
    return result
