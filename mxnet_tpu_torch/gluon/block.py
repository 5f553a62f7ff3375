"""Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A :class:`Block` is an ``nn.Module`` that keeps the reference's
name-scope scheme (``_BlockScope``), so parameter names match it
exactly (``resnetv10_stage1_conv0_weight``), and the reference's
parameter order (``_collect_all_params``: a block's own parameters in
registration order, then its children's).  Layers implement
``forward`` on tensors; ``hybrid_forward(F, ...)`` is their symbolic
form, with ``F = mx.sym``.

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

``HybridBlock.hybridize`` gives the block the reference's CachedOp
(``mxnet_tpu/gluon/block.py:531-700``): one cache entry per input
signature (input shapes, dtypes and devices, Python arguments,
``training``, and whether the call records).  Plain ``hybridize()`` runs
each entry op by op, as upstream's CachedOp without ``static_alloc``
does; ``hybridize(static_alloc=True, static_shape=True)`` on a CUDA
device captures the entry's forward (and, when it records, its
backward) in CUDA graphs and replays them (``gluon/_graph.py``), one
tape node a call; called on tensors by a plain parent Block, such a
block runs its cache all the same.  A block that cannot be captured
raises.  The cache is cleared where the reference clears it
(``hybridize``, a child's ``__setattr__``, ``cast``), by
``load_parameters`` and ``initialize(force_reinit=True)``, and on the
block a replaced parameter tensor is registered on; a captured entry
that reads a replaced tensor is dropped at its next call.

Called on a :class:`~mxnet_tpu_torch.symbol.Symbol`, a block builds the
reference's graph: each parameter becomes ``param.var()`` and each
layer's ``hybrid_forward(F, x, **params)`` with ``F = mx.sym`` emits the
reference's op and attributes (a container without one chains its
children through ``forward``).  ``HybridBlock.export`` writes that graph
and the parameters; :class:`SymbolBlock` runs such a graph as a block.

NDArrays may come nested in lists and tuples (a recurrent layer's
``lstm(x, [h, c])``); they are unwrapped for ``forward`` and its
tensors, nested as they come back, wrapped again.  ``params=`` shares
the parameters of another block (by full name) as in the reference:
the shared :class:`Parameter` is registered on every block that uses
it, one tensor.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "state_writes_dropped",
           "drop_state_writes", "trace_constant"]


class _SuppressHooks(threading.local):
    """Set during the internal passes (deferred-shape resolution, a CUDA
    graph's warm-up and capture), so that hooks observe only the calls a
    user makes (reference ``mxnet_tpu/gluon/block.py:34-43``)."""

    def __init__(self):
        self.flag = False


_suppress_hooks = _SuppressHooks()


@contextlib.contextmanager
def _hooks_off():
    prev = _suppress_hooks.flag
    _suppress_hooks.flag = True
    try:
        yield
    finally:
        _suppress_hooks.flag = prev


class _HookHandle:
    """Removes a hook (reference ``block.py:356``)."""

    def __init__(self, hooks, key):
        self._hooks = hooks
        self._key = key

    def detach(self):
        self._hooks.pop(self._key, None)


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


def _in_program():
    """Whether a call runs inside another block's cache entry or inside
    a functionalized step (``drop_state_writes``): the outer program
    then runs the call's ops, as the reference's outer jit inlines an
    inner one."""
    return getattr(_tls, "programs", 0) > 0 or state_writes_dropped()


@contextlib.contextmanager
def _program():
    _tls.programs = getattr(_tls, "programs", 0) + 1
    try:
        yield
    finally:
        _tls.programs -= 1


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
        self._mx_forward_hooks = OrderedDict()
        self._mx_forward_pre_hooks = OrderedDict()
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

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each call (NDArrays in and
        out); ``handle.detach()`` removes it (reference ``block.py:180``).
        Not called in the internal passes (deferred shapes, a graph's
        capture), nor inside a replayed graph."""
        key = len(self._mx_forward_hooks)
        while key in self._mx_forward_hooks:
            key += 1
        self._mx_forward_hooks[key] = hook
        return _HookHandle(self._mx_forward_hooks, key)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call (reference
        ``block.py:185``)."""
        key = len(self._mx_forward_pre_hooks)
        while key in self._mx_forward_pre_hooks:
            key += 1
        self._mx_forward_pre_hooks[key] = hook
        return _HookHandle(self._mx_forward_pre_hooks, key)

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
        if force_reinit:
            self._clear_cached_ops()
        return self

    def _clear_cached_ops(self):
        """Clear the cache of every hybridized block of the subtree."""
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m._clear_cached_op()

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` (BatchNorm keeps fp32 for
        half types)."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    # ------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        if _has_symbol(args):
            return self._call_symbol(*args, **kwargs)
        hooked = not _suppress_hooks.flag and bool(
            self._mx_forward_hooks or self._mx_forward_pre_hooks)
        if hooked:
            for hook in list(self._mx_forward_pre_hooks.values()):
                hook(self, _to_ndarray(args))
        if _has_ndarray(args):
            out = self._call_nd(args, kwargs)
        else:
            out = self._call_tensors(args, kwargs)
        if hooked:
            for hook in list(self._mx_forward_hooks.values()):
                hook(self, _to_ndarray(args), _to_ndarray(out))
        return out

    def _call_nd(self, args, kwargs):
        """A call on NDArrays (a hybridized block runs its cache)."""
        if self._deferred_pending:
            self._finish_deferred(*args)
        return self._call_ndarray(args, kwargs)

    def _call_tensors(self, args, kwargs):
        """A call on torch tensors (the PyTorch way)."""
        if self._deferred_pending:
            self._finish_deferred(*args)
        return nn.Module.__call__(self, *args, **kwargs)

    def _call_symbol(self, *args, **kwargs):
        """A call on Symbols: the block's forward builds the graph (the
        reference's ``Block.__call__`` on a Symbol)."""
        return self.forward(*args, **kwargs)

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

    def summary(self, *inputs):
        """Print each block's class, output shape and own parameter
        count for one forward on ``inputs``, and the total (reference
        ``block.py:308``)."""
        import math

        summary = OrderedDict()
        hooks = []

        def _register(block, prefix):
            def _hook(blk, ins, outs):
                out0 = outs[0] if isinstance(outs, (list, tuple)) else outs
                n_params = sum(math.prod(p.shape)
                               for p in blk._reg_params.values()
                               if p._shape_known())
                summary[prefix or blk.name] = (
                    blk.__class__.__name__, getattr(out0, "shape", None),
                    n_params)

            hooks.append(block.register_forward_hook(_hook))
            for cname, child in block._children.items():
                _register(child, (prefix + "." if prefix else "") + cname)

        _register(self, "")
        try:
            self(*inputs)
        finally:
            for h in hooks:
                h.detach()
        lines = [f"{'Layer':<40}{'Output Shape':<24}{'Param #':<12}",
                 "=" * 76]
        total = 0
        for name, (cls, shape, n) in summary.items():
            lines.append(f"{cls + ' (' + name + ')':<40}{str(shape):<24}"
                         f"{n:<12}")
            total += n
        lines += ["=" * 76, f"Total params: {total}"]
        print("\n".join(lines))

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

        self._load_parameter_dict(load(filename, ctx=cpu()), filename,
                                  allow_missing, ignore_extra)

    def _load_parameter_dict(self, loaded, filename, allow_missing=False,
                             ignore_extra=False):
        """:meth:`load_parameters` of the arrays of a ``.params`` file
        already read (``{key: NDArray}``; ``filename`` names it in
        errors)."""
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
        self._clear_cached_ops()


class HybridBlock(Block):
    """A Block the reference can compile: ``hybridize`` gives it a
    shape-keyed cache (the reference's CachedOp, ``mxnet_tpu/gluon/
    block.py:365-729``), captured as CUDA graphs with both static flags
    on a CUDA device; called on a Symbol it builds the reference's
    graph, which ``export`` writes."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._clear_cached_op()

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Turn the cache on (``active``) with the reference's flags
        (``block.py:386-396``): with ``static_alloc`` and
        ``static_shape`` both set, a call on a CUDA device replays CUDA
        graphs; else each entry runs op by op.  Clears the cache of the
        block and of its children."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._clear_cached_op()
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                child._clear_cached_op()

    def _clear_cached_op(self):
        """Drop every cache entry (their graphs and memory pools)."""
        self._cached_op = OrderedDict()

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Resolve every deferred shape of the subtree from example
        inputs: one forward under ``autograd.pause()`` (no layer trains,
        no running statistic moves, no hook fires)."""
        self._infer_and_init(tuple(NDArray(a) if isinstance(a, torch.Tensor)
                                   else a for a in args), {})

    def _infer_and_init(self, args, kwargs):
        """The reference's ``_infer_and_init`` (``block.py:433-456``): one
        eager pass, hooks off, that resolves the deferred shapes of the
        whole subtree and runs their recorded initialization."""
        with _hooks_off(), autograd.pause():
            if self._deferred_pending:
                self._finish_deferred(*args)
            self._call_ndarray(args, kwargs)

    # ------------------------------------------------------------ cache
    def _static(self):
        """Whether ``hybridize`` asked for ``static_alloc`` and
        ``static_shape``."""
        return self._active and bool(self._flags.get("static_alloc")) \
            and bool(self._flags.get("static_shape"))

    def _call_nd(self, args, kwargs):
        if not self._active:
            return super()._call_nd(args, kwargs)
        return self._call_cached(args, kwargs)

    def _call_tensors(self, args, kwargs):
        """On tensors, a block hybridized with both static flags runs its
        cache as on NDArrays (called by a plain parent Block, as upstream
        gives such a child a CachedOp of its own), in the mode and
        recording state of the tensor call; inside another program
        (:func:`_in_program`) its ops are that program's."""
        if not self._static() or _in_program():
            return super()._call_tensors(args, kwargs)
        with autograd._Scope(torch.is_grad_enabled(), self.training):
            return _unwrap(self._call_cached(_to_ndarray(args), kwargs))

    def _call_cached(self, args, kwargs):
        """The cached call (reference ``_call_cached``, ``block.py:531``):
        the entry of this call's signature, made on first use, runs the
        call.  A captured entry whose parameters or buffers were replaced
        since its capture is dropped first.  The block's own deferred
        shapes resolve first, as the eager call resolves them; before a
        capture, one internal pass resolves those of the subtree.  The
        call runs under ``autotune.program_scope`` of its first array
        argument, so a capture bakes in that signature's cached
        winners."""
        if self._deferred_pending:
            self._finish_deferred(*args)
        leaves = _leaves(args)
        sig = (tuple((tuple(a.shape), str(a._data.dtype),
                      str(a._data.device), a._data.requires_grad)
                     if isinstance(a, NDArray) else ("#py", repr(a))
                     for a in leaves),
               tuple(sorted((k, repr(v)) for k, v in kwargs.items())),
               autograd.is_training(), autograd.is_recording())
        entry = self._cached_op.get(sig)
        if entry is not None and not entry.valid(self):
            del self._cached_op[sig]
            entry = None
        first = next((a._data for a in leaves if isinstance(a, NDArray)),
                     None)
        # the cached autotune winners of this call's signature apply
        # while the entry is made and runs (reference ``block.py:618``)
        from .. import autotune

        scope = autotune.program_scope(
            () if first is None else tuple(first.shape),
            "none" if first is None else first.dtype,
            platform=None if first is None else first.device.type)
        with _program(), scope:
            if entry is None:
                if self._static() and first is not None and first.is_cuda:
                    if any(p._tensor() is None
                           for p in _collect_all_params(self)):
                        self._infer_and_init(args, kwargs)
                    entry = _GraphEntry(self, sig[-1])
                else:
                    entry = _EagerEntry()
                self._telemetry_trace(leaves)
            out = entry(self, args, kwargs)
        # stored once its first call (a capture) succeeded
        self._cached_op[sig] = entry
        return out

    def _telemetry_trace(self, leaves):
        """One ``compile`` record per new cache entry (a CUDA-graph
        capture on the card counts as the reference's trace).  No-op
        when ``MXNET_RUNLOG`` is unset (one call + dict lookup); the
        RunLog diffs this fingerprint against the program's previous
        one to name the retrace cause."""
        from .. import telemetry

        rl = telemetry.current()
        if rl is None:
            return
        try:
            arrays = [a for a in leaves if isinstance(a, NDArray)]
            rl.compile_event(
                f"cachedop:{self.name}",
                telemetry.compile_fingerprint(
                    [tuple(a.shape) for a in arrays],
                    [str(a._data.dtype).replace("torch.", "")
                     for a in arrays],
                    autograd.is_training()))
        except Exception:
            pass  # telemetry must never kill a forward

    # --------------------------------------------------------- symbolic
    def _call_symbol(self, *args, **kwargs):
        """The reference's symbolic trace (``block.py:410-418``): each
        registered parameter as ``param.var()``, then
        ``hybrid_forward(mx.sym, ...)``."""
        from .. import symbol as F

        params = {k: p.var() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """The block's symbolic form with ``F = mx.sym`` (a layer writes
        the reference's ``hybrid_forward`` here).  By default a block
        without parameters of its own runs ``forward``, whose children
        take the Symbols."""
        if kwargs:
            raise NotImplementedError(
                f"{type(self).__name__} has parameters and no "
                "hybrid_forward: it cannot be traced")
        return self.forward(x, *args)

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-{epoch:04d}.params``
        (reference ``block.py:706-729``): the graph of a symbolic trace
        on ``var("data")``, and every parameter under ``arg:``/``aux:``
        as the graph classifies it (a frozen weight stays ``arg:``).
        Returns the symbol."""
        out, graph, params = self._export_bytes()
        with open(f"{path}-symbol.json", "w") as f:
            f.write(graph)
        with open(f"{path}-{epoch:04d}.params", "wb") as f:
            f.write(params)
        return out

    def _export_bytes(self):
        """``(symbol, graph JSON text, .params bytes)`` of :meth:`export`,
        written nowhere (``deploy.export_model`` frames them)."""
        from .. import symbol as sym
        from ..ndarray.ndarray import save_buffer

        with _recording_constants() as constants:
            out = self(sym.var("data"))
        if isinstance(out, (list, tuple)):
            out = sym.Group(list(out))
        aux_names = set(out.list_auxiliary_states())
        arrays = {name: p.data() for name, p in
                  self.collect_params().items()}
        if constants:
            # a block that bakes constants (a quantized layer) reads them
            # in place of the parameters it shadows: write what the graph
            # reads
            inputs = set(out.list_inputs())
            arrays = {n: a for n, a in arrays.items() if n in inputs}
            arrays.update((n, NDArray(t)) for n, t in constants.items())
        params = save_buffer(
            {f"{'aux' if name in aux_names else 'arg'}:{name}": a
             for name, a in arrays.items()})
        return out, out.tojson(), params


class _TraceConstants(threading.local):
    def __init__(self):
        self.values = None


_trace_constants = _TraceConstants()


def trace_constant(name, value):
    """The graph variable of a constant tensor that a block computes
    with but does not hold as a Parameter (a quantized layer's baked
    weights): named ``name``, with the tensor's shape and dtype as
    attributes.  Inside :meth:`HybridBlock.export` the tensor is
    recorded and written to ``.params`` beside the parameters."""
    from .. import symbol as sym
    from ..dtype import dtype_name

    if _trace_constants.values is not None:
        _trace_constants.values[name] = value
    return sym.var(name, shape=tuple(value.shape),
                   dtype=dtype_name(value.dtype))


@contextlib.contextmanager
def _recording_constants():
    prev = _trace_constants.values
    _trace_constants.values = OrderedDict()
    try:
        yield _trace_constants.values
    finally:
        _trace_constants.values = prev


class _EagerEntry:
    """A cache entry run op by op: plain ``hybridize()``, or the static
    flags off a CUDA device.  It reads the parameters as the eager call
    does, so it is never stale."""

    graphed = False

    def __init__(self):
        self.calls = 0

    def valid(self, block):
        return True

    def __call__(self, block, args, kwargs):
        self.calls += 1
        return block._call_ndarray(args, kwargs)


class _GraphEntry:
    """A cache entry captured as CUDA graphs (``gluon/_graph.py``): the
    forward alone, or, for a call that records, the forward and its
    backward as one tape node.

    A recording program holds one replay's activations until that
    replay's backward runs or its outputs are dropped.  A call made
    while every program is so held (a block called twice inside one
    ``record()``, as a GAN's discriminator or a siamese net is) captures
    another program on its own pool, as upstream's static CachedOp hands
    out a fresh state while one is held; ``programs`` lists them."""

    graphed = True

    def __init__(self, block, record):
        self.calls = 0
        self._record = record
        self._params = _collect_all_params(block)
        for p in self._params:
            p._check_init()
        self._addresses = [(weakref.ref(t), t.data_ptr())
                           for t in _tensors_of(block)]
        self._ospec = None
        self.programs = []

    def valid(self, block):
        """Whether every parameter and buffer the graphs read is still
        the block's, at the same address."""
        current = _tensors_of(block)
        return len(current) == len(self._addresses) and all(
            ref() is c and c.data_ptr() == ptr
            for (ref, ptr), c in zip(self._addresses, current))

    def _program(self, block, args, kwargs):
        """A program whose pool is free for this call, captured on first
        need."""
        from ._graph import GraphProgram

        for prog in self.programs:
            if not prog.held():
                return prog
        trained = [t for t in block.parameters() if t.requires_grad] \
            if self._record else []

        def fn(aliases, *flat):
            with _swapped(block, {id(t): a for t, a in zip(trained,
                                                            aliases)}):
                out = nn.Module.__call__(block, *_rebuild(args, iter(flat)),
                                         **kwargs)
            outs, self._ospec = _flatten_out(out)
            return outs

        with _hooks_off(), block._imperative():
            prog = GraphProgram(fn, _tensors(args), trained,
                                list(block.buffers()), self._record,
                                block.name)
        self.programs.append(prog)
        return prog

    def __call__(self, block, args, kwargs):
        prog = self._program(block, args, kwargs)
        self.calls += 1
        for p in self._params:
            p._wrap()  # its array is a variable backward writes
        with torch.set_grad_enabled(autograd.is_recording()):
            outs = prog(_tensors(args))
        return _to_ndarray(_unflatten_out(iter(outs), self._ospec))


@contextlib.contextmanager
def _swapped(block, alias_of):
    """Every parameter slot of the subtree that holds a tensor of
    ``alias_of`` (``{id(tensor): alias}``) holds its alias inside the
    scope, shared slots included."""
    saved = []
    for m in block.modules():
        for k, t in m._parameters.items():
            if t is not None and id(t) in alias_of:
                saved.append((m, k, t))
                m._parameters[k] = alias_of[id(t)]
    try:
        yield
    finally:
        for m, k, t in saved:
            m._parameters[k] = t


def _tensors_of(block):
    return list(itertools.chain(block.parameters(), block.buffers()))


def _tensors(args):
    """The tensors of the NDArrays of ``args`` (nested), in order."""
    return [a._data for a in _leaves(args) if isinstance(a, NDArray)]


def _leaves(x):
    """The NDArrays and other values of ``x`` (nested in lists and
    tuples), in order."""
    if isinstance(x, (list, tuple)):
        return [leaf for a in x for leaf in _leaves(a)]
    return [x]


def _rebuild(x, tensors):
    """``x`` with each NDArray replaced by the next of ``tensors``."""
    if isinstance(x, NDArray):
        return next(tensors)
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(a, tensors) for a in x)
    return x


def _flatten_out(out):
    """``(tensors, spec)`` of a block's output (nested tuples/lists)."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (list, tuple)):
        flat, specs = [], []
        for o in out:
            f, sp = _flatten_out(o)
            flat += f
            specs.append((len(f), sp))
        return flat, (type(out), specs)
    raise MXNetError(f"a graphed block returns tensors, not "
                     f"{type(out).__name__}")


def _unflatten_out(outs, spec):
    if spec is None:
        return next(outs)
    kind, specs = spec
    return kind(_unflatten_out(outs, sp) for _, sp in specs)


def _has_symbol(x):
    """Whether ``x`` is, or nests in lists and tuples, a Symbol."""
    if isinstance(x, (list, tuple)):
        return any(_has_symbol(a) for a in x)
    return isinstance(x, Symbol)


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


_TRAINED_DTYPES = ("float16", "bfloat16", "float32", "float64")


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol graph (reference ``block.py:754-799``).

    Every graph input that is not one of ``inputs`` becomes a Parameter
    named as the graph names it, in the dtype its ``__dtype__`` attribute
    gives (float32 without one); an auxiliary one (BatchNorm's moving
    statistics), and one of an integer or float8 dtype (a quantized
    layer's baked weights), takes ``grad_req="null"`` and is not
    differentiable.  ``forward`` evaluates the graph with the port's ops
    on the device of the parameters (``symbol/executor.py``).  Outside
    ``autograd.record()`` the graph predicts, as the reference's does;
    inside it, unlike the reference's (ROADMAP §C), the call is taped, so
    the gradients reach the parameters, and it trains exactly when
    ``autograd.is_training()``, as the port's layers do."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            from ..symbol.symbol import Group

            outputs = Group(list(outputs))
        self._outputs = outputs
        self._inputs = list(inputs)
        input_names = {s.name for s in self._inputs}
        aux = set(outputs.list_auxiliary_states())
        self._param_attrs = OrderedDict()  # graph name -> attribute
        from ..dtype import attr_dtype_name

        dtypes = {n.name: attr_dtype_name(n.attr_dict["__dtype__"])
                  for n in outputs._topo()
                  if n.op is None and "__dtype__" in n.attr_dict}
        for name in outputs.list_inputs():
            if name in input_names or name in self._param_attrs:
                continue
            # a variable with a dtype of its own (a quantized layer's
            # int8 or e4m3 constant) is not trained
            const = dtypes.get(name, "float32") not in _TRAINED_DTYPES
            param = self.params.get(
                name, grad_req="null" if name in aux or const else "write",
                allow_deferred_init=True,
                differentiable=name not in aux and not const,
                dtype=dtypes.get(name, "float32"))
            attr = name if name.isidentifier() and not hasattr(self, name) \
                else f"param{len(self._param_attrs)}"
            setattr(self, attr, param)
            self._param_attrs[name] = attr

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file``'s graph with ``input_names``
        as its data inputs, its parameters loaded from ``param_file``
        (``arg:``/``aux:`` keys) onto ``ctx`` (default: the current
        context)."""
        from ..symbol.symbol import load, var

        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(load(symbol_file), [var(n) for n in input_names])
        if param_file is not None:
            ret.collect_params().initialize(ctx=ctx)  # deferred: the device
            ret.load_parameters(param_file)
        return ret

    def forward(self, *args):
        from ..symbol.executor import _eval_graph

        value_of = {s.name: a for s, a in zip(self._inputs, args)}
        for name, attr in self._param_attrs.items():
            value_of[name] = getattr(self, attr)
        outs, aux_updates, _ = _eval_graph(self._outputs, value_of,
                                           self.training, args[0].device)
        with torch.no_grad():
            for name, value in aux_updates.items():
                getattr(self, self._param_attrs[name]).copy_(value)
        return outs[0] if len(outs) == 1 else outs
