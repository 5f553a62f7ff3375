"""Parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` is one named weight: its full reference-style name
(``resnetv10_stage1_conv0_weight``), shape, dtype, initializer,
``grad_req`` and ``lr_mult``/``wd_mult``.  Its tensor is registered on
the owning :class:`~mxnet_tpu_torch.gluon.block.Block` the PyTorch way:
an ``nn.Parameter`` when it is trained, a buffer when ``grad_req`` is
``null`` (BatchNorm running statistics), so ``.to()``, ``state_dict``
and ``torch.func.functional_call`` see it.  :meth:`Parameter.data`
wraps that very tensor in an ``NDArray``: ``loss.backward()`` writes
its gradient into :meth:`Parameter.grad` through ``mx.autograd``, and
writing the array (a Trainer's update, ``set_data``, ``p.data()[:] =
v``) writes the registered tensor in place, so ``functional_call`` and
the NDArray see one value.

Shapes may be deferred as in the reference: a 0 in a shape (a layer
built without ``in_channels``/``in_units``) is resolved from the input
at the block's first forward, and ``initialize`` on such a parameter
records its initializer and device until then
(:class:`DeferredInitializationError` before it).
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as onp
import torch
from torch import nn

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import current_context, resolve_device
from ..dtype import normalize_dtype
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A parameter used before its deferred shape is known."""


def _device_of(ctx):
    """``torch.device`` of ``ctx`` (a Context, a list of one, a string
    or a torch.device); None is the current context."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError("a parameter on more than one device is not "
                             "ported yet (ROADMAP §A 11 item 4)")
        ctx = ctx[0]
    return resolve_device(current_context() if ctx is None else ctx)


class _ParamArray(NDArray):
    """The NDArray of a parameter: a mutation (``x[:] = v``, an
    optimizer's update) is written into the tensor in place, so the
    block sees it, instead of rebinding the array."""

    __slots__ = ()

    def _adopt(self, new_data):
        if tuple(new_data.shape) != tuple(self._data.shape):
            raise MXNetError(
                f"cannot write shape {tuple(new_data.shape)} into a "
                f"parameter of shape {tuple(self._data.shape)}")
        with torch.no_grad():
            self._data.copy_(new_data)

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError("a Parameter's array takes its gradient buffer "
                         "from Parameter.grad_req")


class Parameter:
    """A weight with its initialization and gradient state."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("sparse parameters are not ported yet")
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(int(s) for s in shape) \
            if shape is not None else None
        self._dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = None
        self._block = None  # owning block and attribute, once bound
        self._attr = None
        self._aliases = []  # (block, attr) of the blocks sharing it
        self._own = None  # the tensor of a parameter on no block
        self._initialized = False
        self._deferred_init = None  # (init, device, default, generator)
        self._nd = None  # the NDArray over the tensor, made on demand
        self.grad_req = grad_req

    # ---------------------------------------------------------- attributes
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
        if req == self._grad_req:
            return
        self._grad_req = req
        t = self._tensor()
        if t is not None:
            self._register(t.detach())

    @property
    def shape(self):
        t = self._tensor()
        return tuple(t.shape) if t is not None else self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None or new_shape is None:
            if new_shape is not None:
                self._shape = tuple(new_shape)
            return
        new_shape = tuple(new_shape)
        if len(self._shape) != len(new_shape) or not all(
                s in (0, n) for s, n in zip(self._shape, new_shape)):
            raise MXNetError(
                f"Expected shape {new_shape} is incompatible with given "
                f"shape {self._shape} for Parameter {self.name}")
        self._shape = new_shape

    @property
    def dtype(self):
        t = self._tensor()
        if t is None:
            return self._dtype
        return str(t.dtype).replace("torch.", "")

    @dtype.setter
    def dtype(self, dtype):
        self._dtype = dtype

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # ------------------------------------------------------------ storage
    def _bind(self, block, attr):
        """Register the tensor (or, while the shape is deferred, an
        empty slot) on ``block`` under ``attr``.  A parameter bound
        already (shared through ``params=``) registers its one tensor
        on ``block`` too."""
        if self._block is not None and (self._block, self._attr) != (
                block, attr):
            self._aliases.append((block, attr))
            self._register_on(block, attr, self._tensor())
            return
        self._block, self._attr = block, attr
        if self._shape_known():
            self._register(torch.empty(self._shape,
                                       dtype=normalize_dtype(self._dtype)))
        elif self._grad_req == "null":
            block.register_buffer(attr, None)
        else:
            block.register_parameter(attr, None)

    def _tensor(self):
        """The registered tensor (None while the shape is deferred)."""
        if self._block is None:
            return self._own
        return getattr(self._block, self._attr)

    def _register(self, t):
        """Make ``t`` the parameter's tensor: an ``nn.Parameter`` on the
        block when trained, else a buffer.  The blocks it is registered
        on clear their caches; an ancestor's captured entry, which reads
        the old tensor by address, is dropped at its next call."""
        self._nd = None
        if self._block is None:
            self._own = t.requires_grad_(self._grad_req != "null") \
                if t.is_floating_point() else t
            return
        if self._grad_req != "null":
            t = nn.Parameter(t)
        for blk, attr in [(self._block, self._attr)] + self._aliases:
            self._register_on(blk, attr, t)
            clear = getattr(blk, "_clear_cached_op", None)
            if clear is not None:
                clear()

    def _register_on(self, blk, attr, t):
        """``t`` as ``blk``'s parameter (or buffer) ``attr``; None: an
        empty slot."""
        blk._parameters.pop(attr, None)
        blk._buffers.pop(attr, None)
        if self._grad_req != "null":
            blk._parameters[attr] = t
        else:
            blk._buffers[attr] = t

    def _wrap(self):
        """The NDArray over the current tensor, a variable of
        ``mx.autograd`` unless ``grad_req`` is null.  Made again when
        the tensor changed (``.to()`` replaces buffers, ``cast``)."""
        t = self._tensor()
        arr = self._nd
        if arr is None or arr._data is not t:
            arr = _ParamArray(t)
            if self._grad_req != "null" and t.requires_grad:
                arr._grad_req = self._grad_req
                arr._grad = NDArray(torch.zeros_like(t.detach()))
                arr._is_var = True
                with autograd._vars_lock:
                    autograd._VARIABLES.add(arr)
            self._nd = arr
        elif arr._grad is not None and (
                arr._grad._data.dtype != t.dtype
                or arr._grad._data.device != t.device):
            arr._grad = NDArray(torch.zeros_like(t.detach()))
        return arr

    def __getstate__(self):
        # the NDArray is a view of the registered tensor, remade on
        # demand: a copy (deepcopy of the block) gets its own
        state = dict(self.__dict__)
        state["_nd"] = None
        return state

    # ---------------------------------------------------------- lifecycle
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Draw the value (``init``, else the parameter's own
        initializer, else ``default_init``) on the host from
        ``generator`` and place it on ``ctx`` (default: the current
        context).  An unknown shape defers this to the first forward
        when ``allow_deferred_init``."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._initialized and not force_reinit:
            return
        device = _device_of(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init,
                                       generator)
                return
            raise MXNetError(f"Cannot initialize Parameter {self.name} "
                             f"because it has invalid shape: "
                             f"{self._shape}.")
        self._finish_init(init, device, default_init, generator)

    def _finish_init(self, init, device, default_init, generator):
        initializer = init_mod.create(
            init if init is not None else
            self.init if self.init is not None else default_init)
        value = initializer(init_mod.InitDesc(self.name), self._shape,
                            generator=generator)
        self._place(value, device)

    def _place(self, value, device):
        """Write ``value`` into the tensor on ``device``: in place when
        the tensor is there already with that shape and dtype, else as
        a new registered tensor."""
        dtype = normalize_dtype(self._dtype)
        t = self._tensor()
        with torch.no_grad():
            if t is not None and t.device == device and t.dtype == dtype \
                    and tuple(t.shape) == tuple(value.shape):
                t.copy_(value)
            else:
                self._register(value.detach().to(device, dtype, copy=True))
        self._shape = tuple(value.shape)
        self._deferred_init = None
        self._initialized = True
        self._wrap()

    def _finish_deferred_init(self):
        """Initialize with what ``initialize`` recorded, now that the
        shape is known."""
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        self._finish_init(*self._deferred_init)

    def _check_init(self):
        if not self._initialized:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "because initialization was deferred. Actual "
                    "initialization happens during the first forward "
                    "pass.")
            raise MXNetError(
                f"Parameter {self.name} has not been initialized. You "
                "should initialize parameters with Block.initialize().")

    def _load(self, value):
        """Take ``value`` (a tensor) as the parameter's value, on its
        current device (a deferred shape resolves to it)."""
        if self._tensor() is None:
            self.shape = tuple(value.shape)
            device = self._deferred_init[1] if self._deferred_init \
                else _device_of(None)
        else:
            device = self._tensor().device
            if tuple(value.shape) != self.shape:
                raise MXNetError(f"Parameter '{self.name}' has shape "
                                 f"{self.shape}, the value "
                                 f"{tuple(value.shape)}")
        self._place(value, device)

    # --------------------------------------------------------------- data
    def data(self, ctx=None):
        """The NDArray over the parameter's tensor."""
        self._check_init()
        return self._wrap()

    def list_data(self):
        return [self.data()]

    def list_grad(self):
        """``[grad()]``: the gradient buffer of each device (one)."""
        return [self.grad()]

    def list_ctx(self):
        """The contexts the parameter lives on (one), or, while its shape
        is deferred, the one ``initialize`` recorded (reference
        ``parameter.py:199``)."""
        from ..context import from_torch_device

        if self._tensor() is None and self._deferred_init is not None:
            return [from_torch_device(self._deferred_init[1])]
        self._check_init()
        return [from_torch_device(self._tensor().device)]

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx``, its value unchanged (the
        reference keeps one logical copy and does nothing); a deferred
        parameter is initialized there later."""
        device = _device_of(ctx)
        if self._tensor() is None:
            if self._deferred_init is not None:
                self._deferred_init = (self._deferred_init[0], device,
                                       *self._deferred_init[2:])
            return
        if self._tensor().device != device:
            self._place(self._tensor().detach(), device)

    def var(self):
        """The parameter as a Symbol variable with its shape, dtype and
        multipliers (reference ``parameter.py:246``)."""
        from ..symbol.symbol import var

        return var(self.name, shape=self.shape, dtype=self.dtype,
                   lr_mult=self.lr_mult, wd_mult=self.wd_mult)

    def grad(self, ctx=None):
        """The NDArray that ``backward`` writes the gradient into."""
        arr = self.data()
        if arr._grad is None:
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"{self.name} because grad_req='null'")
        return arr._grad

    def set_data(self, data):
        """Write ``data`` (NDArray, tensor or array) into the parameter,
        cast to its dtype, on its device."""
        self.shape = tuple(data.shape)
        if not self._initialized:
            if self._deferred_init is None:
                raise MXNetError(f"Parameter {self.name} has not been "
                                 "initialized")
        if isinstance(data, NDArray):
            src = data._data.detach()
        elif isinstance(data, torch.Tensor):
            src = data.detach()
        else:
            src = torch.from_numpy(onp.asarray(data))
        self._load(src)

    def zero_grad(self):
        if self._initialized and self._grad_req != "null":
            g = self._wrap()._grad
            if g is not None:
                g._data = torch.zeros_like(g._data)

    def cast(self, dtype):
        """Change the dtype (the value is cast; the gradient buffer is
        made anew)."""
        self._dtype = dtype
        t = self._tensor()
        if t is not None:
            self._register(t.detach().to(normalize_dtype(dtype)))

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


class Constant(Parameter):
    """A parameter that holds a constant and takes no gradient
    (reference ``parameter.py:260``)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value._data
        value = torch.as_tensor(onp.asarray(value)
                                if not isinstance(value, torch.Tensor)
                                else value).detach().cpu()
        self.value = NDArray(value)
        const = value

        class _CInit(init_mod.Initializer):
            def __call__(self, desc, shape, generator=None):
                return const.clone()

        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=str(value.dtype).replace("torch.", ""),
                         init=_CInit(), differentiable=False)


class ParameterDict:
    """Prefix-scoped ordered dict of :class:`Parameter` (reference
    ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        lines = [f"{self._prefix or 'ParameterDict'} ("]
        lines += [f"  {v!r}" for v in self._params.values()]
        lines.append(")")
        return "\n".join(lines)

    def get_constant(self, name, value=None):
        """Get or create the :class:`Constant` ``prefix + name``
        (reference ``parameter.py:353``)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            if value is None:
                raise MXNetError(f"No constant named '{name}'. Please "
                                 "specify value.")
            param = self._params[name] = Constant(name, value)
        return param

    def get(self, name, **kwargs):
        """Get or create the parameter ``prefix + name`` (found in the
        shared dict first, when this one shares another's)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
        elif "shape" in kwargs:
            param.shape = kwargs["shape"]
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(
                    f"Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def select(self, pattern):
        """The parameters whose names match the regex ``pattern``."""
        ret = ParameterDict(self._prefix)
        ret.update({k: v for k, v in self.items()
                    if re.compile(pattern).match(k)})
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter: its own initializer wins, the
        others take ``init`` (default ``Uniform()``)."""
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx``."""
        for v in self.values():
            v.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to a ``.params`` file keyed by its full
        name less ``strip_prefix`` (reference ``parameter.py:393``)."""
        from ..ndarray.ndarray import save

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError(
                    f"Prefix '{strip_prefix}' is to be stripped before "
                    f"saving, but Parameter's name '{param.name}' does "
                    "not start with it")
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a ``.params`` file keyed by full name (less
        ``restore_prefix``; ``arg:``/``aux:`` dropped) into the
        parameters, each cast to its dtype; a parameter not initialized
        yet is initialized on ``ctx`` (reference ``parameter.py:407``)."""
        from ..context import cpu
        from ..ndarray.ndarray import load

        loaded = load(filename, ctx=cpu())
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} holds no parameter names")
        arg_dict = {restore_prefix + (k.split(":", 1)[1]
                                      if k.startswith(("arg:", "aux:"))
                                      else k): v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
        for name, arr in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter '{name}' loaded from file "
                        f"'{filename}' is not present in this ParameterDict")
                continue
            param = self._params[name]
            if not param._initialized and param._deferred_init is None:
                param.shape = tuple(arr.shape)
                param.initialize(ctx=ctx)
            param._load(arr._data)
