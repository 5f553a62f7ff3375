"""NDArray: the eager array type, over a ``torch.Tensor`` (counterpart
of ``mxnet_tpu/ndarray/ndarray.py``).

Reference parity: include/mxnet/ndarray.h:82 and
python/mxnet/ndarray/ndarray.py.  PyTorch's CUDA stream gives the
reference engine's returns-immediately semantics; ``wait_to_read`` and
``waitall`` synchronise.

Mutation semantics: an NDArray is a mutable handle, and mutation
(``x[:] = v``, ``x += 1``, ``out=``) computes a new tensor and rebinds
the handle to it (``_adopt``).  Nothing is ever written in place into a
tensor, so a tensor that autograd saved for a backward stays as it
was.  As in the reference, ``_adopt`` drops the array's recorded
history; a variable stays a variable.

``.params`` files are bit-compatible with the reference
(:func:`save`/:func:`load`, V1/V2/V3 and the legacy layout).
"""
from __future__ import annotations

import struct

import numpy as onp
import torch

from .. import _rng, autograd
from ..base import MXNetError, integer_types, numeric_types
from ..context import Context, current_context, from_torch_device
from ..dtype import (NP_TO_TYPE_FLAG, TYPE_FLAG_TO_NP, normalize_dtype,
                     to_numpy_dtype)
from ..ops.registry import OpDef, get_op

__all__ = [
    "NDArray",
    "invoke",
    "array",
    "empty",
    "zeros",
    "ones",
    "full",
    "arange",
    "linspace",
    "eye",
    "zeros_like",
    "ones_like",
    "concat",
    "concatenate",
    "stack",
    "split",
    "save",
    "load",
    "load_buffer",
    "save_buffer",
    "waitall",
]

#: jnp without x64 has no 64-bit types: an array whose dtype is taken
#: from its source gets the 32-bit one, as in the reference
_CANONICAL = {onp.dtype("float64"): onp.dtype("float32"),
              onp.dtype("int64"): onp.dtype("int32"),
              onp.dtype("uint64"): onp.dtype("uint32"),
              onp.dtype("complex128"): onp.dtype("complex64")}


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_is_var", "_stype",
                 "_fresh_grad", "_int_tape", "__weakref__")

    def __init__(self, data, stype="default"):
        self._data = data  # torch.Tensor
        self._grad = None
        self._grad_req = "null"
        self._is_var = False
        self._stype = stype
        self._fresh_grad = False  # set by backward, cleared by a Trainer
        # an integer output of a recorded op: a float 0-d tensor on the
        # tape whose backward gives its inputs zero gradients
        self._int_tape = None

    # ------------------------------------------------------------- basics
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype; bfloat16 and float8, which numpy lacks, as
        their ``torch.dtype``."""
        d = self._data.dtype
        if d in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            return d
        return to_numpy_dtype(d)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return from_torch_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        return self._stype

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of an NDArray with multiple elements is "
                "ambiguous.")
        return bool(self._data)

    def __float__(self):
        return float(self._data)

    def __int__(self):
        return int(self._data)

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -------------------------------------------------------- sync points
    def asnumpy(self):
        """Blocking copy to host (reference: MXNDArraySyncCopyToCPU).
        bfloat16 and float8 come back as float32, their exact widening
        (numpy has no such types without ml_dtypes)."""
        t = self._data.detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.to(torch.float32)
        t = t.cpu() if t.is_cuda else t.clone()
        return t.numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Reference: Engine::WaitForVar (threaded_engine.cc:379)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # -------------------------------------------------------- conversions
    def astype(self, dtype, copy=True):
        dtype = normalize_dtype(dtype)
        if not copy and self._data.dtype == dtype:
            return self
        return invoke("Cast", [self], dtype=dtype)

    def copy(self):
        return invoke("_copy", [self])

    def copyto(self, other):
        """Copy to an NDArray (writes into it) or a Context (new array)."""
        if isinstance(other, NDArray):
            other._adopt(self._data.detach().to(other._data.device,
                                                other._data.dtype))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, context):
        if context == self.context:
            return self
        return NDArray(self._data.detach().to(context.torch_device()))

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        if stype == "default":
            return self
        raise MXNetError(f"storage type {stype!r} is not ported yet "
                         "(ndarray/sparse.py)")

    def detach(self):
        return NDArray(self._data.detach())

    # pickle via host numpy (optimizer-state checkpointing); a dtype
    # numpy lacks (bfloat16) travels widened and is restored on load
    def __getstate__(self):
        return {"data": self.asnumpy(), "stype": self._stype,
                "dtype": str(self._data.dtype).replace("torch.", "")}

    def __setstate__(self, state):
        self._data = torch.from_numpy(state["data"])
        if "dtype" in state:
            self._data = self._data.to(normalize_dtype(state["dtype"]))
        self._grad = None
        self._grad_req = "null"
        self._is_var = False
        self._stype = state.get("stype", "default")
        self._fresh_grad = False

    def _adopt(self, new_data):
        """In-place mutation: rebind to ``new_data`` (a new tensor),
        dropping the recorded history."""
        self._data = (autograd.as_leaf(new_data) if self._is_var
                      else new_data.detach())

    # ---------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer (reference ndarray.py attach_grad).

        grad_req='null' marks the array as a variable without a buffer
        (no gradient will be written); 'add' accumulates across
        backward calls.  Sparse ``stype`` is not ported yet."""
        if stype not in (None, "default"):
            raise MXNetError(f"grad stype {stype!r} is not ported yet")
        self._grad_req = grad_req
        self._grad = None if grad_req == "null" else NDArray(
            torch.zeros_like(self._data, requires_grad=False))
        autograd._register(self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ---------------------------------------------------------- indexing
    def __getitem__(self, key):
        if isinstance(key, onp.ndarray):
            key = array(key, dtype=key.dtype, ctx=self.context)
        if isinstance(key, NDArray):
            if key._data.dtype == torch.bool:
                # boolean mask: data-dependent shape, not recorded
                return NDArray(self._data.detach()[key._data])
            return invoke("take", [self, key], axis=0, mode="clip")
        return invoke("_getitem", [self], key=_canonical_key(key))

    def __setitem__(self, key, value):
        if isinstance(key, NDArray):
            key = key._data if key._data.dtype == torch.bool \
                else key._data.to(torch.int64)
        else:
            key = _canonical_key(key)
        if isinstance(value, NDArray):
            v = value._data.detach()
        elif isinstance(value, torch.Tensor):
            v = value.detach()
        else:
            v = torch.as_tensor(onp.asarray(value))
        cur = self._data.detach()
        v = v.to(cur.device, cur.dtype)
        if key is Ellipsis or (isinstance(key, slice)
                               and key == slice(None)):
            new = torch.broadcast_to(v, cur.shape).clone()
        else:
            new = _setitem(cur, key, v)
        self._adopt(new)

    # ------------------------------------------------------- shape manip
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        return invoke("Reshape", [self], shape=shape)

    def reshape_like(self, other):
        return invoke("reshape_like", [self, other])

    # ------------------------------------------------------- arithmetic
    def __add__(self, other):
        return _binary(self, other, "broadcast_add", "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _binary(self, other, "broadcast_sub", "_rminus_scalar",
                       swap=True)

    def __mul__(self, other):
        return _binary(self, other, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _binary(self, other, "broadcast_div", "_rdiv_scalar",
                       swap=True)

    def __mod__(self, other):
        return _binary(self, other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return _binary(self, other, "broadcast_mod", "_rmod_scalar",
                       swap=True)

    def __pow__(self, other):
        return _binary(self, other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _binary(self, other, "broadcast_power", "_rpower_scalar",
                       swap=True)

    def __neg__(self):
        return invoke("negative", [self])

    def __abs__(self):
        return invoke("abs", [self])

    def __matmul__(self, other):
        return invoke("_npi_matmul", [self, other])

    def __iadd__(self, other):
        self._adopt(self.__add__(other)._data)
        return self

    def __isub__(self, other):
        self._adopt(self.__sub__(other)._data)
        return self

    def __imul__(self, other):
        self._adopt(self.__mul__(other)._data)
        return self

    def __itruediv__(self, other):
        self._adopt(self.__truediv__(other)._data)
        return self

    def __eq__(self, other):
        if other is None:
            return False
        return _binary(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return _binary(self, other, "broadcast_not_equal",
                       "_not_equal_scalar")

    def __gt__(self, other):
        return _binary(self, other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return _binary(self, other, "broadcast_greater_equal",
                       "_greater_equal_scalar")

    def __lt__(self, other):
        return _binary(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _binary(self, other, "broadcast_lesser_equal",
                       "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # numpy interop
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _setitem(t, key, v):
    """A copy of ``t`` with ``t[key] = v``, numpy's semantics (a
    backwards slice writes through a flip, as ``index`` reads)."""
    from ..ops.shape_ops import forward_key

    flips, idx = forward_key(t, key)
    new = torch.flip(t, flips) if flips else t.clone()
    new[idx] = v
    return torch.flip(new, flips) if flips else new


def _canonical_key(key):
    """Normalize an index expression (the reference's rules: a list is
    a tuple of indices, numpy integers are ints)."""
    if isinstance(key, list):
        key = tuple(key)
    if isinstance(key, tuple):
        return tuple(int(k) if isinstance(k, integer_types) else k
                     for k in key)
    if isinstance(key, integer_types):
        return int(key)
    return key


def _binary(lhs, rhs, elem_op, scalar_op, swap=False):
    """Dispatch a binary dunder: NDArray rhs -> elementwise op, python
    scalar -> *_scalar op, array-like -> wrap then elementwise.  ``swap``
    marks reflected dunders (__rsub__ etc.): operand order is reversed
    for the elementwise path."""
    if isinstance(rhs, numeric_types):
        return invoke(scalar_op, [lhs], scalar=float(rhs))
    if isinstance(rhs, (onp.ndarray, list, tuple)):
        rhs = array(rhs, dtype=lhs._data.dtype, ctx=lhs.context)
    if isinstance(rhs, NDArray):
        pair = [rhs, lhs] if swap else [lhs, rhs]
        return invoke(elem_op, pair)
    raise TypeError(f"unsupported operand type {type(rhs)}")


# ============================================================== dispatcher
def _as_tensor(x, like):
    """A non-NDArray input as a tensor beside the op's NDArray inputs
    (numpy's 64-bit types narrowed as the reference's jnp.asarray
    narrows them)."""
    if isinstance(x, torch.Tensor):
        return x
    a = onp.asarray(x)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype))  # a C-ordered copy
    dev = like._data.device if like is not None \
        else current_context().torch_device()
    return torch.from_numpy(a).to(dev)


class _Constant(torch.autograd.Function):
    """A recorded op's float output that does not depend differentiably
    on its inputs (BlockGrad, zeros_like, comparisons cast back): kept
    on the tape with a zero gradient, as the reference records it."""

    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.like = [(i.shape, i.dtype, i.device) for i in inputs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(torch.zeros(s, dtype=d, device=dev)
                               for s, d, dev in ctx.like)


def _taped(v, tensors, tracked):
    """An output of a recorded op with a history of its own: one that
    is an input (make_loss, a no-op reshape) becomes a view, a constant
    float one a :class:`_Constant`."""
    if v.requires_grad:
        return v.view_as(v) if any(v is t for t in tensors) else v
    if v.is_floating_point():
        return _Constant.apply(v, *tracked)
    return v


def invoke(op, inputs, out=None, **params):
    """Apply a registered op to NDArrays — the single dispatch point.

    Reference parity: MXImperativeInvokeEx -> Imperative::Invoke
    (src/imperative/imperative.cc:89).  The op runs under
    ``torch.set_grad_enabled``: torch records it only inside
    ``autograd.record()`` and only for a differentiable op; the outputs
    of a non-differentiable op are constants.
    """
    opdef: OpDef = get_op(op) if isinstance(op, str) else op
    params = {k: v for k, v in params.items() if v is not None}
    first = next((i for i in inputs if isinstance(i, NDArray)), None)
    tensors = [i._data if isinstance(i, NDArray) else _as_tensor(i, first)
               for i in inputs]
    if opdef.key_param and opdef.key_param not in params:
        # the generator a random op draws from, on its output's device
        dev = tensors[0].device if tensors else _device(params.get("ctx"))
        params[opdef.key_param] = _rng.take_key(dev)
    if opdef.train_param and opdef.train_param not in params:
        params[opdef.train_param] = autograd.is_training()
    recording = autograd.is_recording() and opdef.differentiable
    with torch.set_grad_enabled(recording):
        out_vals = opdef.fn(*tensors, **params)
    single = not isinstance(out_vals, (tuple, list))
    vals = (out_vals,) if single else tuple(out_vals)
    tracked = []
    if recording:
        tracked = [t for t in tensors if t.requires_grad]
        if tracked:
            vals = tuple(_taped(v, tensors, tracked) for v in vals)
    else:
        vals = tuple(v.detach() if v.requires_grad else v for v in vals)
    outs = [NDArray(v) for v in vals]
    for o in outs:
        if tracked and not o._data.requires_grad:
            # an integer head (Cast to int32): backward from it gives
            # its inputs a zero gradient, as the reference's tape does
            o._int_tape = _Constant.apply(
                torch.zeros((), device=o._data.device), *tracked)
    if out is not None:
        tgt = [out] if isinstance(out, NDArray) else list(out)
        for t, o in zip(tgt, outs):
            t._data = o._data
        return out
    if single and opdef.out_count(params) == 1:
        return outs[0]
    return outs


# ============================================================== creation
def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device()


def array(source_array, ctx=None, dtype=None):
    """Reference semantics (python/mxnet/ndarray/utils.py array): dtype
    defaults to the source dtype for array inputs (a numpy source's
    64-bit types and a float64 tensor narrowed to 32 bits, as JAX
    without x64 narrows them), else float32."""
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = None
    if src is not None:
        if dtype is None:
            dtype = src.dtype
            if dtype == torch.float64:
                dtype = torch.float32
        return NDArray(src.to(_device(ctx), normalize_dtype(dtype),
                              copy=True))
    from_np = isinstance(source_array, onp.ndarray)
    a = onp.asarray(source_array)
    if dtype is None:
        dtype = _CANONICAL.get(a.dtype, a.dtype) if from_np \
            else onp.float32
    t = torch.from_numpy(onp.array(a, order="C"))
    return NDArray(t.to(_device(ctx), normalize_dtype(dtype)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, integer_types) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=normalize_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=normalize_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, out=None):
    r = NDArray(torch.full(_shape(shape), val, dtype=normalize_dtype(dtype),
                           device=_device(ctx)))
    if out is not None:
        out._adopt(r._data)
        return out
    return r


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step, dtype=normalize_dtype(dtype),
                     device=_device(ctx))
    if repeat != 1:
        a = torch.repeat_interleave(a, repeat)
    return NDArray(a)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    dtype = normalize_dtype(dtype)
    if endpoint:
        a = torch.linspace(start, stop, num, dtype=dtype,
                           device=_device(ctx))
    else:
        a = torch.linspace(start, stop, num + 1, dtype=dtype,
                           device=_device(ctx))[:num]
    return NDArray(a)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    dev = _device(ctx)
    M = M if M else N
    rows = torch.arange(N, device=dev)[:, None]
    cols = torch.arange(M, device=dev)[None, :]
    return NDArray((cols - rows == k).to(normalize_dtype(dtype)))


def zeros_like(data):
    return invoke("zeros_like", [data])


def ones_like(data):
    return invoke("ones_like", [data])


def concat(*data, dim=1, out=None):
    return invoke("Concat", list(data), out=out, dim=dim,
                  num_args=len(data))


def concatenate(arrays, axis=0, always_copy=True):
    return invoke("Concat", list(arrays), dim=axis, num_args=len(arrays))


def stack(*data, axis=0, out=None):
    return invoke("stack", list(data), out=out, axis=axis,
                  num_args=len(data))


def split(data, num_outputs, axis=1, squeeze_axis=False):
    return invoke("SliceChannel", [data], num_outputs=num_outputs,
                  axis=axis, squeeze_axis=squeeze_axis)


def waitall():
    """Reference: MXNDArrayWaitAll / Engine::WaitForAll."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ========================================================= serialization
# Bit-compatible with the reference .params format:
#   container: src/c_api/c_api.cc:1824 (kMXAPINDArrayListMagic = 0x112)
#   per-array: src/ndarray/ndarray.cc:1590 (NDARRAY_V2_MAGIC = 0xF993fac9,
#   stype, TShape as int32 ndim + int64 dims, Context int32x2, type flag,
#   raw little-endian data)
_ND_MAGIC_V1 = 0xF993FAC8
_ND_MAGIC_V2 = 0xF993FAC9
_ND_MAGIC_V3 = 0xF993FACA
_LIST_MAGIC = 0x112


def _save_one(buf: bytearray, arr: NDArray):
    a = arr.asnumpy()  # bfloat16 / float8 widen to float32
    if a.dtype not in NP_TO_TYPE_FLAG:
        a = a.astype(onp.float32)
    # 0-dim arrays need the V3 (np-shape) magic: under V2 ndim==0 means
    # "none array" and the reference reader stops after the shape
    # (ndarray.cc NDArray::Load)
    buf += struct.pack("<I", _ND_MAGIC_V3 if a.ndim == 0 else _ND_MAGIC_V2)
    buf += struct.pack("<i", 0)  # kDefaultStorage
    buf += struct.pack("<i", a.ndim)
    buf += struct.pack(f"<{a.ndim}q", *a.shape)
    buf += struct.pack("<ii", 1, 0)  # Context: kCPU, id 0
    buf += struct.pack("<i", NP_TO_TYPE_FLAG[a.dtype])
    buf += onp.ascontiguousarray(a).tobytes()


class _Reader:
    def __init__(self, data):
        self.d = data
        self.o = 0

    def read(self, fmt):
        vals = struct.unpack_from(fmt, self.d, self.o)
        self.o += struct.calcsize(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_tuple(self, fmt):
        vals = struct.unpack_from(fmt, self.d, self.o)
        self.o += struct.calcsize(fmt)
        return vals

    def raw(self, n):
        b = self.d[self.o:self.o + n]
        self.o += n
        return b


def _load_one(r: _Reader, ctx=None) -> NDArray:
    magic = r.read("<I")
    if magic in (_ND_MAGIC_V2, _ND_MAGIC_V3):
        stype = r.read("<i")
        if stype != 0:
            raise MXNetError("loading sparse ndarrays is not supported yet")
        ndim = r.read("<i")
        shape = r.read_tuple(f"<{ndim}q") if ndim else ()
        if magic == _ND_MAGIC_V2 and ndim == 0:
            # "none" array: the record ends here (no ctx/type/data bytes)
            return zeros((), ctx=ctx)
    elif magic == _ND_MAGIC_V1:
        ndim = r.read("<I")
        shape = r.read_tuple(f"<{ndim}q") if ndim else ()
    else:
        # legacy: magic *is* ndim, dims are uint32 (ndarray.cc LegacyTShapeLoad)
        ndim = magic
        shape = r.read_tuple(f"<{ndim}I") if ndim else ()
    r.read("<ii")  # saved Context, ignored: we place on the requested ctx
    type_flag = r.read("<i")
    np_dtype = TYPE_FLAG_TO_NP[type_flag]
    n = int(onp.prod(shape)) if shape else 1
    data = onp.frombuffer(r.raw(n * np_dtype.itemsize), dtype=np_dtype)
    t = torch.from_numpy(data.reshape(shape).copy())
    return NDArray(t.to(_device(ctx)))


def save_buffer(data) -> bytes:
    if isinstance(data, NDArray):
        arrays, keys = [data], []
    elif isinstance(data, (list, tuple)):
        arrays, keys = list(data), []
    elif isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    else:
        raise MXNetError("save expects NDArray, list or dict of NDArrays")
    buf = bytearray()
    buf += struct.pack("<QQ", _LIST_MAGIC, 0)
    buf += struct.pack("<Q", len(arrays))
    for a in arrays:
        _save_one(buf, a)
    buf += struct.pack("<Q", len(keys))
    for k in keys:
        kb = k.encode()
        buf += struct.pack("<Q", len(kb)) + kb
    return bytes(buf)


def save(fname, data):
    """Save NDArrays in the reference .params binary format."""
    with open(fname, "wb") as f:
        f.write(save_buffer(data))


def load_buffer(data: bytes, ctx=None):
    r = _Reader(data)
    magic, _reserved = r.read("<QQ")
    if magic != _LIST_MAGIC:
        raise MXNetError("invalid NDArray file format")
    count = r.read("<Q")
    arrays = [_load_one(r, ctx) for _ in range(count)]
    nkeys = r.read("<Q")
    if nkeys == 0:
        return arrays
    keys = []
    for _ in range(nkeys):
        klen = r.read("<Q")
        keys.append(r.raw(klen).decode())
    return dict(zip(keys, arrays))


def load(fname, ctx=None):
    """Load a reference-format .params file."""
    with open(fname, "rb") as f:
        return load_buffer(f.read(), ctx)
