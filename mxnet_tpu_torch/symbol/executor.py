"""Executor: run a Symbol graph on one device (counterpart of
``mxnet_tpu/symbol/executor.py``).

Reference parity: src/executor/graph_executor.{h,cc} (``GraphExecutor``
bind/simple_bind, Forward/Backward, grad_req write/add/null).

The reference compiles the whole graph into one XLA program and takes
its backward with ``jax.vjp``.  Here ``forward`` evaluates the graph
node by node with the registered torch ops, eagerly, on the device the
executor was bound to; in training the arguments that take a gradient
enter as leaves that require grad, and ``backward`` asks
``torch.autograd.grad`` for their gradients.  Compiling the graph is
later work (ROADMAP §A 14, with ``hybridize``).

``group2ctx`` (manual model parallelism, reference ``executor.py:35-60``):
each node tagged ``__ctx_group__`` (``AttrScope(ctx_group=...)``) runs on
its group's device, untagged nodes on the bind context; an input whose
node sits in another group crosses with one ``Tensor.to(device)``, which
autograd carries the gradient back across.  ``placement`` records the
context each node was given and ``transfers`` the crossings of the last
forward (on the CPU every ``cpu(i)`` is the one host device: the
placement is recorded, nothing moves; ROADMAP §C).
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import _rng, autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..context import current_context
from ..ops.registry import get_op

__all__ = ["Executor"]


_BN_OPS = ("BatchNorm", "BatchNorm_v1", "SyncBatchNorm")


def _group_of(node):
    return (node.attr_dict or {}).get("__ctx_group__")


def _eval_graph(sym, value_of, train, device, placement=None):
    """Evaluate the DAG: ``value_of`` maps a variable name to its
    tensor.

    Returns (outputs list, aux_updates {aux_name: new tensor}, the
    number of group-boundary crossings).  During training each BatchNorm
    folds its batch statistics into its moving auxiliary states as ``m *
    old + (1 - m) * stat`` (the reference op mutates its aux inputs in
    place, src/operator/nn/batch_norm.cc; the reference threads the
    update out of its program, ``:66-78``).

    ``placement`` ({group or None: (context, torch device)}, from
    ``group2ctx``): each op runs on its group's device, and an input
    made in another group moves there with one ``Tensor.to``."""
    results = {}  # id(node) -> list of tensors
    where = {}    # id(node) -> its group's context
    aux_updates = {}
    crossings = 0
    with autograd._Scope(False, train):
        for node in sym._topo():
            if node.op == "_group":
                continue
            ctx, dev = (None, device) if placement is None else \
                placement.get(_group_of(node), placement[None])
            where[id(node)] = ctx
            if node.op is None:
                results[id(node)] = [value_of[node.name]]
                continue
            vals = [results[id(inp)][oi] for (inp, oi) in node.inputs]
            if placement is not None:
                for i, (inp, _) in enumerate(node.inputs):
                    if where[id(inp)] != ctx:
                        crossings += 1
                        vals[i] = vals[i].to(dev)
            opdef = get_op(node.op)
            params = dict(node.attrs)
            if opdef.key_param:
                # the node's device's generator: the backward reuses the
                # forward's masks through the tape
                params[opdef.key_param] = _rng.take_key(dev)
            if opdef.train_param and opdef.train_param not in params:
                params[opdef.train_param] = train
            if (node.op in _BN_OPS and train
                    and not params.get("use_global_stats", False)):
                params["output_mean_var"] = True
                out, batch_mean, batch_var = opdef.fn(*vals, **params)
                m = params.get("momentum", 0.9)
                for slot, stat in ((3, batch_mean), (4, batch_var)):
                    inp, _ = node.inputs[slot]
                    if inp.op is None:
                        old = value_of[inp.name]
                        with torch.no_grad():
                            aux_updates[inp.name] = (
                                m * old + (1.0 - m) * stat.to(
                                    old.device, old.dtype))
                results[id(node)] = [out]
                continue
            out = opdef.fn(*vals, **params)
            results[id(node)] = (list(out)
                                 if isinstance(out, (list, tuple))
                                 else [out])
    outs = [results[id(n)][i] for (n, i) in sym._outputs_list()]
    return outs, aux_updates, crossings


class Executor:
    """Graph executor (reference GraphExecutor).

    Every argument, gradient and auxiliary array is moved to the bound
    context (default: the current context, ``gpu(0)``) when the executor
    is made, as the reference co-locates them; an NDArray passed in is
    moved in place, so a caller's handle and the executor's stay one
    array.  Under ``group2ctx`` a variable tagged with a group lives on
    that group's device instead."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        self._group2ctx = dict(group2ctx) if group2ctx else None
        # variable name -> its device (the bind device unless grouped)
        self._var_dev = {}
        self.placement = {}
        self.transfers = 0
        placement = None
        if self._group2ctx:
            placement = {None: (self._ctx, self._device)}
            placement.update({g: (c, c.torch_device())
                              for g, c in self._group2ctx.items()})
            for node in symbol._topo():
                if node.op == "_group":
                    continue
                c, d = placement.get(_group_of(node), placement[None])
                self.placement[node.name] = str(c)
                if node.op is None:
                    self._var_dev[node.name] = d
        self._placement = placement
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError(f"missing arguments: {missing}")
            self.arg_dict = {n: self._as_nd(args[n], n) for n in arg_names}
        elif args is not None:
            if len(args) != len(arg_names):
                raise MXNetError(
                    f"expected {len(arg_names)} args, got {len(args)}")
            self.arg_dict = {
                n: self._as_nd(a, n) for n, a in zip(arg_names, args)}
        else:
            raise MXNetError("args required for bind")

        if aux_states is None:
            self.aux_dict = {}
        elif isinstance(aux_states, dict):
            self.aux_dict = {n: self._as_nd(v, n)
                             for n, v in aux_states.items()}
        else:
            self.aux_dict = {
                n: self._as_nd(a, n) for n, a in zip(aux_names, aux_states)}
        for n in aux_names:
            if n not in self.aux_dict:
                raise MXNetError(f"missing auxiliary state {n}")

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req)
        if args_grad is None:
            self.grad_dict = {}
        elif isinstance(args_grad, dict):
            self.grad_dict = {n: self._as_nd(v, n)
                              for n, v in args_grad.items()}
        else:
            self.grad_dict = {
                n: self._as_nd(g, n)
                for n, g in zip(arg_names, args_grad) if g is not None}

        self._arg_names = arg_names
        self._aux_names = aux_names
        self.outputs = []
        self._pending = None  # (outputs, leaves) of a training forward
        self.grad_arrays = [self.grad_dict.get(n) for n in arg_names]
        self.arg_arrays = [self.arg_dict[n] for n in arg_names]
        self.aux_arrays = [self.aux_dict[n] for n in aux_names]

    def _dev(self, name):
        """The device of variable ``name``: its group's, else the bind
        device."""
        return self._var_dev.get(name, self._device)

    def _as_nd(self, v, name=None):
        """``v`` as an NDArray on variable ``name``'s device (an NDArray
        elsewhere is moved in place)."""
        dev = self._dev(name)
        if not isinstance(v, nd.NDArray):
            v = nd.array(onp.asarray(v), ctx=self._ctx)
        if v._data.device != dev:
            v._adopt(v._data.to(dev))
        return v

    @classmethod
    def _simple_bind(cls, symbol, ctx, grad_req, shape_kwargs,
                     group2ctx=None, type_dict=None):
        """Allocate args/grads/aux from inferred shapes (reference
        simple_bind, graph_executor.cc:803)."""
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        if arg_shapes is None or any(s is None for s in arg_shapes):
            raise MXNetError(
                "simple_bind: could not infer all argument shapes from "
                f"{shape_kwargs}")
        ctx = ctx or current_context()
        types = dict(type_dict or {})
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        args = {n: nd.zeros(s, ctx=ctx, dtype=types.get(n))
                for n, s in zip(arg_names, arg_shapes)}
        aux = {n: nd.zeros(s, ctx=ctx, dtype=types.get(n))
               for n, s in zip(aux_names, aux_shapes)}
        grads = {
            n: nd.zeros(s, ctx=ctx, dtype=types.get(n))
            for n, s in zip(arg_names, arg_shapes)
            if (grad_req if isinstance(grad_req, str)
                else grad_req.get(n, "write")) != "null"
        }
        return cls(symbol, ctx, args, grads, grad_req, aux,
                   group2ctx=group2ctx)

    # ------------------------------------------------------------- run
    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; ``kwargs`` feed arguments by name (moved
        to the executor's device).  With ``is_train`` the BatchNorm
        moving statistics are updated and, when any argument takes a
        gradient, the graph is kept for :meth:`backward`.  The graph runs
        under ``autotune.program_scope`` of the first argument."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown argument {k}")
            src = v._data if isinstance(v, nd.NDArray) else \
                torch.from_numpy(onp.asarray(v))
            self.arg_dict[k]._adopt(src.to(self._dev(k)))

        value_of = {n: self.aux_dict[n]._data for n in self._aux_names}
        leaves = {}
        for n in self._arg_names:
            t = self.arg_dict[n]._data
            if is_train and self._grad_req.get(n, "write") != "null" \
                    and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves[n] = t
            value_of[n] = t
        # the cached autotune winners of the first argument's signature
        # apply to the evaluation (reference ``executor.py:316-323``)
        from .. import autotune

        first = self.arg_dict[self._arg_names[0]]._data \
            if self._arg_names else None
        scope = autotune.program_scope(
            () if first is None else tuple(first.shape),
            "none" if first is None else first.dtype,
            platform=self._device.type)
        with torch.set_grad_enabled(bool(leaves)), scope:
            outs, aux_updates, self.transfers = _eval_graph(
                self._symbol, value_of, is_train, self._device,
                self._placement)
        self._pending = (outs, leaves) if leaves else None
        for name, val in aux_updates.items():
            self.aux_dict[name]._adopt(val)
        self.outputs = [nd.NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True, reduce_grads=None):
        """Write (or, under grad_req ``add``, accumulate) each argument's
        gradient into ``grad_dict`` (reference GraphExecutor::Backward).
        ``out_grads`` default to ones.  ``reduce_grads`` ({name: grad} ->
        the same, in place), when given, sees this backward's gradients
        before they are written or added (the Module's exchange over a
        process mesh)."""
        if self._pending is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            cts = [(g._data if isinstance(g, nd.NDArray)
                    else torch.as_tensor(onp.asarray(g)))
                   .to(o.device, o.dtype) for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[n] for n in names],
            [c for _, c in pairs], allow_unused=True) if pairs else \
            [None] * len(names)
        fresh = {}
        for n, g in zip(names, grads):
            req = self._grad_req.get(n, "write")
            if req == "null" or n not in self.grad_dict:
                continue
            tgt = self.grad_dict[n]
            if g is None:
                g = torch.zeros_like(leaves[n])
            fresh[n] = g.to(tgt._data.device, tgt._data.dtype)
        if reduce_grads is not None:
            reduce_grads(fresh)
        for n, g in fresh.items():
            tgt = self.grad_dict[n]
            if self._grad_req.get(n, "write") == "add":
                g = tgt._data + g
            tgt._adopt(g)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor over the same weights for new input shapes
        (reference GraphExecutor::Reshape): an argument whose shape
        changes gets a new zero array, and its gradient one of the new
        shape."""
        new_args = dict(self.arg_dict)
        new_grads = dict(self.grad_dict)
        for n, s in kwargs.items():
            if n in new_args and tuple(new_args[n].shape) != tuple(s):
                new_args[n] = nd.zeros(s, ctx=self._ctx,
                                       dtype=new_args[n]._data.dtype)
                if n in new_grads:
                    new_grads[n] = nd.zeros(s, ctx=self._ctx,
                                            dtype=new_grads[n]._data.dtype)
        return Executor(self._symbol, self._ctx, new_args,
                        new_grads or None, self._grad_req,
                        dict(self.aux_dict), group2ctx=self._group2ctx)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays (each kept on this
        executor's device and in its dtype)."""
        for store, params, what in ((self.arg_dict, arg_params, "param"),
                                    (self.aux_dict, aux_params or {},
                                     "aux")):
            for n, v in params.items():
                if n in store:
                    src = v._data if isinstance(v, nd.NDArray) else \
                        torch.from_numpy(onp.asarray(v))
                    store[n]._adopt(src.to(self._dev(n),
                                           store[n]._data.dtype))
                elif not allow_extra_params:
                    raise MXNetError(f"extra {what} {n}")

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))
