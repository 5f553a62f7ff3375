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
later work (ROADMAP §A 14, with ``hybridize``).  The executor assumes one
device: ``group2ctx`` raises (ROADMAP §A 11 item 4).
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


def _eval_graph(sym, value_of, train, device):
    """Evaluate the DAG: ``value_of`` maps a variable name to its
    tensor.

    Returns (outputs list, aux_updates {aux_name: new tensor}).  During
    training each BatchNorm folds its batch statistics into its moving
    auxiliary states as ``m * old + (1 - m) * stat`` (the reference op
    mutates its aux inputs in place, src/operator/nn/batch_norm.cc; the
    reference threads the update out of its program, ``:66-78``)."""
    results = {}  # id(node) -> list of tensors
    aux_updates = {}
    with autograd._Scope(False, train):
        for node in sym._topo():
            if node.op is None:
                results[id(node)] = [value_of[node.name]]
                continue
            if node.op == "_group":
                continue
            vals = [results[id(inp)][oi] for (inp, oi) in node.inputs]
            opdef = get_op(node.op)
            params = dict(node.attrs)
            if opdef.key_param:
                # the bound device's generator: the backward reuses the
                # forward's masks through the tape
                params[opdef.key_param] = _rng.take_key(device)
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
                                m * old + (1.0 - m) * stat.to(old.dtype))
                results[id(node)] = [out]
                continue
            out = opdef.fn(*vals, **params)
            results[id(node)] = (list(out)
                                 if isinstance(out, (list, tuple))
                                 else [out])
    outs = [results[id(n)][i] for (n, i) in sym._outputs_list()]
    return outs, aux_updates


class Executor:
    """Graph executor (reference GraphExecutor) on one device.

    Every argument, gradient and auxiliary array is moved to the bound
    context (default: the current context, ``gpu(0)``) when the executor
    is made, as the reference co-locates them; an NDArray passed in is
    moved in place, so a caller's handle and the executor's stay one
    array."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 group2ctx=None):
        if group2ctx:
            raise MXNetError(
                "group2ctx (a graph placed over several devices) is not "
                "ported: the port's executor runs on one card "
                "(ROADMAP §A 11 item 4)")
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError(f"missing arguments: {missing}")
            self.arg_dict = {n: self._as_nd(args[n]) for n in arg_names}
        elif args is not None:
            if len(args) != len(arg_names):
                raise MXNetError(
                    f"expected {len(arg_names)} args, got {len(args)}")
            self.arg_dict = {
                n: self._as_nd(a) for n, a in zip(arg_names, args)}
        else:
            raise MXNetError("args required for bind")

        if aux_states is None:
            self.aux_dict = {}
        elif isinstance(aux_states, dict):
            self.aux_dict = {n: self._as_nd(v)
                             for n, v in aux_states.items()}
        else:
            self.aux_dict = {
                n: self._as_nd(a) for n, a in zip(aux_names, aux_states)}
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
            self.grad_dict = {n: self._as_nd(v)
                              for n, v in args_grad.items()}
        else:
            self.grad_dict = {
                n: self._as_nd(g)
                for n, g in zip(arg_names, args_grad) if g is not None}

        self._arg_names = arg_names
        self._aux_names = aux_names
        self.outputs = []
        self._pending = None  # (outputs, leaves) of a training forward
        self.grad_arrays = [self.grad_dict.get(n) for n in arg_names]
        self.arg_arrays = [self.arg_dict[n] for n in arg_names]
        self.aux_arrays = [self.aux_dict[n] for n in aux_names]

    def _as_nd(self, v):
        """``v`` as an NDArray on the executor's device (an NDArray
        elsewhere is moved in place)."""
        if not isinstance(v, nd.NDArray):
            return nd.array(onp.asarray(v), ctx=self._ctx)
        if v._data.device != self._device:
            v._adopt(v._data.to(self._device))
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
            self.arg_dict[k]._adopt(src.to(self._device))

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
            outs, aux_updates = _eval_graph(self._symbol, value_of,
                                            is_train, self._device)
        self._pending = (outs, leaves) if leaves else None
        for name, val in aux_updates.items():
            self.aux_dict[name]._adopt(val)
        self.outputs = [nd.NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Write (or, under grad_req ``add``, accumulate) each argument's
        gradient into ``grad_dict`` (reference GraphExecutor::Backward).
        ``out_grads`` default to ones."""
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
        for n, g in zip(names, grads):
            req = self._grad_req.get(n, "write")
            if req == "null" or n not in self.grad_dict:
                continue
            tgt = self.grad_dict[n]
            if g is None:
                g = torch.zeros_like(leaves[n])
            g = g.to(tgt._data.dtype)
            tgt._adopt(tgt._data + g if req == "add" else g)

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
                        dict(self.aux_dict))

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
                    store[n]._adopt(src.to(self._device,
                                           store[n]._data.dtype))
                elif not allow_extra_params:
                    raise MXNetError(f"extra {what} {n}")

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))
