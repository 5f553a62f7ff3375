"""Shape inference over a Symbol DAG (counterpart of
``mxnet_tpu/symbol/_shape_infer.py``).

Reference parity: src/executor/infer_graph_attr_pass.cc (InferShape pass)
— one forward topological sweep; unshaped parameter variables feeding a
parameterized op are deduced from the op's convention (the reference
encodes the same rules in each op's FInferShape).

Each node is evaluated on ``torch.device("meta")`` tensors, which carry
shapes and no data (the reference's ``jax.eval_shape``).  A CUDA
kernel's wrapper takes its plain version there, as it does on the host:
only a CUDA tensor launches a kernel.  An op that cannot run on meta
tensors fails the inference with its name; no shape is guessed.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops.registry import get_op

_META = torch.device("meta")


def _tup(v, n, default=1):
    if v is None:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _deduce_param_shapes(op, attrs, input_shapes, slot_names):
    """Given the data input shape (slot 0), return {slot: shape} for
    parameter slots that are still unknown."""
    data = input_shapes[0]
    if data is None:
        return {}
    out = {}
    if op == "FullyConnected":
        flatten = attrs.get("flatten", True)
        num_hidden = attrs["num_hidden"]
        in_units = (int(math.prod(data[1:])) if flatten else data[-1])
        out[1] = (num_hidden, in_units)
        out[2] = (num_hidden,)
    elif op in ("Convolution", "Convolution_v1"):
        kernel = _tup(attrs["kernel"], 0)
        num_filter = attrs["num_filter"]
        num_group = attrs.get("num_group", 1)
        out[1] = (num_filter, data[1] // num_group) + tuple(kernel)
        out[2] = (num_filter,)
    elif op == "Deconvolution":
        kernel = _tup(attrs["kernel"], 0)
        num_filter = attrs["num_filter"]
        num_group = attrs.get("num_group", 1)
        out[1] = (data[1], num_filter // num_group) + tuple(kernel)
        out[2] = (num_filter,)
    elif op in ("BatchNorm", "BatchNorm_v1", "SyncBatchNorm"):
        axis = attrs.get("axis", 1)
        c = data[axis % len(data)]
        for slot in (1, 2, 3, 4):
            out[slot] = (c,)
    elif op == "InstanceNorm":
        out[1] = (data[1],)
        out[2] = (data[1],)
    elif op == "LayerNorm":
        axis = attrs.get("axis", -1)
        c = data[axis % len(data)]
        out[1] = (c,)
        out[2] = (c,)
    elif op == "GroupNorm":
        ng = attrs.get("num_groups", 1)
        out[1] = (ng,)
        out[2] = (ng,)
    elif op == "Embedding":
        out[1] = (attrs["input_dim"], attrs["output_dim"])
    elif op == "LeakyReLU" and attrs.get("act_type") == "prelu":
        out[1] = (data[1],)
    elif op in ("SoftmaxOutput", "Softmax"):
        # sparse class labels: one per leading-dims element
        out[1] = tuple(data[:-1]) if not attrs.get("multi_output") else (
            (data[0],) + tuple(data[2:]))
    elif op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                "MAERegressionOutput", "SVMOutput"):
        out[1] = tuple(data)
    elif op == "RNN":
        from ..ops.rnn import rnn_param_size

        mode = attrs.get("mode", "lstm")
        nl = attrs.get("num_layers", 1)
        h = attrs["state_size"]
        bi = attrs.get("bidirectional", False)
        proj = attrs.get("projection_size")
        r = proj if proj else h
        d = 2 if bi else 1
        t, n, input_size = data
        out[1] = (rnn_param_size(mode, nl, input_size, h, bi, proj),)
        out[2] = (nl * d, n, r)
        out[3] = (nl * d, n, h)
    return out


def _abstract_eval(opdef, node, in_shapes, in_dtypes):
    """The output shapes and dtypes of one node from its inputs'."""
    params = dict(node.attrs)
    if opdef.key_param:
        params[opdef.key_param] = torch.Generator()  # shapes only
    if opdef.train_param and opdef.train_param not in params:
        params[opdef.train_param] = False
    metas = [torch.empty(s, dtype=d, device=_META)
             for s, d in zip(in_shapes, in_dtypes)]
    try:
        with torch.no_grad():
            out = opdef.fn(*metas, **params)
    except Exception as e:
        raise MXNetError(
            f"InferShape failed at op {node.op}({node.name}) with "
            f"input shapes {in_shapes}: {e}") from e
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [tuple(o.shape) for o in outs], [o.dtype for o in outs]


def _var_dtype(node):
    """A variable's dtype: its ``__dtype__`` attribute (a quantized
    layer's int8 or e4m3 constant), else float32."""
    from ..dtype import attr_dtype_name, normalize_dtype

    return normalize_dtype(attr_dtype_name(node.attr_dict.get("__dtype__")))


def infer(sym, shapes):
    """Return {var_name: shape, ("__out__", i): shape} or raise.  Each
    node is evaluated on its inputs' dtypes (a variable's
    ``__dtype__``), so an int8 graph traces in int8."""
    node_out_shapes = {}  # id(node) -> [shape per output]
    node_out_dtypes = {}  # id(node) -> [dtype per output]

    for node in sym._topo():
        if node.op is None:
            s = shapes.get(node.name)
            node_out_shapes[id(node)] = [s]
            node_out_dtypes[id(node)] = [_var_dtype(node)]
            continue
        if node.op == "_group":
            continue
        in_shapes = [node_out_shapes[id(inp)][oi]
                     for (inp, oi) in node.inputs]
        # deduce unknown parameter-variable shapes
        if any(s is None for s in in_shapes):
            deduced = _deduce_param_shapes(node.op, node.attrs, in_shapes,
                                           None)
            for slot, shape in deduced.items():
                if slot < len(node.inputs) and in_shapes[slot] is None:
                    inp, oi = node.inputs[slot]
                    if inp.op is None:
                        shapes[inp.name] = shape
                        node_out_shapes[id(inp)] = [shape]
                        in_shapes[slot] = shape
            # elementwise fallback: same-shape as first known input
            if any(s is None for s in in_shapes):
                known = next((s for s in in_shapes if s is not None), None)
                if known is not None and node.op.startswith(
                        ("elemwise_", "_plus", "_minus", "_mul", "_div")):
                    for i, s in enumerate(in_shapes):
                        if s is None:
                            inp, oi = node.inputs[i]
                            if inp.op is None:
                                shapes[inp.name] = known
                                node_out_shapes[id(inp)] = [known]
                                in_shapes[i] = known
        if any(s is None for s in in_shapes):
            missing = [n.name for (n, _), s in zip(node.inputs, in_shapes)
                       if s is None]
            raise MXNetError(
                f"InferShape: cannot deduce shapes of {missing} feeding "
                f"op {node.op}({node.name})")
        in_dtypes = [node_out_dtypes[id(inp)][oi]
                     for (inp, oi) in node.inputs]
        node_out_shapes[id(node)], node_out_dtypes[id(node)] = \
            _abstract_eval(get_op(node.op), node, in_shapes, in_dtypes)

    result = dict(shapes)
    for i, (n, oi) in enumerate(sym._outputs_list()):
        result[("__out__", i)] = node_out_shapes[id(n)][oi]
    return result
