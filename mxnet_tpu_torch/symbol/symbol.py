"""Symbol: the declarative graph API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

Reference parity: python/mxnet/symbol/symbol.py (``Symbol`` composition
:55, ``infer_shape`` :1045, ``bind``/``simple_bind`` :1504/:1806,
``tojson`` :1369) and the nnvm graph JSON schema, including the legacy
"param"-style upgrade path (src/nnvm/legacy_json_util.cc).

A Symbol is a lightweight DAG of (op, inputs, attrs) over the port's op
registry; ``tojson`` writes the reference's bytes for the same graph.
``bind`` makes an :class:`~.executor.Executor`, which evaluates the DAG
node by node with torch ops on the bound device.
"""
from __future__ import annotations

import json

import numpy as onp

from ..base import MXNetError
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "AttrScope"]


class AttrScope:
    """Attribute scope applied to every symbol created inside it
    (reference python/mxnet/attribute.py AttrScope): the manual
    model-parallel API tags ops with a context group,

        with mx.AttrScope(ctx_group="dev1"):
            h = mx.sym.FullyConnected(x, num_hidden=128)

    and ``bind(group2ctx={"dev1": mx.gpu(0)})`` maps each group to a
    device (see symbol/executor.py).  Keys are stored decorated as
    ``__key__`` (the reference's convention for framework attrs)."""

    import threading as _threading

    _local = _threading.local()

    def __init__(self, **attrs):
        self._attrs = {f"__{k}__": str(v) for k, v in attrs.items()}
        self._prev = None

    @classmethod
    def current(cls):
        return getattr(cls._local, "attrs", {})

    def __enter__(self):
        self._prev = dict(self.current())
        merged = dict(self._prev)
        merged.update(self._attrs)
        AttrScope._local.attrs = merged
        return self

    def __exit__(self, *exc):
        AttrScope._local.attrs = self._prev
        return False

_UNNAMED_COUNT = {}


def _auto_name(hint):
    n = _UNNAMED_COUNT.get(hint, 0)
    _UNNAMED_COUNT[hint] = n + 1
    return f"{hint}{n}"


# op input-name metadata: which op inputs are auxiliary states
# (reference: mutable inputs declared by the op, e.g. BatchNorm moving
# stats — nnvm FMutateInputs)
_AUX_INPUTS = {
    "BatchNorm": (3, 4),
    "BatchNorm_v1": (3, 4),
    "SyncBatchNorm": (3, 4),
}

class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "attr_dict")

    def __init__(self, op, name, attrs, inputs, num_outputs=1,
                 attr_dict=None):
        self.op = op  # None for variables, else registry op name
        self.name = name
        self.attrs = attrs  # op hyper-params {str: value}
        self.inputs = inputs  # list of (node, out_idx)
        self.num_outputs = num_outputs
        self.attr_dict = attr_dict or {}  # user attrs (lr_mult etc.)


class Symbol:
    """Handle to one or more outputs of a graph node."""

    def __init__(self, node, out_index=None):
        self._node = node
        self._out = out_index  # None = all outputs

    # ----------------------------------------------------------- info
    @property
    def name(self):
        if self._node.num_outputs > 1 and self._out is not None:
            return f"{self._node.name}_output{self._out}"
        return self._node.name

    def attr(self, key):
        return self._node.attr_dict.get(key)

    def attr_dict(self):
        out = {}
        for node in self._topo():
            if node.attr_dict:
                out[node.name] = dict(node.attr_dict)
        return out

    def list_attr(self):
        return dict(self._node.attr_dict)

    def _outputs_list(self):
        if self._out is not None:
            return [(self._node, self._out)]
        if self._node.op == "_group":
            outs = []
            for (n, i) in self._node.inputs:
                outs.append((n, i))
            return outs
        return [(self._node, i) for i in range(self._node.num_outputs)]

    @property
    def num_outputs(self):
        return len(self._outputs_list())

    def __getitem__(self, index):
        outs = self._outputs_list()
        if isinstance(index, str):
            names = [self._out_name(n, i) for (n, i) in outs]
            if index not in names:
                raise MXNetError(f"no output named {index}")
            index = names.index(index)
        node, oidx = outs[index]
        return Symbol(node, oidx)

    @staticmethod
    def _out_name(node, i):
        """Reference convention: op outputs are '<name>_output' (indexed
        when the op has several); variables keep their own name."""
        if node.op is None:
            return node.name
        if node.num_outputs > 1:
            return f"{node.name}_output{i}"
        return f"{node.name}_output"

    def __iter__(self):
        return (self[i] for i in range(self.num_outputs))

    def __len__(self):
        return self.num_outputs

    def _topo(self):
        """Topological order of reachable nodes."""
        order, seen = [], set()
        stack = [(self._node, False)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for (inp, _) in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
        return order

    def list_arguments(self):
        return [n.name for n in self._topo()
                if n.op is None and not n.attr_dict.get("__aux__")]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo()
                if n.op is None and n.attr_dict.get("__aux__")]

    def list_outputs(self):
        return [self._out_name(n, i) for (n, i) in self._outputs_list()]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def get_internals(self):
        nodes = [n for n in self._topo()]
        outs = []
        for n in nodes:
            for i in range(n.num_outputs):
                outs.append((n, i))
        g = _Node("_group", _auto_name("group"), {},
                  outs, num_outputs=len(outs))
        return Symbol(g)

    def get_children(self):
        if not self._node.inputs:
            return None
        g = _Node("_group", _auto_name("group"), {},
                  list(self._node.inputs),
                  num_outputs=len(self._node.inputs))
        return Symbol(g)

    # ------------------------------------------------------- arithmetic
    def _binary(self, other, opname, scalar_op, reverse=False):
        # reverse variants are dedicated ops (_rminus_scalar, ...)
        if isinstance(other, Symbol):
            return _make_op_symbol(opname, [self, other], {}, None)
        return _make_op_symbol(scalar_op, [self],
                               {"scalar": float(other)}, None)

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_rdiv_scalar",
                            reverse=True)

    def __pow__(self, other):
        return self._binary(other, "_power", "_power_scalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    # comparisons (reference symbol.py __gt__/...: 1.0/0.0 outputs)
    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __eq__(self, other):
        if not isinstance(other, (Symbol, int, float)):
            return NotImplemented
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if not isinstance(other, (Symbol, int, float)):
            return NotImplemented
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __hash__(self):
        return id(self._node) ^ hash(self._out)

    def __bool__(self):
        # __eq__ builds a graph node, so truthiness of a comparison is
        # meaningless — fail loudly (reference NotImplementedForSymbol)
        raise MXNetError(
            "a Symbol has no boolean value; use `is`/`is not` for "
            "identity, or execute the graph for elementwise comparison")

    # ------------------------------------------------------- evaluation
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) via abstract evaluation
        on ``meta`` tensors."""
        known = dict(kwargs)
        if args:
            for name, s in zip(self.list_arguments(), args):
                if s is not None:
                    known[name] = s
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        shapes = _infer_all_shapes(self, known)
        if shapes is None:
            return None, None, None
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in aux_names]
        out_shapes = [shapes[("__out__", i)]
                      for i in range(self.num_outputs)]
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        dt = onp.float32
        return ([dt] * len(arg_names),
                [dt] * self.num_outputs,
                [dt] * len(self.list_auxiliary_states()))

    # -------------------------------------------------------------- io
    def tojson(self):
        """Serialize in the reference nnvm JSON schema
        (symbol.py:1369)."""
        # synthetic _group containers are not real graph nodes — heads
        # reference their members directly
        nodes_list = [n for n in self._topo() if n.op != "_group"]
        node_id = {id(n): i for i, n in enumerate(nodes_list)}
        nodes = []
        arg_nodes = []
        for i, n in enumerate(nodes_list):
            entry = {
                "op": "null" if n.op is None else n.op,
                "name": n.name,
                "inputs": [[node_id[id(inp)], oi, 0]
                           for (inp, oi) in n.inputs],
            }
            attrs = {k: _attr_str(v) for k, v in n.attrs.items()}
            if attrs:
                entry["attrs"] = attrs
            user_attrs = {k: str(v) for k, v in n.attr_dict.items()
                          if not k.startswith("__")
                          or k in ("__shape__", "__dtype__", "__init__")}
            if user_attrs:
                entry["attr"] = user_attrs
            if n.op is None:
                arg_nodes.append(i)
            nodes.append(entry)
        heads = [[node_id[id(n)], i, 0] for (n, i) in self._outputs_list()]
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 10600]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------- executors
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate every argument, gradient and auxiliary state from the
        inferred shapes on ``ctx`` (default: the current context) and
        bind them.  ``type_dict`` gives an argument's dtype (float32 by
        default)."""
        from .executor import Executor

        return Executor._simple_bind(self, ctx, grad_req, kwargs,
                                     group2ctx=group2ctx,
                                     type_dict=type_dict)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # gluon SymbolBlock / functional composition support
    def __call__(self, *args, **kwargs):
        s = self._clone()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        return self._clone()

    def _clone(self):
        """Deep-copy the reachable graph so composition never mutates
        the original (reference Symbol composition copies the graph)."""
        mapping = {}
        for node in self._topo():  # child-first order
            mapping[id(node)] = _Node(
                node.op, node.name, dict(node.attrs),
                [(mapping[id(inp)], oi) for (inp, oi) in node.inputs],
                num_outputs=node.num_outputs,
                attr_dict=dict(node.attr_dict))
        return Symbol(mapping[id(self._node)], self._out)

    def _compose(self, *args, **kwargs):
        """Replace variable inputs with the given symbols (reference
        Symbol composition).  Positional args map to distinct variables
        in list_inputs() order; a variable used at several sites gets the
        same replacement everywhere."""
        name = kwargs.pop("name", None)
        if name is not None:
            self._node.name = name
        if args and kwargs:
            raise MXNetError(
                "compose only accepts input Symbols either as positional "
                "or keyword arguments, not both")
        repl_of = {}  # variable node name -> replacement (node, oidx)
        for k, v in kwargs.items():
            repl_of[k] = (v._node, v._out if v._out is not None else 0)
        if args:
            pos = list(args)
            for node in self._topo():
                if node.op is None and node.name not in repl_of and pos:
                    v = pos.pop(0)
                    repl_of[node.name] = (
                        v._node, v._out if v._out is not None else 0)
        for node in self._topo():
            node.inputs = [
                repl_of[inp.name] if (inp.op is None
                                      and inp.name in repl_of)
                else (inp, oi)
                for (inp, oi) in node.inputs
            ]


def _attr_str(v):
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (list, tuple)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (reference symbol.py var())."""
    attr_dict = dict(attr or {})
    if shape is not None:
        attr_dict["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attr_dict["lr_mult"] = lr_mult
    if wd_mult is not None:
        attr_dict["wd_mult"] = wd_mult
    if dtype is not None:
        attr_dict["__dtype__"] = str(dtype)
    if init is not None:
        attr_dict["__init__"] = init if isinstance(init, str) else (
            init.dumps())
    scoped = AttrScope.current()
    if scoped:
        attr_dict = {**scoped, **attr_dict}
    node = _Node(None, name, {}, [], attr_dict=attr_dict)
    return Symbol(node)


var = Variable


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs_list())
    node = _Node("_group", _auto_name("group"), {}, outs,
                 num_outputs=len(outs))
    return Symbol(node)


def _make_op_symbol(opname, input_syms, attrs, name, num_outputs=None):
    """Create an op node (used by the generated sym.* functions)."""
    opdef = get_op(opname)
    if name is None:
        name = _auto_name(opname.lower().strip("_"))
    if num_outputs is None:
        num_outputs = opdef.out_count(attrs)
    input_syms = list(input_syms)
    slot_names = _op_input_names(opname, attrs)
    if slot_names is not None and len(input_syms) < len(slot_names):
        aux_slots = _AUX_INPUTS.get(opname, ())
        for slot in range(len(input_syms), len(slot_names)):
            v = Variable(f"{name}_{slot_names[slot]}")
            if slot in aux_slots:
                v._node.attr_dict["__aux__"] = True
            input_syms.append(v)
    from ..contrib import amp

    if amp.is_active():
        input_syms = amp.cast_symbols(opname, input_syms,
                                      keep=_AUX_INPUTS.get(opname, ()))
    inputs = []
    for s in input_syms:
        inputs.append((s._node, s._out if s._out is not None else 0))
    # explicitly-passed variables feeding aux slots (BatchNorm moving
    # stats) are aux states too, same as the auto-created ones above
    for slot in _AUX_INPUTS.get(opname, ()):
        if slot < len(inputs) and inputs[slot][0].op is None:
            inputs[slot][0].attr_dict["__aux__"] = True
    node = _Node(opname, name, attrs, inputs, num_outputs=num_outputs)
    scoped = AttrScope.current()
    if scoped:
        node.attr_dict.update(scoped)
    return Symbol(node)


def _infer_all_shapes(sym, known_shapes):
    """Abstract-evaluate the graph to resolve every variable/out shape
    (the reference InferShape pass, infer_graph_attr_pass.cc)."""
    from . import _shape_infer

    arg_names = sym.list_arguments() + sym.list_auxiliary_states()
    shapes = {}
    for n in arg_names:
        if n in known_shapes:
            shapes[n] = tuple(known_shapes[n])
    for node in sym._topo():
        if node.op is None and "__shape__" in node.attr_dict:
            shapes.setdefault(node.name, node.attr_dict["__shape__"])
    return _shape_infer.infer(sym, shapes)


# Which named inputs an op consumes, for auto-creating missing parameter
# variables (reference: sym.FullyConnected(data, num_hidden=N, name="fc")
# creates fc_weight / fc_bias; nnvm FListInputNames)
def _op_input_names(opname, attrs):
    if opname in ("FullyConnected", "Convolution", "Convolution_v1"):
        names = ["data", "weight"]
        if not attrs.get("no_bias", False):
            names.append("bias")
        return names
    if opname == "Deconvolution":
        names = ["data", "weight"]
        if not attrs.get("no_bias", True):
            names.append("bias")
        return names
    if opname in ("BatchNorm", "BatchNorm_v1", "SyncBatchNorm"):
        return ["data", "gamma", "beta", "moving_mean", "moving_var"]
    if opname in ("LayerNorm", "InstanceNorm", "GroupNorm"):
        return ["data", "gamma", "beta"]
    if opname == "Embedding":
        return ["data", "weight"]
    if opname == "LeakyReLU" and attrs.get("act_type") == "prelu":
        return ["data", "gamma"]
    if opname in ("SoftmaxOutput", "LinearRegressionOutput",
                  "LogisticRegressionOutput", "MAERegressionOutput",
                  "SVMOutput"):
        return ["data", "label"]
    if opname == "RNN":
        names = ["data", "parameters", "state"]
        if attrs.get("mode", "lstm") == "lstm":
            names.append("state_cell")
        return names
    return None  # unknown: no auto-creation


def load_json(json_str):
    """Parse reference JSON (modern attrs or legacy param schema —
    legacy_json_util.cc upgrade path)."""
    data = json.loads(json_str)
    nodes_json = data["nodes"]
    built = []
    for nj in nodes_json:
        op = nj["op"]
        attrs_raw = nj.get("attrs", nj.get("param", {})) or {}
        if isinstance(attrs_raw, list):
            attrs_raw = dict(attrs_raw)
        user_attr = nj.get("attr", {}) or {}
        inputs = [(built[i], oi) for i, oi, *_ in nj.get("inputs", [])]
        if op == "null":
            ad = dict(user_attr)
            if isinstance(ad.get("__shape__"), str):
                import ast

                ad["__shape__"] = tuple(
                    ast.literal_eval(ad["__shape__"]))
            node = _Node(None, nj["name"], {}, [], attr_dict=ad)
        else:
            opdef = get_op(op)  # raises for unknown op
            attrs = _parse_attrs(op, attrs_raw)
            node = _Node(op, nj["name"], attrs, inputs,
                         num_outputs=opdef.out_count(attrs),
                         attr_dict=dict(user_attr))
            # legacy (v0.8 "param"-schema) graphs omit aux-state inputs
            # (BatchNorm moving stats); append fresh variables for them
            slot_names = _op_input_names(op, attrs)
            if slot_names is not None and len(inputs) < len(slot_names):
                aux_slots = _AUX_INPUTS.get(op, ())
                for slot in range(len(inputs), len(slot_names)):
                    v = _Node(None, f"{nj['name']}_{slot_names[slot]}",
                              {}, [])
                    if slot in aux_slots:
                        v.attr_dict["__aux__"] = True
                    node.inputs.append((v, 0))
        built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    if len(heads) == 1:
        h = heads[0]
        sym = Symbol(built[h[0]], h[1] if built[h[0]].num_outputs > 1
                     else None)
        if built[h[0]].num_outputs == 1:
            sym = Symbol(built[h[0]], None)
        _mark_aux(sym)
        return sym
    outs = [(built[h[0]], h[1]) for h in heads]
    g = _Node("_group", _auto_name("group"), {}, outs,
              num_outputs=len(outs))
    sym = Symbol(g)
    _mark_aux(sym)
    return sym


def _mark_aux(sym):
    """Tag variables feeding aux input slots (BatchNorm moving stats)."""
    for node in sym._topo():
        if node.op in _AUX_INPUTS:
            for slot in _AUX_INPUTS[node.op]:
                idx = slot  # input slot index incl. data at 0
                if idx < len(node.inputs):
                    inp, _ = node.inputs[idx]
                    if inp.op is None:
                        inp.attr_dict["__aux__"] = True


def _parse_attrs(opname, raw):
    """Parse string attr values to python (reference dmlc::Parameter
    string-kwarg parsing)."""
    import ast

    opdef = get_op(opname)
    valid = set(opdef.param_names)
    out = {}
    for k, v in raw.items():
        if k not in valid:
            continue  # an attribute the op does not take
        if not isinstance(v, str):
            out[k] = v
            continue
        s = v.strip()
        try:
            out[k] = ast.literal_eval(s)
            continue
        except (ValueError, SyntaxError):
            pass
        if s in ("True", "true"):
            out[k] = True
        elif s in ("False", "false"):
            out[k] = False
        else:
            out[k] = s
    return out


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


