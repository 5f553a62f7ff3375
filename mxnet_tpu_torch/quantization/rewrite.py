"""Net rewrite: a calibrated fp32 Gluon net becomes an int8 (or fp8)
program (counterpart of ``mxnet_tpu/quantization/rewrite.py``).

The pass runs over the Gluon block tree: each eligible leaf (Dense,
channel-first Conv, and Pooling/Flatten inside a Sequential) is
replaced by a wrapper that holds the ORIGINAL layer as its ``_orig``
child (the fp32 arm; its parameters stay collectable) plus its weights
pre-quantized on the host, and whose forward runs one of three arms,
decided per call by the autotune registry (``quantized_fc`` /
``quantized_conv``: a ``force`` scope, then ``MXNET_QUANTIZE``, then
the winner :func:`tune_quantized` applied, then int8):

* int8: calibrated ``quantize_v2`` on the input, ``quantized_fully_
  connected`` / ``quantized_conv`` accumulating int32, calibrated
  ``requantize`` (when the next wrapper takes the int8 triple) or
  ``dequantize`` on the way out;
* fp8: ``quantize_fp8`` on the input (the same calibrated range, only
  its amax), ``fp8_fully_connected`` / ``fp8_conv`` accumulating f32,
  real-domain f32 out (an int8 triple from upstream is dequantized
  first);
* fp32: the wrapped layer.

Stitching: inside a (Hybrid)Sequential consecutive wrappers pass the
``(int8, min, max)`` triple straight through; Pooling/Flatten wrappers
engage only when their input arrives quantized.  A wrapper whose arm is
fp32 or fp8 dequantizes an arriving triple first, so mixed decisions
compose.

Each wrapper's forward runs on tensors (the eager net, a captured CUDA
graph); its ``hybrid_forward(F, x)`` builds the same ops as graph nodes
with the baked constants as variables (``gluon.block.trace_constant``),
so ``HybridBlock.export`` and ``deploy.export_model`` write the arm the
trace takes, its int8 weights in ``.params`` (dtype flag 5) and its
e4m3 weights as float32 (cast back to e4m3 at load).
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock, trace_constant
from ..ops.registry import get_op

__all__ = ["quantize_net", "tune_quantized", "QuantizedDense",
           "QuantizedConv", "QuantizedPooling", "QuantizedFlatten",
           "quantized_layers"]

_INT8_RANGE = 127.0
_FP8_MAX = 448.0  # e4m3fn's largest finite value


def _quantize_weight(arr):
    """Symmetric per-tensor int8 of a weight array (host side, once at
    rewrite): ``(int8 numpy, min, max)`` with ``max = |w|_inf``."""
    w = onp.asarray(arr, dtype="float32")
    amax = float(onp.abs(w).max()) or 1.0
    q = onp.clip(onp.rint(w * (_INT8_RANGE / amax)),
                 -127, 127).astype("int8")
    return q, -amax, amax


def _quantize_weight_fp8(arr):
    """Symmetric per-tensor e4m3 of a weight (host side): scaled onto
    +-448 and clipped there BEFORE the cast (e4m3fn overflows to NaN).
    Returns ``(float32 numpy of the scaled values, amax)``."""
    w = onp.asarray(arr, dtype="float32")
    amax = float(onp.abs(w).max()) or 1.0
    return onp.clip(w * (_FP8_MAX / amax), -_FP8_MAX, _FP8_MAX), amax


def _is_qtensor(x):
    return isinstance(x, (list, tuple)) and len(x) == 3


class _Ops:
    """The registered ops on tensors (``F`` None) or as graph nodes of
    ``F = mx.sym``; a multi-output op gives a list either way."""

    def __init__(self, F=None):
        self._F = F

    def __call__(self, name, *inputs, **params):
        params = {k: v for k, v in params.items() if v is not None}
        if self._F is None:
            out = get_op(name).fn(*inputs, **params)
            return list(out) if isinstance(out, tuple) else out
        out = getattr(self._F, name)(*inputs, **params)
        return list(out) if get_op(name).out_count(params) > 1 else out


class _QuantizedLayer(HybridBlock):
    """Shared wrapper machinery: the original layer rides as the
    ``_orig`` child, the baked constants are buffers (a trace writes
    them as graph variables), and the arm is consulted per call."""

    #: name in autotune.VARIANT_OPS ("quantized_fc"/"quantized_conv");
    #: None = structural (pooling/flatten follow their input's form)
    variant_op = None
    _mxnet_quantized = True

    def __init__(self, orig, in_range=None, out_range=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._orig = orig
        self._in_range = tuple(float(v) for v in in_range) \
            if in_range else None
        self._out_range = tuple(float(v) for v in out_range) \
            if out_range else None
        #: stitching flags set by quantize_net's Sequential pass
        self.emit_q = False
        self.accept_q = False
        #: the arm tune_quantized adopted (None: int8)
        self._tuned = None

    def _arm(self):
        """"fp32" / "int8" / "fp8": a force scope, then MXNET_QUANTIZE,
        then the race's adopted winner, then int8 (the layer was
        rewritten on purpose)."""
        if self.variant_op is None:
            return "int8"  # structural wrappers follow their input form
        from .. import autotune as _at

        v = _at.variant_choice(self.variant_op, default=None)
        if v is None:
            v = True if self._tuned is None else self._tuned
        if v == "fp8":
            from ..dtype import _float8

            _float8("float8_e4m3fn")  # loud where this build lacks fp8
            return "fp8"
        return "int8" if v else "fp32"

    def _calib(self, which):
        r = self._in_range if which == "in" else self._out_range
        if r is None:
            return {}
        return {"min_calib_range": r[0], "max_calib_range": r[1]}

    def _const(self, F, name):
        """A baked constant: the buffer, or in a trace its variable
        (named after the original layer)."""
        t = getattr(self, name)
        if F is None:
            return t
        return trace_constant(f"{self._orig.name}{name}", t)

    def _act(self, out):
        act = getattr(self._orig, "act", None)
        return act(out) if act is not None else out

    def __repr__(self):
        return f"{type(self).__name__}({self._orig!r})"


class _QuantizedCompute(_QuantizedLayer):
    """The weighted wrappers (Dense/Conv): int8 and e4m3 weights baked at
    construction, and the one forward skeleton for tensors and
    traces."""

    def _bake_weights(self, layer, n_out):
        w_param = layer._reg_params["weight"]
        b_param = layer._reg_params.get("bias")
        w = w_param.data().asnumpy()
        dev = w_param.data()._data.device

        def buf(name, a, dtype=None):
            t = torch.from_numpy(onp.ascontiguousarray(a)).to(dev)
            self.register_buffer(name, t if dtype is None else t.to(dtype))

        wq, wmin, wmax = _quantize_weight(w)
        buf("_wq", wq)
        buf("_wmin", onp.array([wmin], "float32"))
        buf("_wmax", onp.array([wmax], "float32"))
        self._no_bias = b_param is None
        if self._no_bias:
            bq, bmin, bmax = onp.zeros(n_out, "int8"), -1.0, 1.0
            b32 = onp.zeros(n_out, "float32")
        else:
            b32 = onp.asarray(b_param.data().asnumpy(), "float32")
            bq, bmin, bmax = _quantize_weight(b32)
        buf("_bq", bq)
        buf("_bmin", onp.array([bmin], "float32"))
        buf("_bmax", onp.array([bmax], "float32"))
        # the fp8 arm: an e4m3 weight and its amax; the bias stays f32,
        # added after the f32-accumulating product
        w8, w8_amax = _quantize_weight_fp8(w)
        buf("_w8", w8, torch.float8_e4m3fn)
        buf("_w8_amax", onp.array([w8_amax], "float32"))
        buf("_b32", b32)

    def _int8_inputs(self, F, q):
        c = self._const
        return [q[0], c(F, "_wq"), c(F, "_bq"), q[1], q[2], c(F, "_wmin"),
                c(F, "_wmax"), c(F, "_bmin"), c(F, "_bmax")]

    def _fp8_inputs(self, F, q):
        c = self._const
        return [q[0], c(F, "_w8"), c(F, "_b32"), q[1], c(F, "_w8_amax")]

    def _run(self, F, x):
        op = _Ops(F)
        q_in = _is_qtensor(x)
        arm = self._arm()
        if arm == "fp32":
            return self._orig(op("_contrib_dequantize", *x) if q_in else x)
        if arm == "fp8":
            xf = op("_contrib_dequantize", *x) if q_in else x
            q = op("_contrib_quantize_fp8", xf, **self._calib("in"))
            return self._act(op(self._fp8_op, *self._fp8_inputs(F, q),
                                **self._op_kw()))
        q = list(x) if q_in else op("_contrib_quantize_v2", x,
                                    **self._calib("in"))
        acc = op(self._int8_op, *self._int8_inputs(F, q), **self._op_kw())
        if self.emit_q and getattr(self._orig, "act", None) is None:
            return op("_contrib_requantize", *acc, **self._calib("out"))
        return self._act(op("_contrib_dequantize", *acc))

    def forward(self, x):
        return self._run(None, x)

    def hybrid_forward(self, F, x):
        return self._run(F, x)

    def export_dtypes(self):
        """dtype names of the weights this wrapper bakes into an exported
        program (``deploy.export_model``'s ``param_dtypes``)."""
        arm = self._arm()
        if arm == "fp8":
            return ["float8_e4m3fn"] + \
                ([] if self._no_bias else ["float32"])
        if arm == "int8":
            return ["int8"] if self._no_bias else ["int8", "int8"]
        return []


class QuantizedDense(_QuantizedCompute):
    """Quantized Dense: int8 x int8 -> int32 FC
    (``_contrib_quantized_fully_connected``), requantized to int8 when
    the next layer takes quantized data, dequantized otherwise; or the
    fp8 arm (e4m3 x e4m3 -> f32); the wrapped fp32 Dense is the third
    arm."""

    variant_op = "quantized_fc"
    _int8_op = "_contrib_quantized_fully_connected"
    _fp8_op = "_contrib_fp8_fully_connected"

    def __init__(self, dense, in_range=None, out_range=None, **kw):
        super().__init__(dense, in_range, out_range, **kw)
        self._units = int(dense.weight.shape[0])
        self._flatten = bool(dense._flatten)
        self._bake_weights(dense, self._units)

    def _op_kw(self):
        return dict(num_hidden=self._units, no_bias=self._no_bias,
                    flatten=self._flatten)


class QuantizedConv(_QuantizedCompute):
    """Quantized convolution (``_contrib_quantized_conv`` /
    ``_contrib_fp8_conv``), channel-first layouts only, with
    :class:`QuantizedDense`'s arms and stitching."""

    variant_op = "quantized_conv"
    _int8_op = "_contrib_quantized_conv"
    _fp8_op = "_contrib_fp8_conv"

    def __init__(self, conv, in_range=None, out_range=None, **kw):
        super().__init__(conv, in_range, out_range, **kw)
        if conv._channel_last:
            raise MXNetError(
                f"{conv.name}: channel-last convolutions are not "
                "quantizable (int8 conv is NCHW/NCW)")
        k = conv._kwargs
        self._conv_kw = dict(
            kernel=tuple(k["kernel"]), num_filter=int(k["num_filter"]),
            stride=tuple(k["stride"]), pad=tuple(k["pad"]),
            dilate=tuple(k["dilate"]), num_group=int(k["num_group"]))
        self._bake_weights(conv, self._conv_kw["num_filter"])

    def _op_kw(self):
        return dict(no_bias=self._no_bias, **self._conv_kw)


class _QuantizedPassThrough(_QuantizedLayer):
    """A range-preserving wrapper: it engages only when its input
    arrives as a quantized triple (a lone quantize-pool-dequantize would
    only add error); fp32 inputs run the wrapped layer."""

    def _run(self, F, x):
        if not _is_qtensor(x):
            return self._orig(x)
        op = _Ops(F)
        q = op(self._q_op, *x, **self._q_kw())
        return q if self.emit_q else op("_contrib_dequantize", *q)

    def forward(self, x):
        return self._run(None, x)

    def hybrid_forward(self, F, x):
        return self._run(F, x)


class QuantizedPooling(_QuantizedPassThrough):
    """Range-preserving int8 pooling (``_contrib_quantized_pooling``)."""

    _q_op = "_contrib_quantized_pooling"

    def __init__(self, pool, **kw):
        super().__init__(pool, **kw)
        k = pool._kwargs
        self._pool_kw = dict(
            kernel=tuple(k["kernel"]), pool_type=k["pool_type"],
            global_pool=bool(k["global_pool"]),
            stride=tuple(k["stride"]), pad=tuple(k["pad"]),
            pooling_convention=k["pooling_convention"])

    def _q_kw(self):
        return self._pool_kw


class QuantizedFlatten(_QuantizedPassThrough):
    """int8 flatten: a pass-through of the quantization range."""

    _q_op = "_contrib_quantized_flatten"

    def _q_kw(self):
        return {}


def _can_emit_q(wrapper):
    """True when the wrapper can hand an int8 triple to its successor
    (a fused activation forces the fp32 boundary)."""
    if isinstance(wrapper, _QuantizedPassThrough):
        return True
    return getattr(wrapper._orig, "act", None) is None


def _eligible(child, calib, excluded):
    """Which wrapper class (or None) this leaf swaps to under the
    calibration result."""
    from ..gluon.nn.basic_layers import Dense, Flatten
    from ..gluon.nn.conv_layers import _Conv, _Pooling

    if child.name in excluded:
        return None
    if isinstance(child, Dense):
        return QuantizedDense if child.name in calib else None
    if isinstance(child, _Conv):
        if child._channel_last:
            return None
        return QuantizedConv if child.name in calib else None
    if isinstance(child, _Pooling):
        kw = child._kwargs
        if kw["pool_type"] not in ("max", "avg"):
            return None
        if kw.get("count_include_pad") is False:
            return None  # the int8 pooling op has no exclude-pad path
        return QuantizedPooling
    if isinstance(child, Flatten):
        return QuantizedFlatten
    return None


def quantized_layers(net):
    """Every quantized wrapper under ``net`` (the deploy metadata scan)."""
    found = []

    def _walk(block):
        if getattr(block, "_mxnet_quantized", False):
            found.append(block)
            return  # never descend into the shadowed fp32 original
        for child in block._children.values():
            _walk(child)

    _walk(net)
    return found


def quantize_net(net, calib, excluded_names=()):
    """Rewrite ``net`` IN PLACE: every calibrated Dense/Conv leaf (and
    every Pooling/Flatten inside a Sequential) becomes its quantized
    wrapper; everything else (norms, activations, embeddings,
    channel-last convs, excluded names) stays fp32.  ``calib`` is the
    :class:`~.calibrate.CalibrationResult`; ``excluded_names`` extends
    its exclusion set.  Returns ``net``."""
    from ..gluon.nn.basic_layers import HybridSequential, Sequential

    excluded = set(excluded_names) | set(calib.excluded)
    swapped = []

    def _swap_in(parent, name, child, cls):
        if issubclass(cls, _QuantizedPassThrough):
            wrapper = cls(child)
        else:
            wrapper = cls(child, in_range=calib.range(child.name, "in"),
                          out_range=calib.range(child.name, "out"))
        parent._modules[name] = wrapper
        swapped.append(wrapper)

    def _walk(parent):
        seq = isinstance(parent, (Sequential, HybridSequential))
        for name, child in list(parent._children.items()):
            cls = _eligible(child, calib, excluded)
            if cls is not None and issubclass(cls, _QuantizedPassThrough) \
                    and not seq:
                cls = None  # chain-only layers need a Sequential seam
            if cls is not None:
                _swap_in(parent, name, child, cls)
            else:
                _walk(child)
        if seq:
            _stitch(list(parent._children.values()))

    def _stitch(children):
        """Consecutive wrappers exchange int8 triples directly; a
        pooling/flatten wrapper counts only once something upstream
        produces int8 (a chain starts at a conv/fc)."""
        for cur, nxt in zip(children, children[1:]):
            if not (getattr(cur, "_mxnet_quantized", False)
                    and getattr(nxt, "_mxnet_quantized", False)):
                continue
            if not _can_emit_q(cur):
                continue
            if isinstance(cur, _QuantizedPassThrough) and not cur.accept_q:
                continue  # nothing quantized flows into cur anyway
            cur.emit_q = True
            nxt.accept_q = True

    _walk(net)
    if not any(isinstance(w, _QuantizedCompute) for w in swapped):
        raise MXNetError(
            "quantize_net: no quantizable layer carries a calibrated "
            "range (check excluded_names / the calibration data)")
    net._clear_cached_ops()
    return net


def tune_quantized(net, sample_x, iters=8, level=None):
    """Adoption by measurement: race the rewritten net's int8 and fp8
    arms against fp32 on its real forward, ``quantized_conv`` then
    ``quantized_fc`` (greedy, earlier winners pinned).  On the card each
    arm's forward is captured as one CUDA graph, the port's compiled
    program (the reference races a jitted run), and its replays are
    timed by CUDA events; on the host the eager forward is timed.
    Winners persist in ``autotune.json`` keyed (op, input shape, dtype,
    platform), so a warm cache answers without running anything, and
    become the wrappers' arm (a ``force`` scope and ``MXNET_QUANTIZE``
    still win over them).

    Returns ``{op: {"winner", "cached", "timings"}}`` (empty when
    autotune is off)."""
    from .. import autograd
    from .. import autotune as _at
    from ..dtype import dtype_name
    from ..ndarray.ndarray import NDArray, array

    lvl = _at.autotune_level() if level is None else int(level)
    if lvl < 1:
        return {}
    wrappers = quantized_layers(net)
    present = {w.variant_op for w in wrappers if w.variant_op is not None}
    race = [op for op in ("quantized_conv", "quantized_fc")
            if op in present]
    if not race:
        return {}
    if isinstance(sample_x, NDArray):
        x = sample_x
    elif isinstance(sample_x, torch.Tensor):
        x = NDArray(sample_x)
    else:
        from ..context import from_torch_device

        dev = wrappers[0]._wq.device
        x = array(onp.asarray(sample_x), ctx=from_torch_device(dev))
    device = x._data.device
    plat = "cuda" if device.type == "cuda" else "cpu"
    # a cached call would replay the arm it captured: race eagerly
    hybrid = [b for b in net.modules()
              if isinstance(b, HybridBlock) and b._active]

    def forward():
        """The forward the race times, built under the arms in force."""
        if device.type != "cuda":
            def run():
                with autograd.pause():
                    net(x)
            return run
        from ..gluon._graph import GraphProgram

        def fn(aliases, t):
            with torch.no_grad():
                return [net(t)]

        prog = GraphProgram(fn, [x._data], [], list(net.buffers()), False,
                            "tune_quantized")
        return lambda: prog.forward([x._data])

    report, decided = {}, {}
    for b in hybrid:
        b._active = False
    try:
        for op in race:
            def measure(_value, _decided=dict(decided)):
                with _at.force(**_decided):
                    return _at.time_call(forward(), device, iters=iters)

            winner, info = _at.tune(
                op, tuple(x.shape), dtype_name(x._data.dtype),
                _at.VARIANT_OPS[op], measure, platform=plat, level=lvl)
            if winner is not None:
                decided[op] = _at.VARIANT_OPS[op][winner]
                report[op] = {"winner": winner, **info}
    finally:
        for b in hybrid:
            b._active = True
    for w in wrappers:
        if w.variant_op in decided:
            w._tuned = decided[w.variant_op]
    net._clear_cached_ops()
    return report
