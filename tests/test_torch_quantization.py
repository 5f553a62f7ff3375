"""The port's quantized inference (``mxnet_tpu_torch/ops/
quantization_ops.py``, ``quantization/``, ``contrib/quantization.py``)
held against the JAX package on the CPU, on the same seeded numpy
inputs (``with mx.cpu():`` for the port).

Tolerances:

- the int8 ops: codes, int32 accumulators and their float ranges equal
  the reference's bit for bit (0 ulps), ``dequantize`` and
  ``requantize`` too; the avg-pool rounds to nearest;
- calibration: ``naive`` ranges equal bit for bit on a net whose fp32
  arithmetic is exact (weights k/8, inputs k/2: every sum is exact, so
  both packages observe the same tensors); ``entropy`` thresholds to
  1e-6;
- ``quantize_net``: the same wrappers, stitching and escapes; the baked
  int8 weights and ranges bit for bit; each layer's int32 accumulator
  bit for bit; the logits to 1e-6 of the largest;
- the reference's drill (``tests/test_quantization.py:612``): top-1
  agreement of the served int8 artifact with fp32 at least 0.99, and
  the artifact header's ``quantized``, ``quantized_layers`` and
  ``param_dtypes`` equal to the reference's from the same weights.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import quantization as jq  # noqa: E402
from mxnet_tpu.contrib import quantization as jcq  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import quantization as tq  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.contrib import quantization as tcq  # noqa: E402
from mxnet_tpu_torch.ops.registry import get_op  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANT = {jmx: jq, tmx: tq}
AT = {jmx: j_at, tmx: t_at}
LOGIT_TOL = 1e-6
ENTROPY_TOL = 1e-6
OPS = ("_contrib_quantize", "_contrib_quantize_v2", "_contrib_dequantize",
       "_contrib_requantize", "_contrib_quantized_fully_connected",
       "_contrib_quantized_conv", "_contrib_quantize_fp8",
       "_contrib_fp8_fully_connected", "_contrib_fp8_conv",
       "_contrib_quantized_pooling", "_contrib_quantized_flatten")


@pytest.fixture(autouse=True)
def _host(tmp_path, monkeypatch):
    """The port on the host; both packages' autotune caches in the
    test's directory; no hand override of the arms."""
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path / "at"))
    monkeypatch.delenv("MXNET_QUANTIZE", raising=False)
    j_at.cache_clear()
    t_at.cache_clear()
    with tmx.cpu():
        yield
    j_at.cache_clear()
    t_at.cache_clear()


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)


def _run(pkg, name, arrays, params):
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in arrays]
    out = pkg.nd.invoke(name, xs, **params)
    return [_np(o) for o in (out if isinstance(out, list) else [out])]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        onp.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- ops
def _r(v):
    return onp.array([v], "float32")


_RS = onp.random.RandomState(0)
_X = _RS.randn(4, 3, 9, 9).astype("float32")
_Q8 = _RS.randint(-127, 128, (6, 3, 4, 4)).astype("int8")
_Q32 = _RS.randint(-2 ** 30, 2 ** 30, (4, 5)).astype("int32")
_QU = _RS.randint(0, 256, (4, 5)).astype("uint8")
_W = _RS.randint(-127, 128, (10, 48)).astype("int8")
_B = _RS.randint(-127, 128, (10,)).astype("int8")
_WC = _RS.randint(-127, 128, (8, 3, 3, 3)).astype("int8")
_WG = _RS.randint(-127, 128, (6, 1, 3, 3)).astype("int8")
_RANGES = [_r(-1.2), _r(1.5), _r(-0.3), _r(0.2), _r(-0.1), _r(0.1)]
OP_CASES = {
    "quantize_uint8": ("_contrib_quantize", [_X, _r(-2.0), _r(3.0)],
                       dict(out_type="uint8")),
    "quantize_int8": ("_contrib_quantize", [_X, _r(-2.0), _r(3.0)],
                      dict(out_type="int8")),
    "quantize_v2_observed": ("_contrib_quantize_v2", [_X], {}),
    "quantize_v2_calibrated": ("_contrib_quantize_v2", [_X],
                               dict(min_calib_range=-1.7,
                                    max_calib_range=2.3)),
    "dequantize_int8": ("_contrib_dequantize", [_Q8[0, 0], _r(-1.3),
                                                _r(2.1)], {}),
    "dequantize_int32": ("_contrib_dequantize", [_Q32, _r(-1.3), _r(2.1)],
                         {}),
    "dequantize_uint8": ("_contrib_dequantize", [_QU, _r(-1.3), _r(2.1)],
                         {}),
    "requantize_observed": ("_contrib_requantize", [_Q32, _r(-1.3),
                                                    _r(2.1)], {}),
    "requantize_calibrated": ("_contrib_requantize",
                              [_Q32, _r(-1.3), _r(2.1)],
                              dict(min_calib_range=-0.5,
                                   max_calib_range=0.7)),
    "fc": ("_contrib_quantized_fully_connected",
           [_Q8, _W, _B] + _RANGES, dict(num_hidden=10)),
    "fc_no_bias": ("_contrib_quantized_fully_connected",
                   [_Q8, _W, _B] + _RANGES,
                   dict(num_hidden=10, no_bias=True)),
    "conv_pad": ("_contrib_quantized_conv", [_Q8, _WC, _B[:8]] + _RANGES,
                 dict(kernel=(3, 3), num_filter=8, pad=(1, 1))),
    "conv_stride": ("_contrib_quantized_conv", [_Q8, _WC, _B[:8]] + _RANGES,
                    dict(kernel=(3, 3), num_filter=8, stride=(2, 2))),
    "conv_dilate": ("_contrib_quantized_conv", [_Q8, _WC, _B[:8]] + _RANGES,
                    dict(kernel=(3, 3), num_filter=8, stride=(1, 2),
                         pad=(2, 1), dilate=(2, 1))),
    "conv_groups": ("_contrib_quantized_conv", [_Q8, _WG, _B[:6]] + _RANGES,
                    dict(kernel=(3, 3), num_filter=6, num_group=3,
                         pad=(1, 1))),
    **{f"pool_{k}": ("_contrib_quantized_pooling", [_Q8, _r(-1.0),
                                                     _r(1.0)], kw)
       for k, kw in {
           "max": dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                       pad=(1, 1)),
           "avg": dict(kernel=(2, 2), pool_type="avg", stride=(2, 2)),
           "avg_pad": dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                           pad=(1, 1)),
           "avg_full": dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                            pooling_convention="full"),
           "global_avg": dict(global_pool=True, pool_type="avg"),
           "global_max": dict(global_pool=True, pool_type="max")}.items()},
    "flatten": ("_contrib_quantized_flatten", [_Q8, _r(-1.0), _r(1.0)], {}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_int8_ops_match_reference_bit_for_bit(case):
    name, arrays, params = OP_CASES[case]
    _same(_run(tmx, name, arrays, params), _run(jmx, name, arrays, params))


def test_the_reference_ops_are_registered_with_their_output_counts():
    from mxnet_tpu.ops.registry import get_op as j_get_op

    for name in OPS:
        t, j = get_op(name), j_get_op(name)
        assert t.out_count({}) == j.out_count({}), name
        assert not t.differentiable and not j.differentiable, name


def test_quantized_avg_pool_rounds_to_nearest():
    """``tests/test_quantization.py:209``: the average is rounded to
    nearest, not truncated: (1 + 2 + 2 + 2) / 4 = 1.75 gives 2."""
    codes = onp.array([[[[1, 2, 5, -1], [2, 2, -2, -3], [7, 0, 3, 3],
                         [0, 0, 3, 4]]]], dtype="int8")
    kw = dict(kernel=(2, 2), stride=(2, 2), pool_type="avg")
    got = _run(tmx, "_contrib_quantized_pooling",
               [codes, _r(-127.0), _r(127.0)], kw)[0].astype("int32")
    ref = codes.astype("float64").reshape(1, 1, 2, 2, 2, 2) \
        .transpose(0, 1, 2, 4, 3, 5).reshape(1, 1, 2, 2, 4).mean(-1)
    onp.testing.assert_array_equal(got, onp.rint(ref).astype("int32"))
    assert ref[0, 0, 0, 0] == 1.75 and got[0, 0, 0, 0] == 2


def test_quantized_ops_trace_and_infer_shapes():
    """The three-output int8 nodes trace into a graph whose shapes and
    dtypes inference reads (an export is such a graph)."""
    sym = tmx.sym
    data = sym.var("data")
    q = sym._contrib_quantize_v2(data, min_calib_range=-1.0,
                                 max_calib_range=1.0)
    consts = [sym.var(n, shape=s, dtype=d) for n, s, d in (
        ("w", (4, 3, 3, 3), "int8"), ("b", (4,), "int8"),
        ("wmin", (1,), "float32"), ("wmax", (1,), "float32"),
        ("bmin", (1,), "float32"), ("bmax", (1,), "float32"))]
    acc = sym._contrib_quantized_conv(q[0], consts[0], consts[1], q[1],
                                      q[2], *consts[2:], kernel=(3, 3),
                                      num_filter=4, pad=(1, 1))
    out = sym._contrib_dequantize(acc[0], acc[1], acc[2])
    assert len(list(q)) == 3 and len(list(acc)) == 3
    _, out_shapes, _ = out.infer_shape(data=(2, 3, 8, 8))
    assert out_shapes == [(2, 4, 8, 8)]
    back = tmx.sym.load_json(out.tojson())
    assert back.infer_shape(data=(2, 3, 8, 8))[1] == [(2, 4, 8, 8)]


# ---------------------------------------------------------- calibration
def _exact_values(pkg, net, seed):
    """Give every parameter of ``net`` values k/8 (|k| <= 4) drawn from
    ``seed`` in parameter order: fp32 sums over them are exact."""
    rs = onp.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(rs.randint(-4, 5, p.shape)
                                .astype("float32") / 8))


def _exact_batches(n=3, shape=(4, 3, 8, 8), seed=1):
    rs = onp.random.RandomState(seed)
    return [(rs.randint(-8, 9, shape) / 2).astype("float32")
            for _ in range(n)]


def _small_net(pkg, with_act=False, exact=True, seed=0):
    """``tests/test_quantization.py``'s small net: conv, max-pool,
    avg-pool, flatten, dense (a relu after the conv when
    ``with_act``)."""
    nn = pkg.gluon.nn
    onp.random.seed(seed)
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3))
        if with_act:
            net.add(nn.Activation("relu"))
        net.add(nn.MaxPool2D(), nn.AvgPool2D(), nn.Flatten(),
                nn.Dense(10, in_units=8 * 2 * 2))
    net.initialize(pkg.init.Xavier())
    if exact:
        _exact_values(pkg, net, seed + 10)
    return net


def _calibrated(pkg, net, mode="naive", batches=None, **kw):
    batches = _exact_batches() if batches is None else batches
    return QUANT[pkg].calibrate(net, [pkg.nd.array(b) for b in batches],
                                mode=mode, **kw)


@pytest.mark.parametrize("with_act", [False, True])
def test_naive_ranges_equal_the_reference(with_act):
    got, want = (_calibrated(p, _small_net(p, with_act)).as_dict()
                 for p in (tmx, jmx))
    assert got == want and len(got) == 5
    assert _calibrated(tmx, _small_net(tmx)).mode == "naive"


def test_entropy_thresholds_equal_the_reference():
    """The same skewed activations (a near-zero first batch, then a
    ReLU spike with rare outliers, widening and then rebinning the
    histogram) through both packages' collectors, and the threshold
    search on one histogram."""
    rs = onp.random.RandomState(3)
    batches = [onp.full(100, 1e-7, "float32"),
               onp.maximum(rs.randn(20000), 0).astype("float32"),
               (rs.randn(5000) * 4).astype("float32")]
    stats = {}
    for mod in (tq, jq):
        s = mod.TensorStats(collect_hist=True)
        for b in batches:
            s.update(b)
        stats[mod] = s
    got, want = stats[tq].range("entropy"), stats[jq].range("entropy")
    assert abs(got[1] - want[1]) <= ENTROPY_TOL * abs(want[1])
    assert stats[tq].range("naive") == stats[jq].range("naive")
    hist = rs.randint(0, 50, 4096)
    hist[:10] += 5000
    assert abs(tq.optimal_threshold(hist, 7.5)
               - jq.optimal_threshold(hist, 7.5)) <= ENTROPY_TOL * 7.5


def test_entropy_calibration_of_a_net_equals_the_reference():
    got, want = (_calibrated(p, _small_net(p, True), mode="entropy")
                 for p in (tmx, jmx))
    assert got.layers() == want.layers()
    for name in want:
        for which in ("in", "out"):
            g, w = got.range(name, which), want.range(name, which)
            assert abs(g[1] - w[1]) <= ENTROPY_TOL * abs(w[1]), name


def _module(pkg, arg):
    sym = pkg.sym
    data = sym.var("data")
    fc = sym.FullyConnected(data, name="fc1", num_hidden=8)
    fc2 = sym.FullyConnected(sym.relu(fc), name="fc2", num_hidden=4)
    mod = pkg.mod.Module(sym.softmax(fc2), data_names=("data",),
                         label_names=(), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (4, 16))], for_training=False)
    mod.init_params(initializer=pkg.init.Xavier())
    mod.set_params({k: pkg.nd.array(v) for k, v in arg.items()}, {})
    return mod


def test_calibrate_module_taps_equal_the_reference():
    rs = onp.random.RandomState(4)
    arg = {"fc1_weight": rs.randint(-4, 5, (8, 16)) / 8,
           "fc1_bias": rs.randint(-4, 5, 8) / 8,
           "fc2_weight": rs.randint(-4, 5, (4, 8)) / 8,
           "fc2_bias": rs.randint(-4, 5, 4) / 8}
    arg = {k: v.astype("float32") for k, v in arg.items()}
    batches = [(rs.randint(-8, 9, (4, 16)) / 2).astype("float32")
               for _ in range(3)]
    got, want = (QUANT[p].calibrate(_module(p, arg), batches, mode="naive")
                 for p in (tmx, jmx))
    assert got.as_dict() == want.as_dict()
    assert got.layers() == ["fc1", "fc2"]


def test_calibration_refusals():
    net = _small_net(tmx)
    with pytest.raises(MXNetError, match="calib_mode"):
        tq.calibrate(net, _exact_batches(), mode="kl")
    with pytest.raises(MXNetError, match="no quantizable"):
        tq.calibrate(net, _exact_batches(), excluded_names=[
            c.name for c in net._children.values()])
    with pytest.raises(MXNetError, match="no batches"):
        tq.calibrate(net, [])
    with pytest.raises(MXNetError, match="Block or a Module"):
        tq.calibrate(object(), [])


def test_env_knobs_registered_with_the_reference_defaults():
    from mxnet_tpu import config as j_config
    from mxnet_tpu_torch import config as t_config

    for name in ("MXNET_QUANTIZE", "MXNET_QUANT_CALIB_MODE",
                 "MXNET_QUANT_CALIB_BATCHES"):
        assert t_config.get_env(name) == j_config.get_env(name)


# ---------------------------------------------------------- the rewrite
def _structure(pkg, net):
    return [(type(w).__name__, w._orig.name, w.emit_q, w.accept_q)
            for w in QUANT[pkg].quantized_layers(net)]


@pytest.mark.parametrize("with_act", [False, True])
def test_rewrite_structure_equals_the_reference(with_act):
    got, want = (_structure(p, QUANT[p].quantize_net(
        *(lambda n: (n, _calibrated(p, n)))(_small_net(p, with_act))))
        for p in (tmx, jmx))
    assert got == want
    kinds = sorted(k for k, *_ in got)
    assert kinds == ["QuantizedConv", "QuantizedDense", "QuantizedFlatten",
                     "QuantizedPooling", "QuantizedPooling"]
    conv = got[0]
    assert conv[2] is (not with_act)  # a relu breaks the int8 chain


def test_excluded_names_escape_and_empty_calibration():
    for pkg in (tmx, jmx):
        net = _small_net(pkg)
        dense = list(net._children.values())[-1]
        calib = _calibrated(pkg, net, excluded_names=(dense.name,))
        assert dense.name not in calib
        QUANT[pkg].quantize_net(net, calib)
        assert isinstance(list(net._children.values())[-1],
                          pkg.gluon.nn.Dense)
    with pytest.raises(MXNetError, match="calibrated"):
        tq.quantize_net(_small_net(tmx),
                        tq.CalibrationResult({}, "naive", 1))


def _bake(pkg, net):
    q = QUANT[pkg]
    q.quantize_net(net, _calibrated(pkg, net))
    out = {}
    for w in q.quantized_layers(net):
        if w.variant_op is None:
            continue
        out[w._orig.name] = {k: _np(getattr(w, k)) for k in (
            "_wq", "_wmin", "_wmax", "_bq", "_bmin", "_bmax")}
        out[w._orig.name]["ranges"] = (w._in_range, w._out_range)
    return out


def test_baked_int8_weights_and_ranges_equal_the_reference():
    """Weights drawn by Xavier from one numpy seed (equal bit for bit
    in both packages, ROADMAP §C 5) and by k/8; the calibrated ranges
    where the fp32 forward is exact (k/8: both packages observe the
    same tensors; Xavier's convolutions round in their own order)."""
    for exact in (False, True):
        got, want = (_bake(p, _small_net(p, exact=exact))
                     for p in (tmx, jmx))
        assert list(got) == list(want)
        for name in want:
            for k in want[name]:
                if k != "ranges":
                    _same([got[name][k]], [want[name][k]])
                elif exact:
                    assert got[name][k] == want[name][k], name


def _accumulators(pkg, net, x):
    """Each weighted wrapper's int32 accumulator on the input it was
    called with (a pre-hook records it), and the logits."""
    q = QUANT[pkg]
    seen = {}
    handles = [w.register_forward_pre_hook(
        lambda blk, ins: seen.setdefault(blk, ins[0]))
        for w in q.quantized_layers(net) if w.variant_op is not None]
    out = _np(net(pkg.nd.array(x)))
    for h in handles:
        h.detach()
    accs = {}
    for w, inp in seen.items():
        qv2 = pkg.nd.invoke("_contrib_quantize_v2", [inp],
                            min_calib_range=w._in_range[0],
                            max_calib_range=w._in_range[1])
        name = "_contrib_quantized_conv" if "Conv" in type(w).__name__ \
            else "_contrib_quantized_fully_connected"
        kw = dict(w._conv_kw) if name.endswith("conv") else dict(
            num_hidden=w._units, flatten=w._flatten)
        consts = [pkg.nd.array(_np(getattr(w, k)),
                               dtype=_np(getattr(w, k)).dtype)
                  for k in ("_wq", "_bq")]
        rng = [pkg.nd.array(_np(getattr(w, k)))
               for k in ("_wmin", "_wmax", "_bmin", "_bmax")]
        acc = pkg.nd.invoke(name, [qv2[0], *consts, qv2[1], qv2[2], *rng],
                            no_bias=w._no_bias, **kw)
        accs[w._orig.name] = [_np(a) for a in acc]
    return accs, out


def test_rewritten_logits_and_int32_accumulators_equal_the_reference():
    x = _exact_batches(1, seed=7)[0]
    res = {}
    for pkg in (tmx, jmx):
        net = _small_net(pkg, with_act=True)
        QUANT[pkg].quantize_net(net, _calibrated(pkg, net))
        res[pkg] = _accumulators(pkg, net, x)
    (t_acc, t_out), (j_acc, j_out) = res[tmx], res[jmx]
    assert sorted(t_acc) == sorted(j_acc) and len(t_acc) == 2
    for name in j_acc:
        _same(t_acc[name], j_acc[name])
    assert onp.abs(t_out - j_out).max() <= LOGIT_TOL * onp.abs(j_out).max()


def test_env_pins_the_arm_bit_exactly(monkeypatch):
    """``MXNET_QUANTIZE=0`` runs every wrapper's fp32 original (the fp32
    net's output bit for bit), ``1`` the int8 program, and a force
    scope wins over the variable."""
    net = _small_net(tmx, exact=False)
    x = tmx.nd.array(_exact_batches(1)[0])
    ref = net(x).asnumpy()
    tq.quantize_net(net, _calibrated(tmx, net))
    int8 = net(x).asnumpy()
    assert not onp.array_equal(int8, ref)
    monkeypatch.setenv("MXNET_QUANTIZE", "0")
    onp.testing.assert_array_equal(net(x).asnumpy(), ref)
    with t_at.force(quantized_conv=True, quantized_fc=True):
        onp.testing.assert_array_equal(net(x).asnumpy(), int8)
    monkeypatch.setenv("MXNET_QUANTIZE", "int8")
    onp.testing.assert_array_equal(net(x).asnumpy(), int8)
    net.hybridize()
    onp.testing.assert_array_equal(net(x).asnumpy(), int8)


def test_attribute_style_block_swaps_its_attributes():
    class Net(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.conv = tmx.gluon.nn.Conv2D(4, 3, padding=1,
                                                in_channels=3)
                self.pool = tmx.gluon.nn.MaxPool2D()
                self.fc = tmx.gluon.nn.Dense(6, in_units=4 * 4 * 4)

        def forward(self, x):
            return self.fc(self.pool(self.conv(x)))

    net = Net()
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_exact_batches(1)[0])
    ref = net(x).asnumpy()
    tq.quantize_net(net, _calibrated(tmx, net))
    assert type(net.conv).__name__ == "QuantizedConv"
    assert type(net.fc).__name__ == "QuantizedDense"
    assert isinstance(net.pool, tmx.gluon.nn.MaxPool2D)  # no seam
    assert not any(w.emit_q for w in tq.quantized_layers(net))
    out = net(x).asnumpy()
    assert onp.abs(out - ref).max() <= 0.12 * onp.abs(ref).max()


# ------------------------------------------------- export and artifacts
def _header(pkg, path):
    return {k: pkg.deploy.read_artifact_meta(path)[k]
            for k in ("quantized", "quantized_layers", "param_dtypes")}


@pytest.mark.parametrize("arm", ["int8", "fp8", "fp32"])
def test_artifact_headers_equal_the_reference(arm, tmp_path):
    value = {"int8": True, "fp8": "fp8", "fp32": False}[arm]
    x = _exact_batches(1)[0]
    headers, rows = {}, {}
    for pkg in (tmx, jmx):
        net = _small_net(pkg, exact=False)
        QUANT[pkg].quantize_net(net, _calibrated(pkg, net))
        path = str(tmp_path / f"{pkg.__name__}.mxje")
        with AT[pkg].force(quantized_conv=value, quantized_fc=value):
            rows[pkg] = _np(net(pkg.nd.array(x)))
            pkg.deploy.export_model(net, x, path)
        headers[pkg] = _header(pkg, path)
    assert headers[tmx] == headers[jmx]
    assert headers[tmx]["quantized"] is (arm != "fp32")
    served = tmx.deploy.load_model(path.replace("mxnet_tpu.",
                                                "mxnet_tpu_torch."),
                                   ctx=tmx.cpu())(x).asnumpy()
    onp.testing.assert_array_equal(served, rows[tmx])


def test_int8_weights_travel_as_int8_in_params(tmp_path):
    from mxnet_tpu_torch.deploy import _SYMBOL_HEADER, _SYMBOL_MAGIC
    from mxnet_tpu_torch.ndarray.ndarray import load_buffer

    net = _small_net(tmx, exact=False)
    tq.quantize_net(net, _calibrated(tmx, net))
    x = _exact_batches(1)[0]
    path = str(tmp_path / "q.mxje")
    with t_at.force(quantized_conv=True, quantized_fc=True):
        tmx.deploy.export_model(net, x, path)
    _, blob = tmx.deploy._read_meta_payload(path)
    off = len(_SYMBOL_MAGIC)
    n_graph, _ = _SYMBOL_HEADER.unpack_from(blob, off)
    params = load_buffer(blob[off + _SYMBOL_HEADER.size + n_graph:])
    dtypes = {k: str(v._data.dtype) for k, v in params.items()}
    conv = [w for w in tq.quantized_layers(net) if w.variant_op][0]
    assert dtypes[f"arg:{conv._orig.name}_wq"] == "torch.int8"
    # the shadowed fp32 weights are not in the program
    assert f"arg:{conv._orig.name}_weight" not in dtypes
    assert sum(d == "torch.int8" for d in dtypes.values()) == 4


def _drill_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="drill_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
                nn.Dense(4, in_units=8 * 8 * 8))
    return net


def test_drill_calibrate_rewrite_export_serve(tmp_path):
    """The reference's drill on the port: a small net trained by the
    Gluon loop (its weights carried into the reference's net by a
    ``.params`` file), calibrated with ``entropy``, rewritten, exported
    under the int8 force scope and served by ``ModelServer.
    from_artifact`` on the host."""
    from mxnet_tpu_torch.serving import ModelServer

    rng = onp.random.RandomState(42)
    nclass, item = 4, (3, 16, 16)
    protos = rng.rand(nclass, *item).astype("float32")

    def make_batch(n):
        y = rng.randint(0, nclass, n)
        return ((protos[y] + 0.15 * rng.rand(n, *item)).astype("float32"),
                y.astype("float32"))

    onp.random.seed(0)
    net = _drill_net(tmx)
    net.initialize(tmx.init.Xavier())
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.2})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(60):
        xb, yb = make_batch(32)
        with tmx.autograd.record():
            loss = loss_fn(net(tmx.nd.array(xb)), tmx.nd.array(yb))
        loss.backward()
        trainer.step(32)
    weights = str(tmp_path / "drill.params")
    net.save_parameters(weights)
    jnet = _drill_net(jmx)
    jnet.load_parameters(weights)
    corpus = [make_batch(32)[0] for _ in range(4)]
    fp32 = onp.concatenate([net(tmx.nd.array(b)).asnumpy()
                            for b in corpus])
    headers = {}
    for pkg, n in ((tmx, net), (jmx, jnet)):
        calib = QUANT[pkg].calibrate(n, [pkg.nd.array(b) for b in corpus],
                                     mode="entropy", num_batches=4)
        QUANT[pkg].quantize_net(n, calib)
        path = str(tmp_path / f"int8_{pkg.__name__}.mxje")
        with AT[pkg].force(quantized_conv=True, quantized_fc=True):
            pkg.deploy.export_model(n, corpus[0], path)
        headers[pkg] = _header(pkg, path)
    assert headers[tmx] == headers[jmx]
    assert headers[tmx]["quantized"] is True
    srv = ModelServer.from_artifact(str(tmp_path / "int8_mxnet_tpu_torch"
                                        ".mxje"), ctx=tmx.cpu(),
                                    slo_ms=60000.0, coalesce_ms=1.0)
    srv.start(warm=True)
    try:
        handles = [srv.submit(x) for x in onp.concatenate(corpus)]
        served = onp.stack([h.result(timeout=120) for h in handles])
    finally:
        srv.close()
    agreement = (served.argmax(1) == fp32.argmax(1)).mean()
    assert agreement >= 0.99, agreement


def test_model_host_reports_a_quantized_artifact(tmp_path):
    from mxnet_tpu_torch.serving import ModelHost

    net = _small_net(tmx, exact=False)
    x = _exact_batches(1)[0]
    fp32 = str(tmp_path / "fp32.mxje")
    tmx.deploy.export_model(net, x, fp32)
    tq.quantize_net(net, _calibrated(tmx, net))
    int8 = str(tmp_path / "int8.mxje")
    with t_at.force(quantized_conv=True, quantized_fc=True):
        tmx.deploy.export_model(net, x, int8)
        want = net(tmx.nd.array(x)).asnumpy()
    host = ModelHost(server_kw={"slo_ms": 60000.0})
    try:
        host.load("fp32", fp32)
        host.load("int8", int8)
        models = host.residency()["models"]
        got = host.submit(x[1], model="int8").result(timeout=60)
    finally:
        host.close_all()
    assert models["int8"]["quantized"] is True
    assert models["fp32"]["quantized"] is False
    assert models["int8"]["param_dtypes"]["int8"] == 4
    onp.testing.assert_array_equal(got, want[1])


# ----------------------------------------------------- the arms' race
_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as onp
    sys.path.insert(0, %r)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization as quant
    nn = mx.gluon.nn
    with mx.cpu():
        onp.random.seed(0)
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                    nn.MaxPool2D(), nn.AvgPool2D(), nn.Flatten(),
                    nn.Dense(10, in_units=32))
        net.initialize(mx.init.Xavier())
        rs = onp.random.RandomState(1)
        corpus = [(rs.randint(-8, 9, (4, 3, 8, 8)) / 2).astype("float32")
                  for _ in range(3)]
        quant.quantize_net(net, quant.calibrate(net, corpus))
        rep = quant.tune_quantized(net, corpus[0], iters=2)
    print(json.dumps({op: {"winner": r["winner"], "cached": r["cached"]}
                      for op, r in rep.items()}))
""") % ROOT


def test_race_winners_persist_across_processes_keyed_by_platform(
        tmp_path, monkeypatch):
    net = _small_net(tmx, exact=False)
    tq.quantize_net(net, _calibrated(tmx, net))
    report = tq.tune_quantized(net, _exact_batches(1)[0], iters=2)
    assert set(report) == {"quantized_conv", "quantized_fc"}
    for r in report.values():
        assert r["winner"] in ("fp32", "int8", "fp8") and not r["cached"]
        assert set(r["timings"]) == {"fp32", "int8", "fp8"}
    for w in tq.quantized_layers(net):
        if w.variant_op is not None:
            arm = report[w.variant_op]["winner"]
            assert w._arm() == arm
    path = tmp_path / "at" / "autotune.json"
    keys = json.loads(path.read_text())["entries"]
    assert {k.split("|")[0] for k in keys} == set(report)
    assert all(k.split("|")[3] == "cpu" for k in keys)
    env = dict(os.environ, MXNET_AUTOTUNE_CACHE_DIR=str(tmp_path / "at"))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    child = json.loads(out.stdout.strip().splitlines()[-1])
    for op, r in report.items():
        assert child[op] == {"winner": r["winner"], "cached": True}
    # a winner recorded for the card does not answer for the host
    t_at.record("quantized_conv", (4, 3, 8, 8), "float32", "fp8", "cuda")
    assert t_at.lookup("quantized_conv", (4, 3, 8, 8), "float32",
                       "cpu") == report["quantized_conv"]["winner"]
    for raw, arm in (("fp32", "fp32"), ("0", "fp32"), ("1", "int8"),
                     ("fp8", "fp8")):
        monkeypatch.setenv("MXNET_QUANTIZE", raw)
        assert {w._arm() for w in tq.quantized_layers(net)
                if w.variant_op is not None} == {arm}
    monkeypatch.setenv("MXNET_AUTOTUNE", "0")
    assert tq.tune_quantized(net, _exact_batches(1)[0]) == {}


# ------------------------------------------------- contrib.quantization
def test_contrib_calibrators_equal_the_reference():
    rs = onp.random.RandomState(5)
    samples = [rs.randn(64, 8).astype("float32") * s for s in (1, 3)]
    assert tcq.calib_minmax(samples) == jcq.calib_minmax(samples)
    got, want = tcq.calib_entropy(samples), jcq.calib_entropy(samples)
    assert abs(got[1] - want[1]) <= ENTROPY_TOL * abs(want[1])


def test_contrib_quantize_net_matches_the_reference():
    x = _exact_batches(1, shape=(4, 12))[0]
    outs = {}
    for pkg, cq in ((tmx, tcq), (jmx, jcq)):
        nn = pkg.gluon.nn
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", in_units=12),
                    nn.Dense(5, in_units=16))
        net.initialize(pkg.init.Xavier())
        _exact_values(pkg, net, 3)
        cq.quantize_net(net, [pkg.nd.array(b) for b in _exact_batches(
            2, shape=(4, 12))])
        assert [type(c).__name__ for c in net._children.values()] == \
            ["QuantizedDense", "QuantizedDense"]
        outs[pkg] = _np(net(pkg.nd.array(x)))
    onp.testing.assert_array_equal(outs[tmx], outs[jmx])
    with pytest.raises(MXNetError, match="int8"):
        tcq.quantize_net(net, [], quantized_dtype="uint8")


def test_public_names_are_the_references():
    import mxnet_tpu.contrib.amp as j_amp

    import mxnet_tpu_torch.contrib.amp as t_amp

    assert set(tq.__all__) == set(jq.__all__)
    assert set(tcq.__all__) == set(jcq.__all__)
    assert set(j_amp.__all__) <= set(t_amp.__all__)
    for mod in (tq, tcq, t_amp):
        for name in mod.__all__:
            assert hasattr(mod, name), name
    assert tmx.contrib.quantization is tcq
