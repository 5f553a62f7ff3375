"""The fp8 arm of the port's quantized inference held against the JAX
package on the CPU: ``_contrib_quantize_fp8`` (e4m3 codes bit for bit,
a planted +-1000 clipped to +-448 before the cast, never NaN), the fp8
products (``_contrib_fp8_fully_connected`` / ``_contrib_fp8_conv``:
e4m3 x e4m3 accumulated in float32, to 4 fp32 ulps of the largest
|output|; the two packages sum in other orders), the rewrite's baked
e4m3 weights (bit for bit), its fp8 forward (1e-6 of the largest
logit), the artifact's e4m3 weights (float32 in ``.params``, e4m3 again
at load) and the loud failure of a build without float8.  On the host
the products widen e4m3 to float32; the card's ``torch._scaled_mm`` is
held to the plain product in ``tests/test_torch_cuda.py``.
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import quantization as jq  # noqa: E402
from mxnet_tpu.contrib.amp import lists as j_lists  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import dtype as t_dtype  # noqa: E402
from mxnet_tpu_torch import quantization as tq  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.contrib.amp import lists as t_lists  # noqa: E402

PRODUCT_ULPS = 4
LOGIT_TOL = 1e-6
QUANT = {jmx: jq, tmx: tq}
AT = {jmx: j_at, tmx: t_at}


@pytest.fixture(autouse=True)
def _host(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path / "at"))
    monkeypatch.delenv("MXNET_QUANTIZE", raising=False)
    with tmx.cpu():
        yield


def _f32(a):
    """numpy float32 of an NDArray or a tensor (the reference's e4m3
    arrays are ml_dtypes; the port's asnumpy widens them already)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return onp.asarray(a.asnumpy()).astype("float32")


def _run(pkg, name, arrays, params):
    out = pkg.nd.invoke(name, [pkg.nd.array(a, dtype=a.dtype)
                               for a in arrays], **params)
    return [_f32(o) for o in (out if isinstance(out, list) else [out])]


def _r(v):
    return onp.array([v], "float32")


@pytest.mark.parametrize("calibrated", [True, False])
def test_quantize_fp8_codes_equal_the_reference(calibrated):
    x = onp.random.RandomState(0).randn(4, 3, 9, 9).astype("float32")
    x[0, 0, 0, :2] = [1000.0, -1000.0]  # past the calibrated range
    kw = dict(min_calib_range=-2.0, max_calib_range=2.0) if calibrated \
        else {}
    got = _run(tmx, "_contrib_quantize_fp8", [x], kw)
    want = _run(jmx, "_contrib_quantize_fp8", [x], kw)
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)
    assert not onp.isnan(got[0]).any()
    if calibrated:
        assert got[0][0, 0, 0, :2].tolist() == [448.0, -448.0]
    q = tmx.nd.invoke("_contrib_quantize_fp8", [tmx.nd.array(x)])[0]
    assert q._data.dtype == torch.float8_e4m3fn


def _e4m3_values(shape, seed):
    return onp.clip(onp.random.RandomState(seed).randn(*shape) * 100,
                    -448, 448).astype("float32")


FP8_CASES = {
    "fc": ("_contrib_fp8_fully_connected",
           [_e4m3_values((16, 96), 1), _e4m3_values((24, 96), 2),
            onp.random.RandomState(3).randn(24).astype("float32"),
            _r(3.0), _r(0.5)], dict(num_hidden=24)),
    "fc_no_bias": ("_contrib_fp8_fully_connected",
                   [_e4m3_values((2, 4, 12), 4), _e4m3_values((6, 48), 5),
                    onp.zeros(6, "float32"), _r(1.0), _r(2.0)],
                   dict(num_hidden=6, no_bias=True)),
    "conv": ("_contrib_fp8_conv",
             [_e4m3_values((2, 8, 9, 9), 6), _e4m3_values((8, 8, 3, 3), 7),
              onp.random.RandomState(8).randn(8).astype("float32"),
              _r(3.0), _r(0.5)],
             dict(kernel=(3, 3), num_filter=8, pad=(1, 1), stride=(2, 2))),
    "conv_groups": ("_contrib_fp8_conv",
                    [_e4m3_values((2, 8, 7, 7), 9),
                     _e4m3_values((4, 2, 3, 3), 10),
                     onp.zeros(4, "float32"), _r(1.5), _r(0.25)],
                    dict(kernel=(3, 3), num_filter=4, num_group=4,
                         no_bias=True)),
}


@pytest.mark.parametrize("case", sorted(FP8_CASES))
def test_fp8_products_match_the_reference(case):
    name, arrays, params = FP8_CASES[case]
    (got,), (want,) = (_run(p, name, arrays, params) for p in (tmx, jmx))
    assert got.shape == want.shape
    tol = PRODUCT_ULPS * onp.spacing(onp.abs(want).max())
    assert onp.abs(got - want).max() <= tol


def _net(pkg, seed=0):
    nn = pkg.gluon.nn
    onp.random.seed(seed)
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
                nn.Dense(10, in_units=8 * 4 * 4))
    net.initialize(pkg.init.Xavier())
    return net


def _batches(n=3, seed=1):
    rs = onp.random.RandomState(seed)
    return [(rs.randint(-8, 9, (4, 3, 8, 8)) / 2).astype("float32")
            for _ in range(n)]


def _quantized(pkg):
    net = _net(pkg)
    cal = QUANT[pkg].calibrate(net, [pkg.nd.array(b) for b in _batches()],
                               mode="naive")
    return QUANT[pkg].quantize_net(net, cal)


def test_baked_e4m3_weights_and_fp8_forward_equal_the_reference():
    x = _batches(1, seed=5)[0]
    baked, logits = {}, {}
    for pkg in (tmx, jmx):
        net = _quantized(pkg)
        baked[pkg] = [(_f32(w._w8), _f32(w._w8_amax), _f32(w._b32))
                      for w in QUANT[pkg].quantized_layers(net)
                      if w.variant_op is not None]
        with AT[pkg].force(quantized_conv="fp8", quantized_fc="fp8"):
            logits[pkg] = _f32(net(pkg.nd.array(x)))
    assert len(baked[tmx]) == len(baked[jmx]) == 2
    for got, want in zip(baked[tmx], baked[jmx]):
        for g, w in zip(got, want):
            onp.testing.assert_array_equal(g, w)
    want = logits[jmx]
    assert onp.abs(logits[tmx] - want).max() <= LOGIT_TOL * onp.abs(
        want).max()


def test_fp8_arm_pinned_by_the_env_and_exported_as_float32(tmp_path,
                                                           monkeypatch):
    """``MXNET_QUANTIZE=fp8`` pins the arm; the artifact carries the
    e4m3 weights as float32 (no mshadow flag) and its graph says e4m3,
    so the loaded block holds them as e4m3 again and serves the eager
    forward bit for bit."""
    net = _quantized(tmx)
    x = _batches(1, seed=5)[0]
    monkeypatch.setenv("MXNET_QUANTIZE", "fp8")
    assert {w._arm() for w in tq.quantized_layers(net)
            if w.variant_op is not None} == {"fp8"}
    want = net(tmx.nd.array(x)).asnumpy()
    path = str(tmp_path / "fp8.mxje")
    tmx.deploy.export_model(net, x, path)
    meta = tmx.deploy.read_artifact_meta(path)
    assert meta["quantized"] is True and meta["quantized_layers"] == 2
    assert meta["param_dtypes"]["float8_e4m3fn"] == 2
    monkeypatch.delenv("MXNET_QUANTIZE")
    exp = tmx.deploy.load_exported(path, ctx=tmx.cpu())
    held = {n: str(p.data()._data.dtype)
            for n, p in exp.block.collect_params().items()}
    assert sum(d == "torch.float8_e4m3fn" for d in held.values()) == 2
    onp.testing.assert_array_equal(exp.call(x).numpy(), want)


def test_missing_float8_support_is_loud(monkeypatch):
    assert t_dtype.float8_supported()
    assert t_dtype.normalize_dtype("fp8") == torch.float8_e4m3fn
    assert t_dtype.normalize_dtype("e5m2") == torch.float8_e5m2
    net = _quantized(tmx)
    monkeypatch.setattr(t_dtype, "float8_supported", lambda: False)
    with pytest.raises(MXNetError, match="float8"):
        t_dtype.normalize_dtype("float8_e4m3fn")
    w = next(w for w in tq.quantized_layers(net) if w.variant_op)
    with t_at.force(quantized_conv="fp8"):
        with pytest.raises(MXNetError, match="float8"):
            w._arm()
    with t_at.force(quantized_conv=True):
        assert w._arm() == "int8"  # the other arms keep working


def test_amp_fp8_list_is_the_references_and_inside_the_target_list():
    assert t_lists.FP8_OPS == j_lists.FP8_OPS
    assert set(t_lists.FP8_OPS) <= set(t_lists.TARGET_DTYPE_OPS)
    assert not set(t_lists.FP8_OPS) & set(t_lists.FP32_OPS)
