"""``mx.library.load`` and the port's operator plugin
(``mxnet_tpu_torch/library.py``,
``mxnet_tpu_torch/example/plugin/cuda_ops.py``) held against the JAX
package's loader and its plugin (``example/plugin/pallas_ops.py``) on
the CPU.

The reference plugin runs as its own test runs it on the CPU: its
Pallas call cannot lower there and it computes ``x + y * scale`` in
jnp; the port's op takes its kernel's plain version on a CPU tensor.
Values and gradients are exact in fp32, bf16 and int32 (one rounding
per op in both), but for the gradient of a broadcast operand, a sum:
in fp32 the two sum in another order (2 fp32 ulps); in bf16 the
reference's XLA:CPU rounds every partial sum to bf16 where PyTorch
sums in fp32 and rounds once, so each is held exactly to its own sum.  ``plugin_swish``: rtol 1e-5 /
atol 1e-7 in fp32 (another sigmoid and its derivative); in bf16 one
ulp for the value, four for its gradient.
"""
import math
import os

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autograd as jag  # noqa: E402
from mxnet_tpu import nd as jnd  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as tag  # noqa: E402
from mxnet_tpu_torch import nd as tnd  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

from mxnet_tpu_torch.dtype import dtype_name  # noqa: E402

from test_torch_ndarray import _assert_same, _ref_dtype  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF_PLUGIN = os.path.join(_ROOT, "example", "plugin", "pallas_ops.py")
_PLUGIN = os.path.join(_ROOT, "mxnet_tpu_torch", "example", "plugin",
                       "cuda_ops.py")
_PLUGIN_MODULE = "mxnet_tpu_torch.example.plugin.cuda_ops"


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def plugin():
    jmx.library.load(_REF_PLUGIN, verbose=False)
    return tmx.library.load(_PLUGIN, verbose=False)


def test_load_by_path_and_by_name_share_one_module(plugin, capsys):
    assert tmx.library.load(_PLUGIN) is plugin  # cached: no re-register
    assert tmx.library.load(_PLUGIN_MODULE, verbose=False) is plugin
    assert tmx.library.load(os.path.relpath(_PLUGIN), verbose=False) \
        is plugin
    assert capsys.readouterr().out == ""
    assert hasattr(tnd, "plugin_scaled_add") and hasattr(tnd,
                                                         "plugin_swish")
    assert hasattr(tnd.op, "plugin_scaled_add")
    libs = tmx.library.loaded_libraries()
    assert libs[_PLUGIN] is plugin and libs[_PLUGIN_MODULE] is plugin
    assert tmx.library.compiled_with_cxx11_abi() is False


def test_load_by_module_name_prints_the_reference_line(tmp_path, capsys,
                                                        monkeypatch):
    (tmp_path / "my_torch_ops.py").write_text(
        "import torch\n"
        "def register_ops(registry):\n"
        "    @registry.register_op('my_scaled_relu')\n"
        "    def my_scaled_relu(x, *, scale=1.0):\n"
        "        return torch.relu(x) * scale\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    mod = tmx.library.load("my_torch_ops")
    assert capsys.readouterr().out == \
        "[mx.library] loaded 'my_torch_ops': my_scaled_relu\n"
    assert tmx.library.load("my_torch_ops") is mod
    out = tnd.my_scaled_relu(tnd.array([-1.0, 2.0]), scale=3.0)
    onp.testing.assert_array_equal(out.asnumpy(), [0.0, 6.0])


@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["reference", "port"])
def test_empty_plugin_is_refused(pkg, tmp_path):
    p = tmp_path / f"empty_plugin_{pkg.__name__}.py"
    p.write_text("x = 1\n")
    with pytest.raises(pkg.base.MXNetError,
                       match="registered no operators"):
        pkg.library.load(str(p), verbose=False)


@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["reference", "port"])
def test_missing_module_is_refused(pkg):
    with pytest.raises(pkg.base.MXNetError, match="neither a file nor an "
                                                  "importable module"):
        pkg.library.load("no_such_module_xyz", verbose=False)


def test_failing_plugin_is_refused(tmp_path):
    p = tmp_path / "broken_plugin.py"
    p.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(MXNetError, match="failed to initialize: boom"):
        tmx.library.load(str(p), verbose=False)


_R = onp.random.RandomState(4)
_CASES = [
    # (x, y, dtype of x, dtype of y, scale)
    ((3, 4), (3, 4), "float32", "float32", 0.5),
    ((3, 4), (3, 4), "float32", "float32", 0.1),
    ((2, 3, 8), (2, 3, 8), "bfloat16", "bfloat16", 0.1),
    ((2, 3, 8), (8,), "bfloat16", "bfloat16", -1.25),
    ((4, 5), (5,), "float32", "float32", 2.0),
    ((4, 1), (1, 6), "float32", "float32", 0.3),
    ((3, 4), (3, 4), "int32", "int32", 2.7),
    ((3, 4), (4,), "int32", "int32", -3.0),
    ((3, 4), (3, 4), "bfloat16", "float32", 0.1),
    ((3, 4), (3, 4), "float16", "float16", 0.1),
    ((0, 4), (4,), "float32", "float32", 1.5),
    ((), (), "float32", "float32", 1.5),
]


def _make(shape, dtype, seed):
    r = onp.random.RandomState(seed)
    if dtype == "int32":
        return r.randint(-50, 50, shape).astype("int32")
    return onp.asarray(r.randn(*shape) * 3, dtype="float32")


def _scaled_add_both(case, record):
    xs, ys, xd, yd, scale = _CASES[case]
    x, y = _make(xs, xd, case), _make(ys, yd, 100 + case)
    res = []
    for nd, ag in ((jnd, jag), (tnd, tag)):
        a, b = nd.array(x, dtype=xd), nd.array(y, dtype=yd)
        if record:
            a.attach_grad()
            b.attach_grad()
            with ag.record():
                out = nd.plugin_scaled_add(a, b, scale=scale)
                loss = (out * out).sum()
            loss.backward()
            res.append((out, a.grad, b.grad))
        else:
            res.append((nd.plugin_scaled_add(a, b, scale=scale),))
    return res


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_scaled_add_matches_reference(plugin, case):
    (want,), (got,) = _scaled_add_both(case, record=False)
    _assert_same(got, want)


@pytest.mark.parametrize("case", [0, 1, 2, 4, 5, 8, 9])
def test_scaled_add_gradients_match_reference(plugin, case):
    want, got = _scaled_add_both(case, record=True)
    xs, ys, xd, _, _ = _CASES[case]
    summed = xs != ys and xd == "float32"
    for g, w in zip(got, want):
        _assert_same(g, w, 2 if summed else 0)


def test_scaled_add_bf16_broadcast_gradient(plugin):
    """Case 3: y of shape [8] broadcast over (2, 3, 8) in bf16.  The
    port's dy is the correctly rounded ``bf16(bf16(sum g) * s)``; the
    reference's is the same product of a sum whose every partial was
    rounded to bf16, in row order."""
    want, got = _scaled_add_both(3, record=True)
    _assert_same(got[1], want[1])  # x's gradient is not summed
    g = 2 * torch.from_numpy(got[0].asnumpy()).to(torch.bfloat16)
    s = torch.tensor(-1.25, dtype=torch.bfloat16)
    exact = g.double().sum(dim=(0, 1)).to(torch.bfloat16) * s
    onp.testing.assert_array_equal(got[2].asnumpy(), exact.float().numpy())
    partial = torch.zeros(8, dtype=torch.bfloat16)
    for row in g.reshape(-1, 8):
        partial = partial + row
    onp.testing.assert_array_equal(want[2].asnumpy().astype("float32"),
                                   (partial * s).float().numpy())


def test_scaled_add_gradient_is_exact(plugin):
    a = tnd.array(_make((2, 8), "bfloat16", 1), dtype="bfloat16")
    b = tnd.array(_make((2, 8), "bfloat16", 2), dtype="bfloat16")
    a.attach_grad()
    b.attach_grad()
    with tag.record():
        out = tnd.plugin_scaled_add(a, b, scale=0.1)
    out.backward()
    onp.testing.assert_array_equal(a.grad.asnumpy(), onp.ones((2, 8)))
    s = torch.tensor(0.1, dtype=torch.bfloat16).float().item()
    onp.testing.assert_array_equal(b.grad.asnumpy(), onp.full((2, 8), s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swish_and_gradient_match_reference(plugin, dtype):
    x = _make((3, 5), "float32", 9)
    res = []
    for nd, ag in ((jnd, jag), (tnd, tag)):
        a = nd.array(x, dtype=dtype)
        a.attach_grad()
        with ag.record():
            out = nd.plugin_swish(a, beta=1.5)
            y = (out ** 2).sum()
        y.backward()
        res.append((out, a.grad))
    # bf16: the value to one bf16 ulp, the gradient (a chain of six bf16
    # roundings, taken in other places) to four
    tols = (1e-5, 1e-5) if dtype == "float32" else (2 ** -7, 2 ** -5)
    for g, w, tol in zip(res[1], res[0], tols):
        assert dtype_name(g.dtype) == _ref_dtype(w)
        onp.testing.assert_allclose(g.asnumpy(), w.asnumpy().astype(
            "float32"), rtol=tol, atol=tol / 100)


def test_wrapper_takes_the_plain_version_on_the_cpu(plugin):
    x = torch.randn(5, 7)
    y = torch.randn(5, 7)
    before = plugin.scaled_add.launches
    got = plugin.scaled_add(x, y, 0.3)
    want = plugin._scaled_add_plain(x, y, torch.tensor(0.3))
    assert torch.equal(got, want)
    assert plugin.scaled_add.launches == before  # no kernel on the CPU
    t = x.t()  # a transposed view
    assert torch.equal(plugin.scaled_add(t, t, 2.0), t + t * 2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int64])
def test_scale_value_is_the_scale_tensors_value(plugin, dtype):
    """The wrapper's cached scale equals the 0-d tensor the plain version
    multiplies by (the reference's ``jnp.asarray(scale, x.dtype)``),
    for random and edge values, twice (the second a cache hit)."""
    rng = onp.random.RandomState(4)
    values = [0.5, 0.1, 1.0 / 3, -2.75, 7, 0, 1e-8, 65504.0, 3.7, -3.7]
    values += [float(v) for v in rng.randn(50) * 10.0 ** rng.randint(
        -6, 4, 50)]
    # -0.0 after 0.0 (and back) is looked up apart from it: equal as
    # floats, they differ in the sign the product carries
    values += [0.0, -0.0, 0.0, -0.0, 1, 1.0, True]
    for v in values:
        want = plugin._scale_tensor(v, dtype).item()
        for _ in range(2):
            got = plugin._scale_value(v, dtype)
            assert got == want and type(got) is type(want)
            assert math.copysign(1.0, got) == math.copysign(1.0, want)
