"""The port's layer ops and symbolic front end (``mx.sym``, the graph
``Executor``) held against the JAX package on the CPU.

Every input is numpy from a seed, fed to both packages (the port inside
``with mx.cpu():``; its default context is the card).

Tolerances: each newly registered op's forward and input gradient in
fp32 to 1e-5 (absolute and relative); symbol JSON byte for byte; a
traced ResNet-18's outputs, gradients and moving statistics to 1e-4 of
each tensor's largest magnitude (the packages sum convolutions in other
orders; BatchNorm amplifies the difference); the fused BN-ReLU-1x1-conv
op through a symbol to 1e-4.
"""
import json
import os
import re
import sys

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import registry as t_reg  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402

OP_TOL = 1e-5
NET_TOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


# ------------------------------------------------------------------ ops
def _rs(seed):
    return onp.random.RandomState(seed)


def _f32(*shape, seed=0, scale=1.0):
    return (_rs(seed).randn(*shape) * scale).astype("float32")


def _labels(n, k, seed=1, ignore=None):
    lab = _rs(seed).randint(0, k, n).astype("float32")
    if ignore is not None:
        lab[::3] = ignore
    return lab


#: name -> (op, inputs, params, indices of inputs whose gradient is held,
#: train mode)
OP_CASES = {
    "fc": ("FullyConnected", lambda: [_f32(4, 3, 5), _f32(6, 15, seed=1),
                                      _f32(6, seed=2)],
           dict(num_hidden=6), (0, 1, 2), False),
    "fc_no_flatten": ("FullyConnected", lambda: [_f32(4, 3, 5),
                                                 _f32(6, 5, seed=1)],
                      dict(num_hidden=6, no_bias=True, flatten=False),
                      (0, 1), False),
    **{f"act_{a}": ("Activation", lambda: [_f32(3, 7)], dict(act_type=a),
                    (0,), False)
       for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign")},
    **{f"leaky_{a}": ("LeakyReLU", lambda: [_f32(3, 7)],
                      dict(act_type=a, slope=0.3), (0,), False)
       for a in ("leaky", "elu", "selu", "gelu")},
    "leaky_prelu": ("LeakyReLU", lambda: [_f32(2, 4, 3),
                                          _f32(4, seed=1, scale=0.2)],
                    dict(act_type="prelu"), (0, 1), False),
    **{f"leaky_rrelu_train{int(tr)}": (
        "LeakyReLU", lambda: [_f32(3, 7)],
        dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.4), (0,), tr)
       for tr in (True, False)},
    # Dropout where it draws nothing: in inference, and at p = 0
    "dropout_predict": ("Dropout", lambda: [_f32(3, 7)], dict(p=0.5),
                        (0,), False),
    "dropout_p0": ("Dropout", lambda: [_f32(3, 7)], dict(p=0.0), (0,),
                   True),
    "softmax": ("softmax", lambda: [_f32(3, 4, 5)],
                dict(axis=1, temperature=2.0), (0,), False),
    "softmax_length": ("softmax", lambda: [
        _f32(3, 6), onp.array([2, 6, 4], "float32")],
        dict(axis=-1, use_length=True), (0,), False),
    "log_softmax": ("log_softmax", lambda: [_f32(3, 5)],
                    dict(axis=-1, temperature=0.5), (0,), False),
    "softmin": ("softmin", lambda: [_f32(3, 5)], dict(axis=0), (0,),
                False),
    "softmax_act_instance": ("SoftmaxActivation", lambda: [_f32(2, 3, 4)],
                             dict(mode="instance"), (0,), False),
    "softmax_act_channel": ("SoftmaxActivation", lambda: [_f32(2, 3, 4)],
                            dict(mode="channel"), (0,), False),
    **{f"bn_fix{int(fg)}_global{int(gs)}_train{int(tr)}": (
        "BatchNorm", lambda: [_f32(4, 3, 5, 5), _f32(3, seed=1),
                              _f32(3, seed=2),
                              _f32(3, seed=3, scale=0.1),
                              onp.abs(_f32(3, seed=4)) + 0.5],
        dict(fix_gamma=fg, use_global_stats=gs, eps=1e-3, momentum=0.8),
        (0, 1, 2), tr)
       for fg in (True, False) for gs in (True, False) for tr in (True,
                                                                   False)},
    "bn_axis_last_mean_var": ("BatchNorm", lambda: [
        _f32(4, 5, 3), _f32(3, seed=1), _f32(3, seed=2), _f32(3, seed=3),
        onp.abs(_f32(3, seed=4)) + 0.5],
        dict(fix_gamma=False, axis=-1, output_mean_var=True), (0, 1, 2),
        True),
    **{f"softmax_output_{norm}": (
        "SoftmaxOutput", lambda: [_f32(6, 5), _labels(6, 5)],
        dict(normalization=norm, grad_scale=0.7), (0,), True)
       for norm in ("null", "batch", "valid")},
    "softmax_output_ignore": ("SoftmaxOutput", lambda: [
        _f32(6, 5), _labels(6, 5, ignore=-1.0)],
        dict(use_ignore=True, ignore_label=-1.0, normalization="valid"),
        (0,), True),
    "softmax_output_multi": ("SoftmaxOutput", lambda: [
        _f32(2, 4, 3, 3), _labels(18, 4).reshape(2, 3, 3)],
        dict(multi_output=True, smooth_alpha=0.1), (0,), True),
    "softmax_alias": ("Softmax", lambda: [_f32(6, 5), _labels(6, 5)],
                      dict(), (0,), True),
    **{f"regression_{k}": (k, lambda: [_f32(4, 3), _f32(4, 3, seed=1)],
                           dict(grad_scale=1.5), (0,), True)
       for k in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput")},
    "conv_nchw": ("Convolution", lambda: [_f32(2, 4, 7, 7),
                                          _f32(6, 2, 3, 3, seed=1),
                                          _f32(6, seed=2)],
                  dict(kernel=(3, 3), num_filter=6, stride=(2, 1),
                       pad=(1, 1), dilate=(1, 2), num_group=2,
                       workspace=512, cudnn_tune="off"), (0, 1, 2), False),
    "conv_nhwc_1x1": ("Convolution", lambda: [_f32(2, 5, 5, 4),
                                              _f32(6, 1, 1, 4, seed=1)],
                      dict(kernel=(1, 1), num_filter=6, no_bias=True,
                           layout="NHWC"), (0, 1), False),
    "conv1d": ("Convolution", lambda: [_f32(2, 3, 9), _f32(4, 3, 3, seed=1),
                                       _f32(4, seed=2)],
               dict(kernel=(3,), num_filter=4, pad=(1,)), (0, 1, 2), False),
    **{f"pool_{t}_{c}": ("Pooling", lambda: [_f32(2, 3, 7, 7)],
                         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type=t, pooling_convention=c), (0,),
                         False)
       for t in ("max", "avg", "sum") for c in ("valid", "full")},
    "pool_lp": ("Pooling", lambda: [onp.abs(_f32(2, 3, 6, 6)) + 0.1],
                dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                     p_value=2), (0,), False),
    "pool_avg_no_pad_count": ("Pooling", lambda: [_f32(2, 3, 6, 6)],
                              dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                   pool_type="avg",
                                   count_include_pad=False), (0,), False),
    "pool_global_nhwc": ("Pooling", lambda: [_f32(2, 5, 5, 3)],
                         dict(kernel=(1, 1), global_pool=True,
                              pool_type="avg", pooling_convention="full",
                              layout="NHWC"), (0,), False),
    "bnreluconv": ("_contrib_BNReluConv", lambda: [
        _f32(2, 4, 4, 8), onp.abs(_f32(8, seed=1)) + 0.5, _f32(8, seed=2),
        _f32(6, 1, 1, 8, seed=3)],
        dict(eps=1e-5, fix_gamma=False), (0, 1, 2, 3), True),
}


def _op_run(pkg, name, arrays, params, grad_of, train):
    xs = [pkg.nd.array(a) for a in arrays]
    for i in grad_of:
        xs[i].attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = getattr(pkg.nd, name)(*xs, **params)
        outs = out if isinstance(out, (list, tuple)) else [out]
        y = outs[0]
    head = _f32(*y.shape, seed=9)
    y.backward(pkg.nd.array(head))
    return ([o.asnumpy() for o in outs],
            [xs[i].grad.asnumpy() for i in grad_of])


@pytest.mark.parametrize("case", list(OP_CASES))
def test_registered_op_matches_reference(case):
    name, make, params, grad_of, train = OP_CASES[case]
    arrays = make()
    j_outs, j_grads = _op_run(jmx, name, arrays, params, grad_of, train)
    t_outs, t_grads = _op_run(tmx, name, arrays, params, grad_of, train)
    assert len(t_outs) == len(j_outs)
    for t, j in zip(t_outs + t_grads, j_outs + j_grads):
        assert t.shape == j.shape
        onp.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)


def test_op_keywords_are_the_reference_ones():
    """``symbol._parse_attrs`` drops any attribute that is not a keyword
    of the op, so a keyword missing in the port would change a loaded
    graph without an error."""
    from mxnet_tpu.ops import registry as j_reg

    names = {c[0] for c in OP_CASES.values()} | {
        "FullyConnected", "_FullyConnected", "Convolution_v1",
        "Pooling_v1", "BatchNorm_v1",
        # the ordering, detection and contrib ops
        "sort", "argsort", "topk", "_contrib_MultiBoxPrior",
        "_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
        "_contrib_box_nms", "_contrib_box_iou", "ROIPooling",
        "_contrib_ROIAlign", "_contrib_Proposal", "all_finite",
        "multi_all_finite", "_contrib_boolean_mask", "_contrib_index_copy",
        "_contrib_index_array", "_contrib_fft", "_contrib_ifft",
        "_contrib_allclose", "_contrib_gradientmultiplier",
        "_contrib_hawkesll"}
    for n in sorted(names):
        j, t = j_reg.get_op(n), t_reg.get_op(n)
        assert t.param_names == j.param_names, n
        j_kw = {p: v.default for p, v in __import__("inspect").signature(
            j.fn).parameters.items()}
        t_kw = {p: v.default for p, v in __import__("inspect").signature(
            t.fn).parameters.items()}
        assert t_kw == j_kw, n
        assert t.train_param == j.train_param, n
        assert t.out_count({"output_mean_var": True}) == \
            j.out_count({"output_mean_var": True}), n


@pytest.mark.parametrize("name", [
    "LayerNorm", "InstanceNorm", "GroupNorm", "L2Normalization",
    "LRN", "Deconvolution", "UpSampling", "BilinearSampler",
    "GridGenerator", "SpatialTransformer", "CTCLoss",
    "softmax_cross_entropy", "IdentityAttachKLSparseReg"])
def test_ops_still_to_port_are_not_registered(name):
    with pytest.raises(MXNetError, match="not registered"):
        t_reg.get_op(name)
    assert not hasattr(tmx.sym, name) and not hasattr(tmx.nd, name)


# ----------------------------------------------------------- symbol API
def _mlp(sym, num_hidden=16, classes=4):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def test_compose_listing_and_internals_match_reference():
    j, t = _mlp(jmx.sym), _mlp(tmx.sym)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_inputs() == j.list_inputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == []
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.get_children().list_outputs() == \
        j.get_children().list_outputs()
    assert t.name == j.name == "softmax"
    # composition by call replaces the variables
    x = tmx.sym.var("x")
    c = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                               name="fc")(data=x)
    assert c.list_arguments() == ["x", "fc_weight", "fc_bias"]


def test_infer_shape_matches_reference():
    j, t = _mlp(jmx.sym), _mlp(tmx.sym)
    kw = dict(data=(8, 10), softmax_label=(8,))
    assert t.infer_shape(**kw) == j.infer_shape(**kw)
    assert t.infer_shape_partial(**kw) == j.infer_shape_partial(**kw)
    ti, ji = t.infer_type(), j.infer_type()
    assert [list(map(onp.dtype, x)) for x in ti] == \
        [list(map(onp.dtype, x)) for x in ji]
    with pytest.raises(MXNetError, match="cannot deduce"):
        (tmx.sym.var("a") + tmx.sym.var("b")).infer_shape()


@pytest.mark.parametrize("expr", ["2 * a + b / 4 - 3", "a * b - a ** 2",
                                  "(a > b) + (a <= 0.5) * 2",
                                  "3 - a / (b + 1) + -a",
                                  "1 / (a + 2) == (a != b)"])
def test_arithmetic_matches_reference(expr):
    a0, b0 = _f32(2, 3), _f32(2, 3, seed=1)
    outs = []
    for pkg in (jmx, tmx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        s = eval(expr)
        ex = s.bind(pkg.cpu(), {"a": pkg.nd.array(a0),
                                "b": pkg.nd.array(b0)})
        outs.append(ex.forward()[0].asnumpy())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=OP_TOL, atol=OP_TOL)


def test_symbol_has_no_truth_value():
    a = tmx.sym.var("a")
    with pytest.raises(MXNetError, match="boolean"):
        bool(a == a)


def _bind_mlp(pkg, grad_req):
    s = _mlp(pkg.sym)
    ex = s.simple_bind(pkg.cpu(), grad_req=grad_req, data=(8, 10),
                       softmax_label=(8,))
    for i, n in enumerate(("fc1_weight", "fc1_bias", "fc2_weight",
                           "fc2_bias")):
        shape = ex.arg_dict[n].shape
        ex.arg_dict[n]._adopt(pkg.nd.array(_f32(*shape, seed=i,
                                                scale=0.3))._data)
    return ex


@pytest.mark.parametrize("grad_req", ["write", "add",
                                      {"fc1_weight": "null"}])
def test_simple_bind_forward_backward_matches_reference(grad_req):
    feeds = dict(data=_f32(8, 10, seed=5),
                 softmax_label=_labels(8, 4, seed=6))
    res = []
    for pkg in (jmx, tmx):
        req = grad_req if isinstance(grad_req, str) else dict(
            {n: "write" for n in _mlp(pkg.sym).list_arguments()},
            **grad_req)
        ex = _bind_mlp(pkg, req)
        for _ in range(2):  # "add" accumulates across two backwards
            outs = ex.forward(is_train=True, **{k: pkg.nd.array(v)
                                                for k, v in feeds.items()})
            ex.backward()
        res.append(([o.asnumpy() for o in outs],
                    {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                    {k: v.asnumpy() for k, v in ex.output_dict.items()}))
    (jo, jg, jd), (to, tg, td) = res
    assert sorted(tg) == sorted(jg) and list(td) == list(jd)
    for t, j in zip(to, jo):
        onp.testing.assert_allclose(t, j, rtol=OP_TOL, atol=OP_TOL)
    for n in jg:
        onp.testing.assert_allclose(tg[n], jg[n], rtol=OP_TOL, atol=OP_TOL,
                                    err_msg=n)


def test_backward_needs_a_training_forward():
    ex = _bind_mlp(tmx, "write")
    ex.forward(is_train=False, data=tmx.nd.ones((8, 10)))
    with pytest.raises(MXNetError, match="before forward"):
        ex.backward()


def test_batchnorm_aux_states_match_reference():
    res = []
    x = _f32(2, 3, 4, 4, seed=3)
    for pkg in (jmx, tmx):
        bn = pkg.sym.BatchNorm(pkg.sym.Variable("data"), name="bn0")
        assert bn.list_auxiliary_states() == ["bn0_moving_mean",
                                              "bn0_moving_var"]
        assert "bn0_gamma" in bn.list_arguments()
        ex = bn.simple_bind(pkg.cpu(), data=(2, 3, 4, 4))
        ex.aux_dict["bn0_moving_var"]._adopt(pkg.nd.ones((3,))._data)
        ex.arg_dict["bn0_gamma"]._adopt(pkg.nd.array([0.5, 1, 2])._data)
        ex.forward(is_train=True, data=pkg.nd.array(x))
        train_aux = {k: v.asnumpy() for k, v in ex.aux_dict.items()}
        out = ex.forward(is_train=False, data=pkg.nd.array(x))
        res.append((train_aux, out[0].asnumpy()))
    (ja, jo), (ta, to) = res
    for k in ja:
        onp.testing.assert_allclose(ta[k], ja[k], rtol=OP_TOL, atol=OP_TOL)
    onp.testing.assert_allclose(to, jo, rtol=OP_TOL, atol=OP_TOL)


def test_reshape_and_copy_params_match_reference():
    res = []
    for pkg in (jmx, tmx):
        ex = _bind_mlp(pkg, "write")
        ex2 = ex.reshape(data=(3, 10), softmax_label=(3,))
        assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        ex2.copy_params_from({"fc2_bias": pkg.nd.array(
            onp.arange(4, dtype="float32"))})
        out = ex2.forward(data=pkg.nd.array(_f32(3, 10, seed=7)))
        res.append(out[0].asnumpy())
        with pytest.raises(Exception, match="extra"):
            ex2.copy_params_from({"bogus": pkg.nd.ones((1,))})
    onp.testing.assert_allclose(res[1], res[0], rtol=OP_TOL, atol=OP_TOL)


def test_group2ctx_is_refused():
    s = _mlp(tmx.sym)
    with pytest.raises(MXNetError, match="§A 11"):
        s.simple_bind(tmx.cpu(), group2ctx={"dev1": tmx.cpu()},
                      data=(8, 10), softmax_label=(8,))


def test_contrib_control_flow_is_refused():
    for name in ("foreach", "while_loop", "cond"):
        with pytest.raises(MXNetError, match="§A 7"):
            getattr(tmx.sym.contrib, name)


def test_bind_moves_arrays_to_the_bound_context():
    """Everything bound lands on the executor's device; here the host,
    which is all this machine has (the card case is in
    test_torch_cuda.py)."""
    s = _mlp(tmx.sym)
    args = {n: tmx.nd.zeros(sh) for n, sh in zip(
        s.list_arguments(), s.infer_shape(data=(2, 10),
                                          softmax_label=(2,))[0])}
    ex = s.bind(tmx.cpu(), args)
    assert all(a.context == tmx.cpu() for a in ex.arg_arrays)


# --------------------------------------------------------------- JSON
def test_mlp_json_is_the_reference_bytes(tmp_path):
    j, t = _mlp(jmx.sym), _mlp(tmx.sym)
    assert t.tojson() == j.tojson()
    f = str(tmp_path / "net-symbol.json")
    t.save(f)
    back = jmx.sym.load(f)
    assert back.tojson() == j.tojson()
    assert tmx.sym.load(f).tojson() == j.tojson()


def _zoo_trace(classes=10, image=32, depth="resnet18_v1"):
    """The JAX zoo net, initialized, run once on a batch (so every
    parameter shape is known), and traced on ``sym.var("data")``."""
    jmx.random.seed(0)
    onp.random.seed(0)  # the reference's initializers draw from numpy
    net = getattr(jmx.gluon.model_zoo.vision, depth)(classes=classes,
                                                     prefix="resnetv10_")
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.zeros((1, 3, image, image)))
    return net, net(jmx.sym.var("data"))


@pytest.fixture(scope="module")
def resnet18():
    return _zoo_trace()


def test_traced_resnet_json_loads_to_the_same_bytes(resnet18):
    _, jsym = resnet18
    text = jsym.tojson()
    tsym = tmx.sym.load_json(text)
    assert tsym.tojson() == text
    assert jmx.sym.load_json(tsym.tojson()).tojson() == text
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    kw = dict(data=(4, 3, 32, 32))
    assert tsym.infer_shape(**kw) == jsym.infer_shape(**kw)


LEGACY_JSON = json.dumps({
    "nodes": [
        {"op": "null", "param": {}, "name": "data", "inputs": [],
         "backward_source_id": -1},
        {"op": "null", "param": {}, "name": "fc1_weight", "inputs": [],
         "backward_source_id": -1},
        {"op": "null", "param": {}, "name": "fc1_bias", "inputs": [],
         "backward_source_id": -1},
        {"op": "FullyConnected", "param": {"no_bias": "False",
                                           "num_hidden": "8"},
         "name": "fc1", "inputs": [[0, 0], [1, 0], [2, 0]],
         "backward_source_id": -1},
        {"op": "null", "param": {}, "name": "bn1_gamma", "inputs": [],
         "backward_source_id": -1},
        {"op": "null", "param": {}, "name": "bn1_beta", "inputs": [],
         "backward_source_id": -1},
        {"op": "BatchNorm", "param": {"eps": "0.001", "fix_gamma": "True",
                                      "momentum": "0.9",
                                      "use_global_stats": "False"},
         "name": "bn1", "inputs": [[3, 0], [4, 0], [5, 0]],
         "backward_source_id": -1},
        {"op": "Activation", "param": {"act_type": "relu"},
         "name": "relu1", "inputs": [[6, 0]], "backward_source_id": -1}],
    "arg_nodes": [0, 1, 2, 4, 5], "heads": [[7, 0]]})


def test_legacy_param_schema_upgrades_as_in_reference():
    j, t = jmx.sym.load_json(LEGACY_JSON), tmx.sym.load_json(LEGACY_JSON)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == [
        "bn1_moving_mean", "bn1_moving_var"]
    assert t.tojson() == j.tojson()
    assert t.infer_shape(data=(4, 100)) == j.infer_shape(data=(4, 100))


# ------------------------------------------------ the ResNet-50 builder
def _renumbered(js):
    """(op, name, inputs, attrs) per node, each op node's auto-numbered
    name renumbered by its order of appearance."""
    count, out = {}, []
    for n in json.loads(js)["nodes"]:
        name = n["name"]
        if n["op"] != "null":
            base = re.sub(r"\d+$", "", name)
            count[base] = count.get(base, -1) + 1
            name = f"{base}#{count[base]}"
        out.append((n["op"], name, n["inputs"], n.get("attrs")))
    return out


def test_builder_is_the_zoo_resnet50_v1_trace():
    """``chip_smoke.resnet50_v1_symbol`` against the JAX zoo's
    ``resnet50_v1()`` traced on ``sym.var("data")``: the same ops,
    attributes, inputs, order and names.  The trace's variables carry
    Gluon's parameter metadata (``__shape__`` with 0 for deferred dims,
    ``lr_mult``, ``wd_mult``, ``__dtype__``); the builder's carry none,
    so only the variables' names are compared."""
    trace = jmx.gluon.model_zoo.vision.resnet50_v1(prefix="resnetv10_")(
        jmx.sym.var("data"))
    want = json.loads(trace.tojson())
    for ns in (tmx.sym, jmx.sym):
        built = chip_smoke.resnet50_v1_symbol(ns, softmax=False)
        got = json.loads(built.tojson())
        assert got["heads"] == want["heads"]
        assert got["arg_nodes"] == want["arg_nodes"]
        assert _renumbered(built.tojson()) == _renumbered(trace.tojson())
    counts = {}
    for n in want["nodes"]:
        counts[n["op"]] = counts.get(n["op"], 0) + 1
    assert counts == {"null": 300, "Convolution": 53, "BatchNorm": 53,
                      "Activation": 49, "elemwise_add": 16, "Pooling": 2,
                      "FullyConnected": 1}


def test_builder_infers_the_same_shapes_in_both_packages():
    t = chip_smoke.resnet50_v1_symbol(tmx.sym)
    j = chip_smoke.resnet50_v1_symbol(jmx.sym)
    assert t.tojson() != "" and _renumbered(t.tojson()) == \
        _renumbered(j.tojson())
    ta, to, tx = t.infer_shape(data=(1, 3, 224, 224))
    ja, jo, jx = j.infer_shape(data=(1, 3, 224, 224))
    assert (ta, to, tx) == (ja, jo, jx)
    params = [n for n in t.list_arguments()
              if n not in ("data", "softmax_label")]
    # the trace's 194 arguments (data among them) and the label
    assert len(params) == 193 and len(t.list_arguments()) == 195 \
        and len(tx) == 106 and to == [(1, 1000)]


# ----------------------------------------------------------- executor
def _resnet_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _bind_traced(pkg, text, params, x, y, dtype=None):
    s = pkg.sym.load_json(text)
    head = pkg.sym.SoftmaxOutput(s, pkg.sym.var("softmax_label"),
                                 name="softmax")

    def arr(a):
        return pkg.nd.array(a, dtype=dtype) if dtype else pkg.nd.array(a)

    args = {n: arr(params[n]) for n in s.list_arguments() if n in params}
    args["data"] = arr(x)
    args["softmax_label"] = arr(y)
    grads = {n: pkg.nd.zeros(a.shape, dtype=dtype or "float32")
             for n, a in args.items()
             if n not in ("data", "softmax_label")}
    aux = {n: arr(params[n]) for n in head.list_auxiliary_states()}
    req = {n: ("write" if n in grads else "null")
           for n in head.list_arguments()}
    return head.bind(pkg.cpu(), args, args_grad=grads, grad_req=req,
                     aux_states=aux)


def held(got, ref, f64, what):
    """The port's fp32 value within ``NET_TOL`` of the reference's, or,
    where the fp32 sums are worse conditioned than that (BatchNorm over
    four samples at stage 4's 1x1 spatial size), no farther from the
    port's float64 evaluation than the reference's own value is."""
    err = _rel(got, ref)
    if err > NET_TOL:
        assert _rel(got, f64) <= _rel(ref, f64), (what, err)
    return err


def test_traced_resnet_executor_matches_reference(resnet18):
    """Outputs, every gradient and every moving statistic after one
    training forward/backward of the traced ResNet-18 (classes 10, 32²,
    batch 4), bound in both packages with the same arrays; each held by
    :func:`held` (measured: every gradient within 1.1e-4 of the
    reference's; the port within 5.9e-5 of the float64 run, the
    reference within 8.9e-5)."""
    net, jsym = resnet18
    params = _resnet_params(net)
    x = _f32(4, 3, 32, 32, seed=11)
    y = _labels(4, 10, seed=12)
    res = []
    for pkg, dtype in ((jmx, None), (tmx, None), (tmx, "float64")):
        ex = _bind_traced(pkg, jsym.tojson(), params, x, y, dtype)
        out = ex.forward(is_train=True)
        ex.backward()
        res.append((out[0].asnumpy(),
                    {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                    {n: a.asnumpy() for n, a in ex.aux_dict.items()}))
    (jo, jg, ja), (to, tg, ta), (fo, fg, fa) = res
    held(to, jo, fo, "output")
    n_args = len(jsym.list_arguments()) - 1  # all but the data
    assert sorted(tg) == sorted(jg) and len(tg) == n_args
    errs = [held(tg[n], jg[n], fg[n], n) for n in jg]
    assert sum(e <= NET_TOL for e in errs) >= 0.9 * len(errs)
    assert sorted(ta) == sorted(ja) == sorted(
        jsym.list_auxiliary_states())
    for n in ja:
        held(ta[n], ja[n], fa[n], n)
        assert not onp.array_equal(ta[n], params[n]), n


def test_bnreluconv_through_a_symbol_matches_reference():
    """``sym._contrib_BNReluConv(u, gamma, beta, weight)``, channel-last
    fp32, bound in both packages: its three outputs and the gradients of
    all four inputs (head gradient ones, the executors' default)."""
    feeds = dict(u=_f32(2, 5, 5, 8, seed=1),
                 gamma=onp.abs(_f32(8, seed=2)) + 0.5,
                 beta=_f32(8, seed=3), weight=_f32(16, 1, 1, 8, seed=4))
    res = []
    for pkg in (jmx, tmx):
        s = pkg.sym._contrib_BNReluConv(
            *[pkg.sym.var(n) for n in feeds], eps=1e-5, fix_gamma=False,
            name="brc")
        assert s.list_outputs() == ["brc_output0", "brc_output1",
                                    "brc_output2"]
        ex = s.simple_bind(pkg.cpu(), **{n: v.shape
                                         for n, v in feeds.items()})
        outs = ex.forward(is_train=True, **{n: pkg.nd.array(v)
                                            for n, v in feeds.items()})
        ex.backward()
        res.append(([o.asnumpy() for o in outs],
                    [ex.grad_dict[n].asnumpy() for n in feeds]))
    for t, j in zip(res[1][0] + res[1][1], res[0][0] + res[0][1]):
        assert _rel(t, j) <= NET_TOL


def test_library_ops_reach_the_symbol_namespace():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "mxnet_tpu_torch", "example", "plugin",
                        "cuda_ops.py")
    tmx.library.load(path)
    s = tmx.sym.plugin_scaled_add(tmx.sym.var("x"), tmx.sym.var("y"),
                                  scale=2.0)
    out = s.eval(tmx.cpu(), x=tmx.nd.ones((2, 2)), y=tmx.nd.ones((2, 2)))
    onp.testing.assert_array_equal(out[0].asnumpy(), onp.full((2, 2), 3.0))
