"""The port's symbolic trace, ``HybridBlock.export`` and ``SymbolBlock``
held against the JAX package on the CPU.

For one net of each classification family (classes 10) the port's
weights, after a forward that resolves its deferred widths, are loaded
into the reference's net; then both export.  The files are compared
byte for byte, with the graph's auto-names started afresh in both
packages before each export.  Files cross both ways: each package's
``SymbolBlock.imports`` reads the other's and predicts as the exporting
net does, to 1e-5 of the output's largest magnitude; ``Module.load``
reads the port's.  The reference's ``SymbolBlock`` is not taped (its
backward raises), so the port's SymbolBlock gradients are held against
the port's Gluon net (bit for bit) and the reference's Gluon net that
was exported (1e-4 of each tensor's largest magnitude).  ``ParameterDict.save``/``load``,
``list_ctx``, ``list_grad`` and ``reset_ctx`` are held to the
reference's bytes and results.
"""
import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autograd as j_ag  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
from mxnet_tpu.symbol import symbol as j_sym  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as t_ag  # noqa: E402
from mxnet_tpu_torch import gluon as t_gluon  # noqa: E402
from mxnet_tpu_torch.symbol import symbol as t_sym  # noqa: E402

PREDICT_TOL = 1e-5
GRAD_TOL = 1e-4
#: one net of each family, at the smallest image it takes
FAMILIES = {"resnet18_v1": 32, "resnet18_v2": 32, "vgg11": 32,
            "alexnet": 224, "squeezenet1.1": 64, "densenet121": 224,
            "inceptionv3": 299, "mobilenet0.25": 32, "lenet": 28}


@pytest.fixture(autouse=True)
def _host():
    """The port's default context is the card: these tests run on the
    host."""
    with tmx.cpu():
        yield


def _fresh_names():
    """Start both packages' graph auto-names (``convolution0``, ...)
    afresh."""
    j_sym._UNNAMED_COUNT.clear()
    t_sym._UNNAMED_COUNT.clear()


def _image(name, batch=1, seed=1):
    side = FAMILIES[name]
    ch = 1 if name == "lenet" else 3
    return onp.random.RandomState(seed).rand(batch, ch, side, side).astype(
        "float32")


def _twins(name, tmp_path, x):
    """The port's net (a forward resolves its deferred widths; a
    recorded one moves its running statistics) and the reference's
    with the port's weights."""
    onp.random.seed(0)
    tnet = tmx.gluon.model_zoo.vision.get_model(name, classes=10)
    tnet.initialize(tmx.init.Xavier())
    with t_ag.record():
        tnet(tmx.nd.array(x))
    f = str(tmp_path / "w.params")
    tnet.save_parameters(f)
    jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=10,
                                                prefix=tnet.prefix)
    jnet.initialize()
    jnet.load_parameters(f)
    return tnet, jnet


def _files(prefix):
    return [open(f"{prefix}{s}", "rb").read()
            for s in ("-symbol.json", "-0000.params")]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_export_writes_the_reference_bytes(name, tmp_path):
    tnet, jnet = _twins(name, tmp_path, _image(name))
    _fresh_names()
    tout = tnet.export(str(tmp_path / "t"))
    _fresh_names()
    jout = jnet.export(str(tmp_path / "j"))
    assert tout.list_auxiliary_states() == jout.list_auxiliary_states()
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def _exported(tmp_path, x):
    tnet, jnet = _twins("resnet18_v1", tmp_path, x)
    _fresh_names()
    tnet.export(str(tmp_path / "t"))
    _fresh_names()
    jnet.export(str(tmp_path / "j"))
    return tnet, jnet


def _close(got, want, tol=PREDICT_TOL):
    scale = float(onp.abs(want).max())
    assert float(onp.abs(got - want).max()) <= tol * scale


def test_symbolblock_reads_both_packages_files(tmp_path):
    """Each package's ``SymbolBlock.imports`` reads the other's files and
    predicts as the reference's SymbolBlock and as the exporting net."""
    x = _image("resnet18_v1", batch=2, seed=3)
    tnet, jnet = _exported(tmp_path, x)
    want = jnet(jmx.nd.array(x)).asnumpy()
    _close(tnet(tmx.nd.array(x)).asnumpy(), want)
    for src in ("t", "j"):
        files = (str(tmp_path / f"{src}-symbol.json"), ["data"],
                 str(tmp_path / f"{src}-0000.params"))
        jsb = j_gluon.SymbolBlock.imports(*files)
        tsb = t_gluon.SymbolBlock.imports(*files, ctx=tmx.cpu())
        ref = jsb(jmx.nd.array(x)).asnumpy()
        _close(ref, want)
        _close(tsb(tmx.nd.array(x)).asnumpy(), ref)
        assert list(tsb.collect_params()) == list(jsb.collect_params())
        assert [p.grad_req for p in tsb.collect_params().values()] == \
            [p.grad_req for p in jsb.collect_params().values()]


def test_module_load_predicts_as_the_net(tmp_path):
    """``Module.load`` of the port's exported files, bound to predict,
    gives the Gluon net's outputs."""
    x = _image("resnet18_v1", batch=2, seed=4)
    tnet, _ = _exported(tmp_path, x)
    mod = tmx.mod.Module.load(str(tmp_path / "t"), 0, label_names=None,
                              context=tmx.cpu())
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.forward(tmx.io.DataBatch([tmx.nd.array(x)]), is_train=False)
    _close(mod.get_outputs()[0].asnumpy(), tnet(tmx.nd.array(x)).asnumpy())


def test_symbolblock_gradients_equal_the_reference_net(tmp_path):
    """Inside ``autograd.record()`` the port's SymbolBlock is taped and
    trains (batch statistics) as the port's layers do: its gradients
    equal the port's Gluon net's bit for bit, and the reference Gluon
    net's to 1e-4 of each tensor's largest magnitude (the ResNet
    gradients' bound of ``tests/test_torch_gluon_trainer.py``, batch 8 as
    ``tests/test_torch_resnet_nchw.py`` steps its ResNets).  The
    reference's SymbolBlock is not taped: its backward raises (ROADMAP
    §C)."""
    x = _image("resnet18_v1", batch=8, seed=5)
    head = onp.random.RandomState(9).randn(8, 10).astype("float32")
    tnet, jnet = _exported(tmp_path, x)
    files = (str(tmp_path / "j-symbol.json"), ["data"],
             str(tmp_path / "j-0000.params"))
    tsb = t_gluon.SymbolBlock.imports(*files, ctx=tmx.cpu())
    grads = {}
    for key, net, mx in (("symbolblock", tsb, tmx), ("port", tnet, tmx),
                         ("reference", jnet, jmx)):
        with mx.autograd.record():
            loss = (net(mx.nd.array(x)) * mx.nd.array(head)).sum()
        loss.backward()
        grads[key] = {n: p.grad().asnumpy() for n, p in
                      net.collect_params().items() if p.grad_req != "null"}
    want = grads["reference"]
    assert sorted(grads["symbolblock"]) == sorted(want)
    for n in want:
        onp.testing.assert_array_equal(grads["symbolblock"][n],
                                       grads["port"][n])
        err = onp.abs(grads["symbolblock"][n] - want[n]).max()
        assert err <= GRAD_TOL * max(onp.abs(want[n]).max(), 1e-30), n
    jsb = j_gluon.SymbolBlock.imports(*files)
    with j_ag.record():
        jy = jsb(jmx.nd.array(x))
    with pytest.raises(JMXNetError):
        jy.backward()


def test_mobilenet_v2_exports_where_the_reference_cannot(tmp_path):
    """The reference's MobileNetV2 cannot be traced (its RELU6 passes
    clip's bounds positionally, ROADMAP §C); the port's names them, and
    its exported graph predicts as the net."""
    with pytest.raises(TypeError):
        net = jmx.gluon.model_zoo.vision.get_model("mobilenetv2_0.25",
                                                   classes=10)
        net(jmx.sym.var("data"))
    onp.random.seed(0)
    net = tmx.gluon.model_zoo.vision.get_model("mobilenetv2_0.25",
                                               classes=10)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_image("mobilenet0.25", batch=2))
    with t_ag.record():
        net(x)
    net.export(str(tmp_path / "m"))
    sb = t_gluon.SymbolBlock.imports(str(tmp_path / "m-symbol.json"),
                                     "data", str(tmp_path / "m-0000.params"),
                                     ctx=tmx.cpu())
    _close(sb(x).asnumpy(), net(x).asnumpy())


def test_dense_without_bias_traces(tmp_path):
    """``Dense(use_bias=False)`` traces to ``FullyConnected(x, weight,
    no_bias=True)``; the reference passes ``None`` as the bias and
    cannot trace it (ROADMAP §C)."""
    with pytest.raises(TypeError):
        jd = jmx.gluon.nn.Dense(3, in_units=4, use_bias=False, prefix="d_")
        jd(jmx.sym.var("data"))
    td = tmx.gluon.nn.Dense(3, in_units=4, use_bias=False, prefix="d_")
    graph = td(tmx.sym.var("data"))
    assert graph.list_arguments() == ["data", "d_weight"]
    td.initialize()
    x = tmx.nd.array(onp.ones((2, 4), "float32"))
    sb = t_gluon.SymbolBlock(graph, tmx.sym.var("data"))
    sb.collect_params()["d_weight"].initialize()
    sb.collect_params()["d_weight"].set_data(td.collect_params()[
        "d_weight"].data())
    onp.testing.assert_array_equal(sb(x).asnumpy(), td(x).asnumpy())


def test_parameter_dict_files_and_contexts(tmp_path):
    """``ParameterDict.save`` (with ``strip_prefix``) writes the
    reference's bytes; ``load`` (with ``restore_prefix``) reads them
    back; ``list_ctx``, ``list_grad`` and ``reset_ctx`` give the
    reference's results."""
    onp.random.seed(0)
    tnet = tmx.gluon.nn.Dense(3, in_units=4, prefix="fc_")
    tnet.initialize()
    f = str(tmp_path / "t.params")
    tnet.save_parameters(str(tmp_path / "w.params"))
    jnet = jmx.gluon.nn.Dense(3, in_units=4, prefix="fc_")
    jnet.initialize()
    jnet.load_parameters(str(tmp_path / "w.params"))
    tnet.collect_params().save(f, strip_prefix="fc_")
    jnet.collect_params().save(str(tmp_path / "j.params"),
                               strip_prefix="fc_")
    assert open(f, "rb").read() == open(tmp_path / "j.params", "rb").read()
    with pytest.raises(tmx.base.MXNetError):
        tnet.collect_params().save(f, strip_prefix="other_")
    back = tmx.gluon.nn.Dense(3, in_units=4, prefix="fc_")
    back.collect_params().load(f, ctx=tmx.cpu(), restore_prefix="fc_")
    for n, p in tnet.collect_params().items():
        onp.testing.assert_array_equal(back.collect_params()[n].data()
                                       .asnumpy(), p.data().asnumpy())
    with pytest.raises(tmx.base.MXNetError):
        tmx.gluon.nn.Dense(3, in_units=4, prefix="fc_").collect_params() \
            .load(f, ctx=tmx.cpu())  # the names lack the prefix
    for net, mx in ((tnet, tmx), (jnet, jmx)):
        w = net.collect_params()["fc_weight"]
        assert w.list_ctx() == [mx.cpu()]
        with mx.autograd.record():
            y = net(mx.nd.ones((2, 4)))
        y.backward()
        (g,) = w.list_grad()
        onp.testing.assert_array_equal(g.asnumpy(), onp.full((3, 4), 2.0))
        before = w.data().asnumpy()
        net.collect_params().reset_ctx(mx.cpu())
        onp.testing.assert_array_equal(w.data().asnumpy(), before)
        assert w.list_ctx() == [mx.cpu()]
    deferred = tmx.gluon.nn.Dense(3, prefix="dd_")
    deferred.initialize(ctx=tmx.cpu())
    assert deferred.collect_params()["dd_weight"].list_ctx() == [tmx.cpu()]
