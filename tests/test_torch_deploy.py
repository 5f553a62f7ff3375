"""The port's deploy artifacts held against the JAX package on the CPU.

The frame is the reference's byte for byte: v1, v2 and headerless files
read the same in both packages, and the same corruption (truncated,
bit-flipped, torn body, bad metadata) raises ``MXNetError`` in both with
the same message.  Each package reads the other's v2 header
(``read_artifact_meta``, ``artifact_info``): every field is equal but
``platforms``.  The dense payload is the port's own (the net's symbol
graph and ``.params``; the reference's is StableHLO): its graph and
``.params`` are the reference's ``export`` bytes for the same weights,
``load_model`` equals the port net's forward bit for bit and the
reference net's to 1e-5 of the output's largest magnitude, a reference
artifact raises the port's clean error naming the path.  Generative
artifacts cross both ways with their arrays bit for bit.
"""
import json
import os
import struct
import zlib

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import deploy as jdeploy  # noqa: E402
from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
from mxnet_tpu.serving import toy_decoder_params as j_toy  # noqa: E402
from mxnet_tpu.symbol import symbol as j_sym  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import deploy as tdeploy  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.serving import toy_decoder_params  # noqa: E402
from mxnet_tpu_torch.symbol import symbol as t_sym  # noqa: E402

PREDICT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _host():
    """The port's default context is the card: these tests run on the
    host."""
    with tmx.cpu():
        yield


def _fresh_names():
    j_sym._UNNAMED_COUNT.clear()
    t_sym._UNNAMED_COUNT.clear()


def _mlp(pkg, prefix=None):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
                pkg.gluon.nn.Dense(5, in_units=16))
    return net


def _twins(name, tmp_path):
    """The port's net and the reference's with the port's weights (a
    two-layer MLP, or a ResNet-18 v1 at 32² after a recorded forward
    that moves its running statistics)."""
    onp.random.seed(0)
    if name == "mlp":
        tnet = _mlp(tmx)
        tnet.initialize(tmx.init.Xavier())
        jnet = _mlp(jmx, prefix=tnet.prefix)
    else:
        tnet = tmx.gluon.model_zoo.vision.get_model(name, classes=10)
        tnet.initialize(tmx.init.Xavier())
        with tmx.autograd.record():
            tnet(tmx.nd.array(_x(name, 4, seed=9)))
        jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=10,
                                                    prefix=tnet.prefix)
    f = str(tmp_path / "w.params")
    tnet.save_parameters(f)
    jnet.initialize()
    jnet.load_parameters(f)
    return tnet, jnet


def _x(name, batch, seed=1):
    rng = onp.random.RandomState(seed)
    if name == "mlp":
        return rng.rand(batch, 8).astype("float32")
    return rng.rand(batch, 3, 32, 32).astype("float32")


# ------------------------------------------------------------ the frame
def _frame(version, payload, meta=None):
    if version == "v2":
        m = json.dumps(meta, sort_keys=True).encode()
        return jdeploy._MAGIC2 + jdeploy._HEADER2.pack(
            zlib.crc32(m + payload) & 0xFFFFFFFF, len(payload), len(m)) \
            + m + payload
    if version == "v1":
        return jdeploy._MAGIC + jdeploy._HEADER.pack(
            zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload
    return payload


def test_frame_constants_are_the_reference_bytes():
    assert (tdeploy._MAGIC, tdeploy._MAGIC2) == (jdeploy._MAGIC,
                                                 jdeploy._MAGIC2)
    assert tdeploy._HEADER.format == jdeploy._HEADER.format
    assert tdeploy._HEADER2.format == jdeploy._HEADER2.format


@pytest.mark.parametrize("version", ["v1", "v2", "headerless"])
def test_frames_read_the_same_in_both_packages(version, tmp_path):
    payload = bytes(range(256)) * 3
    meta = {"batch": 4, "item_shape": [3], "dtype": "float32"}
    p = str(tmp_path / "a.mxje")
    with open(p, "wb") as f:
        f.write(_frame(version, payload, meta))
    got_t = tdeploy._read_meta_payload(p)
    got_j = jdeploy._read_meta_payload(p)
    assert got_t == got_j
    assert got_t[1] == payload
    assert got_t[0] == (meta if version == "v2" else None)
    assert tdeploy.read_artifact_meta(p) == jdeploy.read_artifact_meta(p)


def _corrupt(kind, data):
    if kind == "truncated_header":
        return data[:len(jdeploy._MAGIC2) + 3]
    if kind == "torn_body":
        return data[:-7]
    if kind == "bit_flip":
        b = bytearray(data)
        b[-5] ^= 0x10
        return bytes(b)
    raise AssertionError(kind)


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["truncated_header", "torn_body",
                                  "bit_flip"])
def test_corruption_raises_the_same_error_in_both(version, kind, tmp_path):
    p = str(tmp_path / "bad.mxje")
    with open(p, "wb") as f:
        f.write(_corrupt(kind, _frame(version, b"x" * 200, {"batch": 1})))
    with pytest.raises(MXNetError) as te:
        tdeploy._read_meta_payload(p)
    with pytest.raises(JMXNetError) as je:
        jdeploy._read_meta_payload(p)
    assert str(te.value) == str(je.value)
    assert p in str(te.value)
    with pytest.raises(MXNetError, match="corrupt deploy artifact"):
        tdeploy.load_model(p)


def test_unparseable_metadata_raises_the_same_error(tmp_path):
    m, payload = b"{not json", b"y" * 50
    p = str(tmp_path / "meta.mxje")
    with open(p, "wb") as f:
        f.write(jdeploy._MAGIC2 + jdeploy._HEADER2.pack(
            zlib.crc32(m + payload) & 0xFFFFFFFF, len(payload), len(m))
            + m + payload)
    with pytest.raises(MXNetError) as te:
        tdeploy.load_exported(p)
    with pytest.raises(JMXNetError) as je:
        jdeploy.load_exported(p)
    assert str(te.value) == str(je.value)
    assert "unparseable metadata" in str(te.value)
    assert tdeploy.read_artifact_meta(p) is None is \
        jdeploy.read_artifact_meta(p)


def test_missing_file_raises_naming_the_path(tmp_path):
    p = str(tmp_path / "nope.mxje")
    with pytest.raises(MXNetError) as te:
        tdeploy.load_model(p)
    with pytest.raises(JMXNetError) as je:
        jdeploy.load_model(p)
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0]
    assert p in str(te.value)


# -------------------------------------------------------- dense exports
def _export_both(tmp_path, name, batch=4, extra_meta=None):
    tnet, jnet = _twins(name, tmp_path)
    x = _x(name, batch, seed=2)
    tp, jp = str(tmp_path / "t.mxje"), str(tmp_path / "j.mxje")
    _fresh_names()
    tdeploy.export_model(tnet, tmx.nd.array(x), tp, extra_meta=extra_meta)
    jdeploy.export_model(jnet, jmx.nd.array(x), jp, platforms=("cpu",),
                         extra_meta=extra_meta)
    return tnet, jnet, tp, jp, x


def test_headers_cross_both_ways(tmp_path):
    """Each package reads the other's v2 header; every field is equal
    but ``platforms`` (the port's ``cpu``/``cuda``)."""
    _, _, tp, jp, _ = _export_both(tmp_path, "mlp")
    for read in (tdeploy.read_artifact_meta, jdeploy.read_artifact_meta):
        tm, jm = read(tp), read(jp)
        assert tm.pop("platforms") == ["cpu", "cuda"]
        assert jm.pop("platforms") == ["cpu"]
        assert tm == jm
    for info in (tdeploy.artifact_info, jdeploy.artifact_info):
        ti, ji = info(tp), info(jp)
        assert ti.pop("platforms") == ("cpu", "cuda")
        ji.pop("platforms")
        assert ti == ji


def test_extra_meta_cannot_override_reserved_keys(tmp_path):
    extra = {"batch": 999, "dtype": "int8", "quantized": True,
             "model_version": 7, "stream_cursor": 1234}
    _, _, tp, jp, _ = _export_both(tmp_path, "mlp", extra_meta=extra)
    tm, jm = tdeploy.read_artifact_meta(tp), jdeploy.read_artifact_meta(jp)
    tm.pop("platforms")
    jm.pop("platforms")
    assert tm == jm
    assert (tm["batch"], tm["dtype"], tm["quantized"]) == (4, "float32",
                                                           False)
    assert (tm["model_version"], tm["stream_cursor"]) == (7, 1234)


@pytest.mark.parametrize("name", ["mlp", "resnet18_v1"])
def test_payload_is_the_reference_export_bytes(name, tmp_path):
    """The port's dense payload is the graph and ``.params`` the
    reference's ``HybridBlock.export`` writes for the same weights."""
    tnet, jnet, tp, _, _ = _export_both(tmp_path, name)
    _fresh_names()
    jnet.export(str(tmp_path / "ref"))
    _, blob = tdeploy._read_meta_payload(tp)
    assert blob.startswith(tdeploy._SYMBOL_MAGIC)
    n_graph, n_params = struct.unpack_from(
        "<QQ", blob, len(tdeploy._SYMBOL_MAGIC))
    off = len(tdeploy._SYMBOL_MAGIC) + 16
    graph, params = blob[off:off + n_graph], blob[off + n_graph:]
    assert len(params) == n_params
    assert graph == open(tmp_path / "ref-symbol.json", "rb").read()
    assert params == open(tmp_path / "ref-0000.params", "rb").read()


@pytest.mark.parametrize("name", ["mlp", "resnet18_v1"])
def test_load_model_predicts_as_both_nets(name, tmp_path):
    """``export_model`` → ``load_model`` on the host: the port net's
    forward bit for bit, the reference net's (weights through
    ``.params``) and the reference artifact's to 1e-5."""
    tnet, jnet, tp, jp, x = _export_both(tmp_path, name)
    got = tdeploy.load_model(tp)(x).asnumpy()
    assert onp.array_equal(got, tnet(tmx.nd.array(x)).asnumpy())
    for want in (jnet(jmx.nd.array(x)).asnumpy(),
                 jdeploy.load_model(jp)(x).asnumpy()):
        scale = float(onp.abs(want).max())
        assert float(onp.abs(got - want).max()) <= PREDICT_TOL * scale
    exp = tdeploy.load_exported(tp)
    assert exp.in_avals[0].shape == x.shape
    assert exp.out_avals[0].shape == got.shape
    assert exp.platforms == ("cpu", "cuda")
    assert str(exp.device) == "cpu"


def test_reference_artifact_raises_the_ports_clean_error(tmp_path):
    _, _, tp, jp, _ = _export_both(tmp_path, "mlp")
    for load in (tdeploy.load_exported, tdeploy.load_model):
        with pytest.raises(MXNetError) as e:
            load(jp)
        assert jp in str(e.value)
        assert "StableHLO" in str(e.value)
    # a headerless copy of the reference's payload: the same verdict
    raw = str(tmp_path / "raw.mxje")
    with open(raw, "wb") as f:
        f.write(jdeploy._read_meta_payload(jp)[1])
    with pytest.raises(MXNetError, match="StableHLO"):
        tdeploy.artifact_info(raw)
    # and the reference refuses the port's payload with its own error
    with pytest.raises(JMXNetError, match="failed to deserialize"):
        jdeploy.load_exported(tp)


def test_stablehlo_text_raises_naming_the_payload():
    net = _mlp(tmx)
    net.initialize()
    with pytest.raises(MXNetError, match="symbol graph"):
        tdeploy.stablehlo_text(net, onp.zeros((2, 8), "float32"))


def test_export_needs_a_hybrid_block(tmp_path):
    class Plain(tmx.gluon.Block):
        def forward(self, x):
            return x

    with pytest.raises(MXNetError, match="HybridBlock"):
        tdeploy.export_model(Plain(), onp.zeros((1, 2), "float32"),
                             str(tmp_path / "p.mxje"))


def test_export_is_atomic_and_resolves_deferred_widths(tmp_path):
    net = tmx.gluon.nn.Dense(3)  # in_units deferred
    net.initialize()
    p = str(tmp_path / "d" / "deferred.mxje")
    tdeploy.export_model(net, onp.ones((2, 6), "float32"), p)
    assert os.listdir(tmp_path / "d") == ["deferred.mxje"]
    assert tdeploy.artifact_info(p)["item_shape"] == (6,)


# ----------------------------------------------------- generative files
def _gen_cfg():
    return dict(vocab=32, layers=2, heads=2, head_dim=8,
                prompt_buckets=(4, 8, 16), max_new=5)


def _equal_trees(a, b):
    fa, fb = tdeploy._flatten_params(a), tdeploy._flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype
        assert onp.array_equal(fa[k], fb[k]), k


def test_generative_artifacts_cross_both_ways(tmp_path):
    cfg = _gen_cfg()
    tparams = toy_decoder_params(seed=0, device="cpu")
    jparams = jax.tree.map(onp.asarray, j_toy(seed=0))
    tp, jp = str(tmp_path / "tg.mxje"), str(tmp_path / "jg.mxje")
    tdeploy.export_generative(tparams, tp, extra_meta={"model_version": 3},
                              **cfg)
    jdeploy.export_generative(jparams, jp, extra_meta={"model_version": 3},
                              **cfg)
    for path, params in ((tp, tparams), (jp, jparams)):
        got_t, gen_t = tdeploy.load_generative(path)
        got_j, gen_j = jdeploy.load_generative(path)
        assert gen_t == gen_j
        _equal_trees(got_t, params)
        _equal_trees(got_j, params)
    tm, jm = tdeploy.read_artifact_meta(tp), jdeploy.read_artifact_meta(jp)
    assert tm.pop("platforms") == ["cpu", "cuda"]
    jm.pop("platforms")
    assert tm == jm
    assert tdeploy._flatten_params(tparams).keys() == \
        jdeploy._flatten_params(jparams).keys()


def test_artifact_classes_refuse_each_others_loader(tmp_path):
    tnet = _mlp(tmx)
    tnet.initialize()
    dense, gen = str(tmp_path / "d.mxje"), str(tmp_path / "g.mxje")
    tdeploy.export_model(tnet, onp.zeros((2, 8), "float32"), dense)
    tdeploy.export_generative(toy_decoder_params(seed=1, device="cpu"), gen,
                              **_gen_cfg())
    with pytest.raises(MXNetError) as te:
        tdeploy.load_generative(dense)
    with pytest.raises(JMXNetError) as je:
        jdeploy.load_generative(dense)
    assert str(te.value) == str(je.value)
    with pytest.raises(MXNetError) as te:
        tdeploy.load_exported(gen)
    with pytest.raises(JMXNetError) as je:
        jdeploy.load_exported(gen)
    assert str(te.value) == str(je.value)
