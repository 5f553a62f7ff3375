"""The port's Module API (``mx.mod.Module``, ``BucketingModule``,
``SequentialModule``), ``mx.model`` checkpoints, ``mx.callback`` and
``mx.monitor`` held against the JAX package on the CPU.

Every batch is numpy from a seed; the port runs inside ``with
mx.cpu():`` (its default context is the card, which this host lacks).
Weights cross from the reference with ``set_params``; the two
packages' random streams are never compared.

Tolerances: the MLP's ``fit`` trajectory (per-batch metric, final
parameters, score, predictions) to 1e-5; the traced ResNet-18's three
Module steps (losses, parameters, momenta, moving statistics) to 1e-4
of each tensor's largest magnitude; checkpoint files byte for byte.
"""
import json
import logging
import os

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.io import DataBatch as JBatch, DataDesc as JDesc  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.io import DataBatch as TBatch, DataDesc as TDesc  # noqa: E402

FIT_TOL = 1e-5
NET_TOL = 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _mlp(sym, num_hidden=16, classes=4):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def _mlp_data(seed=7, n=256, classes=4):
    rng = onp.random.RandomState(seed)
    w = rng.randn(10, classes).astype("float32")
    x = rng.randn(n, 10).astype("float32")
    return x, (x @ w).argmax(axis=1).astype("float32")


def _mlp_params(seed=11):
    rng = onp.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 10) * 0.3, "fc1_bias":
            rng.randn(16) * 0.1, "fc2_weight": rng.randn(4, 16) * 0.3,
            "fc2_bias": rng.randn(4) * 0.1}


def _arrays(pkg, d):
    return {k: pkg.nd.array(onp.asarray(v, "float32")) for k, v in d.items()}


# ----------------------------------------------------------------- fit
def _fit(pkg, tmp_path, tag):
    x, y = _mlp_data()
    xv, yv = _mlp_data(seed=8, n=50)
    onp.random.seed(3)  # the iterator's shuffles
    train = pkg.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    val = pkg.io.NDArrayIter(xv, yv, batch_size=16)  # pads 14
    mod = pkg.mod.Module(_mlp(pkg.sym), context=pkg.cpu())
    trace, epochs = [], []

    def on_batch(p):
        trace.append(p.eval_metric.get()[1])

    prefix = str(tmp_path / tag)
    mod.fit(train, eval_data=val, eval_metric="acc", num_epoch=3,
            optimizer="sgd", optimizer_params=(("learning_rate", 0.2),
                                               ("momentum", 0.9),
                                               ("wd", 1e-3)),
            arg_params=_arrays(pkg, _mlp_params()), aux_params={},
            batch_end_callback=[on_batch,
                                pkg.callback.Speedometer(32, 4),
                                pkg.callback.log_train_metric(4)],
            epoch_end_callback=[lambda e, s, a, x_: epochs.append(e),
                                pkg.callback.do_checkpoint(prefix, 2)],
            eval_end_callback=pkg.callback.LogValidationMetricsCallback())
    score = mod.score(val, pkg.metric.create("acc"))
    pred = mod.predict(val)
    arg, aux = mod.get_params()
    return trace, epochs, score, pred.asnumpy(), _np(arg), prefix


def test_fit_score_predict_match_reference(tmp_path):
    j = _fit(jmx, tmp_path, "j")
    t = _fit(tmx, tmp_path, "t")
    assert len(t[0]) == len(j[0]) == 24
    onp.testing.assert_allclose(t[0], j[0], atol=FIT_TOL)
    assert t[1] == j[1] == [0, 1, 2]
    assert t[2][0][0] == j[2][0][0] == "accuracy"
    assert abs(t[2][0][1] - j[2][0][1]) <= FIT_TOL
    assert t[3].shape == j[3].shape == (50, 4)  # the pad cut off
    onp.testing.assert_allclose(t[3], j[3], atol=FIT_TOL)
    for n in j[4]:
        assert _rel(t[4][n], j[4][n]) <= FIT_TOL, n
    # do_checkpoint(period 2) after the second epoch, in both
    for tag in ("j", "t"):
        assert sorted(os.listdir(tmp_path))
        assert os.path.exists(str(tmp_path / f"{tag}-0002.params"))
        assert not os.path.exists(str(tmp_path / f"{tag}-0001.params"))


def test_iter_predict_and_unmerged_predict():
    x, y = _mlp_data(n=40)
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    mod = tmx.mod.Module(_mlp(tmx.sym))
    mod.bind(it.provide_data, it.provide_label, for_training=False)
    mod.set_params(_arrays(tmx, _mlp_params()), {})
    parts = list(mod.iter_predict(it))
    assert [p[1] for p in parts] == [0, 1, 2]
    assert [p[0][0].shape[0] for p in parts] == [16, 16, 8]
    merged = mod.predict(it).asnumpy()
    onp.testing.assert_array_equal(
        merged, onp.concatenate([p[0][0].asnumpy() for p in parts]))
    unmerged = mod.predict(it, merge_batches=False)
    assert len(unmerged) == 3 and len(unmerged[0]) == 1


# --------------------------------------------------------- checkpoints
def _ckpt_arrays(pkg):
    rng = onp.random.RandomState(5)
    arg = {"fc1_weight": rng.randn(16, 10), "fc1_bias": rng.randn(16),
           "fc2_weight": rng.randn(4, 16), "fc2_bias": rng.randn(4)}
    aux = {"bn_moving_mean": rng.randn(3)}
    return _arrays(pkg, arg), _arrays(pkg, aux)


def test_save_checkpoint_writes_the_reference_bytes(tmp_path, monkeypatch):
    # one autotune winners file for both packages: the manifest records
    # its SHA-256
    at = tmp_path / "autotune"
    at.mkdir()
    (at / "autotune.json").write_text('{"winners": {}}')
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(at))
    files = {}
    for pkg, tag in ((jmx, "j"), (tmx, "t")):
        arg, aux = _ckpt_arrays(pkg)
        prefix = str(tmp_path / tag)
        onp.random.seed(11)  # the host RNG state each manifest records
        pkg.model.save_checkpoint(prefix, 7, _mlp(pkg.sym), arg, aux)
        files[tag] = {s: open(f"{prefix}{s}", "rb").read() for s in (
            "-0007.params", "-symbol.json", "-0007.manifest.json",
            "-latest.json")}
    for suffix in ("-0007.params", "-symbol.json"):
        assert files["t"][suffix] == files["j"][suffix], suffix
    jm = json.loads(files["j"]["-0007.manifest.json"])
    tm = json.loads(files["t"]["-0007.manifest.json"])
    assert sorted(tm) == sorted(jm)
    assert tm["files"] == {k.replace("j-", "t-"): v
                           for k, v in jm["files"].items()}
    # numpy's state is the reference's byte for byte; the device part is
    # each package's own (a JAX key there, torch generators here)
    assert tm["rng"]["numpy"] == jm["rng"]["numpy"]
    assert sorted(tm["rng"]) == sorted(jm["rng"]) == ["device", "numpy"]
    assert tm["autotune_sha256"] == jm["autotune_sha256"] is not None
    assert json.loads(files["t"]["-latest.json"]) == {
        "epoch": 7, "manifest": "t-0007.manifest.json"}
    # each package loads the other's checkpoint
    for loader, other in ((tmx, "j"), (jmx, "t")):
        sym, arg, aux = loader.model.load_checkpoint(str(tmp_path / other),
                                                     7)
        want_arg, want_aux = _ckpt_arrays(jmx)
        assert sym.tojson() == _mlp(jmx.sym).tojson()
        for got, want in ((arg, want_arg), (aux, want_aux)):
            assert sorted(got) == sorted(want)
            for n in want:
                onp.testing.assert_array_equal(got[n].asnumpy(),
                                               want[n].asnumpy())


def test_checkpoint_manager_verifies_falls_back_and_retains(tmp_path):
    from mxnet_tpu.resilience.checkpoint import CheckpointManager as JCM
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager as TCM

    seen = {}
    for cm, pkg, tag in ((JCM, jmx, "j"), (TCM, tmx, "t")):
        arg, aux = _ckpt_arrays(pkg)
        mgr = cm(str(tmp_path / tag), keep_n=2)
        for v in (1, 2, 3):
            mgr.save(v, symbol=_mlp(pkg.sym), arg_params=arg,
                     aux_params=aux, optimizer_states=b"states",
                     batch_cursor=v)
        eps = mgr.epochs()
        # truncate the newest payload: load() falls back to version 2
        p = mgr.params_path(3)
        with open(p, "r+b") as f:
            f.truncate(100)
        state = mgr.load()
        with pytest.raises(Exception, match="verification"):
            mgr.load_params_dict(3)
        seen[tag] = (eps, mgr.verify(3), mgr.verify(2), mgr.latest_epoch(),
                     state["version"], state["batch_cursor"],
                     state["optimizer_states"], sorted(state["arg_params"]),
                     mgr.allocate_version())
    assert seen["t"] == seen["j"] == ([2, 3], False, True, 2, 2, 2,
                                      b"states", sorted(_mlp_params()), 4)


def test_module_checkpoint_with_optimizer_states_resumes(tmp_path):
    x, y = _mlp_data(n=64)
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    mod = tmx.mod.Module(_mlp(tmx.sym))
    mod.bind(it.provide_data, it.provide_label)
    mod.set_params(_arrays(tmx, _mlp_params()), {})
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),
                                         ("momentum", 0.9)))
    batches = list(it)
    for b in batches[:2]:
        mod.forward_backward(b)
        mod.update()
    prefix = str(tmp_path / "m")
    tmx.callback.module_checkpoint(mod, prefix, save_optimizer_states=True)(
        0)
    mod2 = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True)
    mod2.bind(it.provide_data, it.provide_label)
    mod2.init_optimizer(optimizer_params=(("learning_rate", 0.1),
                                          ("momentum", 0.9)))
    for b in batches[2:]:
        for m in (mod, mod2):
            m.forward_backward(b)
            m.update()
    for n, v in mod.get_params()[0].items():
        onp.testing.assert_array_equal(mod2.get_params()[0][n].asnumpy(),
                                       v.asnumpy())


# ------------------------------------------------- bucketing, sequential
def _bucket_sym_gen(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        flat = pkg.sym.Reshape(data, shape=(-1, seq_len * 4), name="flat")
        fc = pkg.sym.FullyConnected(flat, num_hidden=8, name="fc_shared")
        out = pkg.sym.SoftmaxOutput(fc, pkg.sym.Variable("softmax_label"),
                                    name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _bucketing(pkg, batch_cls, desc_cls):
    mod = pkg.mod.BucketingModule(_bucket_sym_gen(pkg), default_bucket_key=6,
                                  context=pkg.cpu())
    rng = onp.random.RandomState(9)

    def batch(key):
        x = rng.randn(4, key, 4).astype("float32")
        y = rng.randint(0, 8, 4).astype("float32")
        return batch_cls(
            data=[pkg.nd.array(x)], label=[pkg.nd.array(y)], bucket_key=key,
            provide_data=[desc_cls("data", (4, key, 4))],
            provide_label=[desc_cls("softmax_label", (4,))])

    b = batch(6)
    mod.bind(data_shapes=b.provide_data, label_shapes=b.provide_label)
    w = onp.random.RandomState(1).randn(8, 24).astype("float32") * 0.2
    mod.set_params({"fc_shared_weight": pkg.nd.array(w),
                    "fc_shared_bias": pkg.nd.zeros((8,))}, {})
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.3),))
    outs = []
    for key in (6, 6, 6):  # a second bucket of the same weight shape
        bb = batch(key)
        mod.forward(bb)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.backward()
        mod.update()
    # switch to a bucket whose graph differs (another reshape) but whose
    # weights are the same arrays
    mod.switch_bucket(3, [desc_cls("data", (8, 3, 4))],
                      [desc_cls("softmax_label", (8,))])
    shared = mod._buckets[3]._exec.arg_dict["fc_shared_weight"] is \
        mod._buckets[6]._exec.arg_dict["fc_shared_weight"]
    return outs, _np(mod.get_params()[0]), shared


def test_bucketing_module_matches_reference():
    jo, jp, js = _bucketing(jmx, JBatch, JDesc)
    to, tp, ts = _bucketing(tmx, TBatch, TDesc)
    assert js and ts
    for t, j in zip(to, jo):
        onp.testing.assert_allclose(t, j, atol=FIT_TOL)
    for n in jp:
        assert _rel(tp[n], jp[n]) <= FIT_TOL, n


def _sequential(pkg, batch_cls):
    s1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        pkg.sym.var("data"), num_hidden=12, name="fc1"), act_type="tanh",
        name="act1")
    s2 = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.var("data"), num_hidden=4, name="fc2"),
        pkg.sym.var("softmax_label"), name="softmax")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(s1, label_names=None, context=pkg.cpu()))
    seq.add(pkg.mod.Module(s2, context=pkg.cpu()), take_labels=True)
    seq.bind([("data", (8, 10))], [("softmax_label", (8,))])
    rng = onp.random.RandomState(4)
    seq.set_params(_arrays(pkg, {
        "fc1_weight": rng.randn(12, 10) * 0.3, "fc1_bias": rng.randn(12),
        "fc2_weight": rng.randn(4, 12) * 0.3, "fc2_bias": rng.randn(4)}),
        {})
    seq.init_optimizer(optimizer_params=(("learning_rate", 0.5),))
    losses = []
    for b in range(3):
        x = rng.randn(8, 10).astype("float32")
        y = rng.randint(0, 4, 8).astype("float32")
        seq.forward(batch_cls([pkg.nd.array(x)], [pkg.nd.array(y)]),
                    is_train=True)
        seq.backward()
        seq.update()
        losses.append(seq.get_outputs()[0].asnumpy())
    return losses, _np(seq.get_params()[0])


def test_sequential_module_matches_reference():
    jl, jp = _sequential(jmx, JBatch)
    tl, tp = _sequential(tmx, TBatch)
    for t, j in zip(tl, jl):
        onp.testing.assert_allclose(t, j, atol=FIT_TOL)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        assert _rel(tp[n], jp[n]) <= FIT_TOL, n


def test_python_loss_module_feeds_its_gradient_back():
    def grad_func(label, scores):
        return scores - 1.0

    for pkg in (jmx, tmx):
        loss = pkg.mod.PythonLossModule(grad_func=grad_func)
        loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
        loss.forward(TBatch([pkg.nd.ones((2, 3))], [pkg.nd.zeros((2,))]))
        loss.backward()
        assert loss.get_input_grads()[0].asnumpy().tolist() == [[0.0] * 3] * 2
        assert loss.output_shapes == [("pyloss_output", (2, 3))]


# ----------------------------------------------------- monitor, legacy
def test_monitor_records_what_the_reference_records():
    x, y = _mlp_data(n=32)
    res = []
    for pkg in (jmx, tmx):
        it = pkg.io.NDArrayIter(x, y, batch_size=16)
        mod = pkg.mod.Module(_mlp(pkg.sym), context=pkg.cpu())
        mon = pkg.monitor.Monitor(interval=1, pattern=".*", sort=True,
                                  monitor_all=True)
        mod.install_monitor(mon)  # before bind: deferred
        mod.bind(it.provide_data, it.provide_label)
        mod.set_params(_arrays(pkg, _mlp_params()), {})
        mon.tic()
        mod.forward(next(iter(it)), is_train=False)
        res.append(mon.toc())
    assert [(s, n) for s, n, _ in res[1]] == [(s, n) for s, n, _ in res[0]]
    for (_, _, t), (_, _, j) in zip(res[1], res[0]):
        assert abs(float(t) - float(j)) <= FIT_TOL * max(1.0, abs(float(j)))
    assert tmx.mon is tmx.monitor


def test_feedforward_legacy_api(tmp_path):
    x, y = _mlp_data(seed=2, n=128, classes=3)
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    ff = tmx.model.FeedForward(_mlp(tmx.sym, num_hidden=12, classes=3),
                               ctx=tmx.cpu(), num_epoch=8,
                               optimizer="sgd", learning_rate=0.3,
                               momentum=0.9, initializer=tmx.init.Xavier())
    ff.fit(it)
    assert ff.predict(it).shape == (128, 3)
    assert ff.score(it) > 0.8
    prefix = str(tmp_path / "ff")
    ff.save(prefix, 8)
    ff2 = tmx.model.FeedForward.load(prefix, 8, ctx=tmx.cpu())
    assert "fc1_weight" in ff2.arg_params


def test_progress_bar_and_speedometer_log(caplog):
    caplog.set_level(logging.INFO)
    from mxnet_tpu_torch.module.base_module import _BatchEndParam

    m = tmx.metric.Accuracy()
    speed = tmx.callback.Speedometer(batch_size=8, frequent=2)
    bar = tmx.callback.ProgressBar(total=4)
    for i in range(5):
        speed(_BatchEndParam(0, i, m))
        bar(_BatchEndParam(0, i, m))
    text = caplog.text
    assert "samples/sec" in text and "[" in text and "%" in text


# ---------------------------------------------------------- guards
def test_bad_step_guard_aborts_and_restores(tmp_path, monkeypatch):
    x, y = _mlp_data(n=64)
    x[16:] = onp.nan  # every batch after the first is poisoned
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    mod = tmx.mod.Module(_mlp(tmx.sym))
    prefix = str(tmp_path / "g")
    monkeypatch.setenv("MXNET_BAD_STEP_LIMIT", "2")
    tmx.model.save_checkpoint(prefix, 1, _mlp(tmx.sym),
                              _arrays(tmx, _mlp_params()), {})
    with pytest.raises(MXNetError, match="restored to checkpoint epoch 1"):
        mod.fit(it, num_epoch=1, arg_params=_arrays(tmx, _mlp_params()),
                aux_params={}, checkpoint=prefix)
    for n, v in mod.get_params()[0].items():
        onp.testing.assert_array_equal(v.asnumpy(), onp.asarray(
            _mlp_params()[n], "float32"))


@pytest.mark.parametrize("what", ["contexts", "resume_from", "kvstore",
                                  "snapshot", "runlog", "numerics",
                                  "group2ctxs", "sharding_typo",
                                  "device_feed", "cuda_without_card"])
def test_what_is_not_ported_raises(what, monkeypatch, tmp_path):
    x, y = _mlp_data(n=32)
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    s = _mlp(tmx.sym)
    env = {"snapshot": ("MXNET_SNAPSHOT_EVERY", "5"),
           "runlog": ("MXNET_RUNLOG", str(tmp_path / "r.jsonl")),
           "numerics": ("MXNET_NUMERICS", "1"),
           "sharding_typo": ("MXNET_OPTIMIZER_SHARDING", "bogus")}
    if what == "device_feed":
        # ported since: fit feeds through io.DeviceFeedIter (on by
        # default, MXNET_DEVICE_FEED) and PrefetchingIter(device_feed=
        # True) feeds the device; the feed hands fit the same batches
        mods = []
        for feed in ("1", "0"):
            monkeypatch.setenv("MXNET_DEVICE_FEED", feed)
            onp.random.seed(0)
            m = tmx.mod.Module(s)
            m.fit(it, num_epoch=2)
            mods.append(m.get_params()[0])
        for n in mods[0]:
            onp.testing.assert_array_equal(mods[0][n].asnumpy(),
                                           mods[1][n].asnumpy())
        pf = tmx.io.PrefetchingIter(it, device_feed=True)
        assert next(iter(pf)).data[0].context == tmx.cpu()
        return
    if what in ("runlog", "numerics"):
        # ported since: the run log and the numerics monitor no longer
        # raise; fit writes the run log's step records and, with the
        # monitor on, its tensor_stats
        from mxnet_tpu.telemetry import schema as j_schema
        from mxnet_tpu_torch import telemetry as t_tm

        monkeypatch.setenv(*env[what])
        monkeypatch.setenv("MXNET_NUMERICS_SAMPLE", "1")
        path = tmp_path / "fit.jsonl"
        t_tm.reset(str(path))
        try:
            tmx.mod.Module(s).fit(it, num_epoch=1)
        finally:
            t_tm.close()
        with open(path) as f:
            recs, problems = j_schema.validate_lines(f)
        assert not problems, problems
        types = [r["type"] for r in recs]
        assert types.count("step") == 2
        assert ("tensor_stats" in types) == (what == "numerics")
        return
    with pytest.raises(MXNetError):
        if what == "contexts":
            tmx.mod.Module(s, context=[tmx.cpu(0), tmx.cpu(1)])
        elif what == "resume_from":
            tmx.mod.Module(s).fit(it, num_epoch=1, resume_from=str(tmp_path))
        elif what == "kvstore":
            mod = tmx.mod.Module(s)
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params()
            mod.init_optimizer(kvstore=object())
        elif what == "group2ctxs":
            tmx.mod.Module(s, group2ctxs={"dev1": tmx.cpu()})
        elif what == "device_feed":
            pass
        elif what == "cuda_without_card":
            # a CUDA request on a host without a card raises; the
            # default context is the card
            with tmx.gpu(0):
                tmx.mod.Module(s)
        else:
            monkeypatch.setenv(*env[what])
            tmx.mod.Module(s).fit(it, num_epoch=1)


def test_one_context_list_and_dist_kvstore_take_the_eager_updater(
        monkeypatch):
    x, y = _mlp_data(n=32)
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    monkeypatch.setenv("MXNET_OPTIMIZER_SHARDING", "ps")
    mod = tmx.mod.Module(_mlp(tmx.sym), context=[tmx.cpu()])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.init_optimizer(kvstore="dist_sync")
    from mxnet_tpu_torch.optimizer.optimizer import Updater

    assert type(mod._updater) is Updater
    assert mod._optimizer.rescale_grad == 1.0 / 16
