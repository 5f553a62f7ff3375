"""Manual model parallelism: ``AttrScope(ctx_group=...)`` and
``bind(group2ctx=...)`` place each group's nodes on its device, with a
transfer at each group boundary (reference ``tests/test_model_parallel.py``;
``mxnet_tpu/symbol/executor.py:35-60``), held against the reference's
grouped executor on the 8-device CPU mesh (``tests/conftest.py``).

On the host every ``cpu(i)`` of the port is the one CPU device, so these
tests hold the numerics and the recorded placement (which context each
node was given) and count the boundary crossings; the card check moves
tensors between ``cuda:0`` and the host (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``module_group2ctx``).
"""
import os
import subprocess
import sys

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLE = os.path.join(_REPO, "mxnet_tpu_torch", "example",
                        "model_parallel", "matrix_factorization.py")
#: the grouped executor against the reference's and the ungrouped one
TOL = dict(rtol=1e-6, atol=1e-7)
#: the 60-step training loops (reference test: the loss falls 10x)
LOOP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _two_group_net(mx):
    x = mx.sym.var("data")
    with mx.AttrScope(ctx_group="dev1"):
        w1 = mx.sym.var("w1")
        h = mx.sym.FullyConnected(x, w1, num_hidden=8, no_bias=True,
                                  name="fc1")
        h = mx.sym.Activation(h, act_type="tanh", name="act1")
    with mx.AttrScope(ctx_group="dev2"):
        w2 = mx.sym.var("w2")
        y = mx.sym.FullyConnected(h, w2, num_hidden=2, no_bias=True,
                                  name="fc2")
    return y


def _args(mx):
    rng = onp.random.RandomState(0)
    return {"data": mx.nd.array(rng.rand(4, 5).astype("float32")),
            "w1": mx.nd.array(rng.rand(8, 5).astype("float32")),
            "w2": mx.nd.array(rng.rand(2, 8).astype("float32"))}


def _step(mx, g2c):
    y = _two_group_net(mx)
    args = _args(mx)
    grads = {n: mx.nd.zeros(a.shape) for n, a in args.items()
             if n != "data"}
    ex = y.bind(ctx=mx.cpu(0), args=args, args_grad=grads,
                grad_req={"data": "null", "w1": "write", "w2": "write"},
                group2ctx=g2c)
    out = ex.forward(is_train=True)[0]
    ex.backward(mx.nd.ones((4, 2)))
    return ex, out.asnumpy(), {n: ex.grad_dict[n].asnumpy()
                               for n in ("w1", "w2")}


def test_attr_scope_tags_nodes():
    attrs = _two_group_net(tmx).attr_dict()
    assert attrs == _two_group_net(jmx).attr_dict()
    assert attrs["fc1"]["__ctx_group__"] == "dev1"
    assert attrs["fc2"]["__ctx_group__"] == "dev2"
    assert attrs["w1"]["__ctx_group__"] == "dev1"
    z = tmx.sym.var("plain")
    assert "__ctx_group__" not in (z.attr_dict().get("plain") or {})


def test_group2ctx_forward_backward_matches_single_device():
    g2c = {"dev1": tmx.Context("cpu", 0), "dev2": tmx.Context("cpu", 1)}
    ex, out, grads = _step(tmx, g2c)
    _, out0, grads0 = _step(tmx, None)
    _, jout, jgrads = _step(jmx, {"dev1": jmx.Context("cpu", 0),
                                  "dev2": jmx.Context("cpu", 1)})
    onp.testing.assert_allclose(out, jout, **TOL)
    onp.testing.assert_allclose(out, out0, **TOL)
    for n in grads:
        onp.testing.assert_allclose(grads[n], jgrads[n], **TOL)
        onp.testing.assert_allclose(grads[n], grads0[n], **TOL)
    # the recorded placement: each group's nodes on its context, the
    # untagged data on the bind context; one crossing dev1 -> dev2
    assert ex.placement == {"data": "cpu(0)", "w1": "cpu(0)",
                            "fc1": "cpu(0)", "act1": "cpu(0)",
                            "w2": "cpu(1)", "fc2": "cpu(1)"}
    assert ex.transfers == 1


def _loop(mx, g2c):
    y = _two_group_net(mx)
    loss = mx.sym.sum(mx.sym.square(y - mx.sym.var("label")))
    rng = onp.random.RandomState(1)
    xs = rng.rand(16, 5).astype("float32")
    w_true = rng.rand(2, 5).astype("float32")
    args = {"data": mx.nd.array(xs), "label": mx.nd.array(xs @ w_true.T),
            "w1": mx.nd.array(rng.rand(8, 5).astype("float32") * 0.5),
            "w2": mx.nd.array(rng.rand(2, 8).astype("float32") * 0.5)}
    grads = {"w1": mx.nd.zeros((8, 5)), "w2": mx.nd.zeros((2, 8))}
    ex = loss.bind(ctx=mx.cpu(0), args=args, args_grad=grads,
                   grad_req={"data": "null", "label": "null",
                             "w1": "write", "w2": "write"},
                   group2ctx=g2c)
    losses = []
    for _ in range(60):
        out = ex.forward(is_train=True)[0]
        ex.backward()
        losses.append(float(out.asnumpy()))
        for n in ("w1", "w2"):
            a = ex.arg_dict[n]
            a._adopt(a._data - 0.01 * ex.grad_dict[n]._data)
    return losses


def test_group2ctx_training_loop_converges():
    got = _loop(tmx, {"dev1": tmx.Context("cpu", 2),
                      "dev2": tmx.Context("cpu", 3)})
    want = _loop(jmx, {"dev1": jmx.Context("cpu", 2),
                       "dev2": jmx.Context("cpu", 3)})
    assert got[-1] < got[0] * 0.1, (got[0], got[-1])
    onp.testing.assert_allclose(got, want, **LOOP_TOL)


def test_module_group2ctxs_trains_as_the_grouped_graph():
    """``Module(group2ctxs=...)`` binds its executor grouped (one dict,
    or a list of one) and trains what the ungrouped Module trains."""
    y = _two_group_net(tmx)
    net = tmx.sym.LinearRegressionOutput(y, tmx.sym.var("label"))
    rng = onp.random.RandomState(2)
    X = rng.rand(16, 5).astype("float32")
    Y = rng.rand(16, 2).astype("float32")
    init = {"w1": tmx.nd.array(rng.rand(8, 5).astype("float32")),
            "w2": tmx.nd.array(rng.rand(2, 8).astype("float32"))}
    runs = []
    for g2c in (None, [{"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}]):
        it = tmx.io.NDArrayIter(X, Y, batch_size=8, label_name="label")
        mod = tmx.mod.Module(net, label_names=("label",), group2ctxs=g2c)
        mod.fit(it, num_epoch=2, arg_params=init, aux_params={},
                optimizer_params=(("learning_rate", 0.1),))
        runs.append((mod, {n: v.asnumpy()
                           for n, v in mod.get_params()[0].items()}))
    (_, plain), (grouped, got) = runs
    for n in plain:
        onp.testing.assert_allclose(got[n], plain[n], **TOL)
    assert grouped._exec.placement["w2"] == "cpu(1)"
    # dev1 -> dev2, and back to the untagged head on the bind context
    assert grouped._exec.transfers == 2


def test_matrix_factorization_example_runs_and_its_loss_falls():
    r = subprocess.run([sys.executable, _EXAMPLE, "--steps", "20",
                        "--users", "8", "--items", "8"], cwd=_REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "model_parallel_mf OK" in r.stdout
    assert "3 boundary transfers a step" in r.stderr
    # in-process: the grouped run equals the ungrouped one
    from mxnet_tpu_torch.example.model_parallel import \
        matrix_factorization as mf

    args = mf.parse_args(["--steps", "20", "--users", "8", "--items", "8"])
    grouped, ex = mf.train(args, tmx.cpu(0), {"dev1": tmx.cpu(0),
                                              "dev2": tmx.cpu(1)})
    plain, _ = mf.train(args, tmx.cpu(0), None)
    onp.testing.assert_allclose(grouped, plain, **TOL)
    assert ex.placement["item_embed"] == "cpu(1)"
    assert ex.placement["user_embed"] == "cpu(0)"
