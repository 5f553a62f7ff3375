"""The Module over a process mesh, held against the reference's Module on
a mesh of as many CPU devices.

The port runs in N worker processes on a CPU gloo group, started by its
launcher (``mxnet_tpu_torch/tools/launch.py -n N --cpu``), one launch a
world size running every case of it (``tests/torch_dist_module_worker.py``),
and a third, at world 2, resuming the drills' drain checkpoints.  The
seeded inputs reach the workers through an ``.npz``.  The oracle is the
reference's ``Module(context=[gpu(0)..gpu(N-1)])`` on an N-device CPU
mesh in this process (``tests/conftest.py`` gives it 8 host devices), or
its one-device Module on the global batch where the reference's mesh
computes the same thing.

- Multi-context data parallelism (``tests/test_symbol_module.py:188``)
  at worlds 2 and 4 against the reference's 2- and 4-device meshes, at
  the reference's ``rtol=2e-4, atol=2e-5``; the batch that the mesh does
  not divide.
- ``kvstore="dist_sync"`` takes the sharded updater and trains what the
  per-parameter updater trains within the reference's ``rtol=1e-5,
  atol=1e-6`` (``tests/test_zero_sharding.py:299-770``): weight decay,
  the live ``num_update`` clock, live lr, wd and momentum, the states
  round trips, the refusals, the state-lost error, the env's force-off
  and fallbacks; the bucket kernels (their plain versions here) on the
  owned shards.
- The traps of the summed exchange: the counted all-reduces and bytes,
  the default ``rescale_grad`` of the global batch, ``SoftmaxOutput``'s
  ``normalization`` and the regression output's division by the global
  batch, ``grad_req="add"``, the gathered input gradients and outputs,
  the metric, BatchNorm's global statistics equal on every rank.
- Resilience: the ``dist.collective`` fault with the state whole; the
  sharded SIGTERM drain then resume, bit-exact at the same world
  (reference ``tests/test_resilience.py:481``); the resize drill, world
  4 drained and resumed at world 2 (``tests/test_elastic.py:484`` cut
  to CPU worlds), at its ``rtol=2e-4, atol=1e-6``.
"""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as onp
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCH = os.path.join(_REPO, "mxnet_tpu_torch", "tools", "launch.py")
_WORKER = os.path.join(_REPO, "tests", "torch_dist_module_worker.py")
_TIMEOUT = 240
#: multi-context against the reference's mesh and one context
#: (tests/test_symbol_module.py:236-237)
MESH_TOL = dict(rtol=2e-4, atol=2e-5)
#: the sharded updater against the per-parameter one
#: (tests/test_zero_sharding.py:373-374)
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)
#: one forward/backward's gradients against the reference's
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
#: the resized resume against the uninterrupted run
#: (tests/test_elastic.py:541)
RESIZE_TOL = dict(rtol=2e-4, atol=1e-6)
PARAMS = ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias")


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    for k in ("MXNET_OPTIMIZER_SHARDING", "MXNET_ZERO_STAGE",
              "MXNET_FAULT_SPEC"):
        env.pop(k, None)
    return env


class _Job:
    def __init__(self, n, *args):
        self._p = subprocess.Popen(
            [sys.executable, _LAUNCH, "-n", str(n), "--cpu",
             sys.executable, _WORKER, *args], env=_env(), cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        self._res = None

    def result(self):
        if self._res is None:
            try:
                out, err = self._p.communicate(timeout=_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(self._p.pid, 9)
                out, err = self._p.communicate()
            self._res = (self._p.returncode, out, err)
        return self._res


# ------------------------------------------------------------ inputs
def _inputs():
    d = {}
    rng = onp.random.RandomState(3)
    w = rng.randn(10, 4).astype("float32")
    d["mc/X"] = rng.randn(256, 10).astype("float32")
    d["mc/y"] = (d["mc/X"] @ w).argmax(axis=1).astype("float32")
    rng = onp.random.RandomState(7)
    d["fit/X"] = rng.randn(64, 10).astype("float32")
    d["fit/y"] = (d["fit/X"] @ rng.randn(10, 4)).argmax(axis=1) \
        .astype("float32")
    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (4, 16), "fc2_bias": (4,)}
    for case, seed in (("mc", 11), ("fit", 3)):
        r = onp.random.RandomState(seed)
        for n, s in shapes.items():
            d[f"{case}/init/{n}"] = (r.randn(*s) * 0.3).astype("float32")
    r = onp.random.RandomState(5)
    d["norm/X"] = r.randn(16, 10).astype("float32")
    d["norm/y"] = r.randint(0, 4, 16).astype("float32")
    d["norm/ylin"] = r.randn(16, 4).astype("float32")
    d["norm/init/fc_weight"] = (r.randn(4, 10) * 0.3).astype("float32")
    d["norm/init/fc_bias"] = (r.randn(4) * 0.1).astype("float32")
    r = onp.random.RandomState(9)
    d["bn/X"] = (r.randn(8, 3, 6, 6) * 2 + 0.5).astype("float32")
    d["bn/y"] = r.randint(0, 3, 8).astype("float32")
    for n, s in (("conv_weight", (4, 3, 3, 3)), ("conv_bias", (4,)),
                 ("fc_weight", (3, 4)), ("fc_bias", (3,))):
        d[f"bn/init/{n}"] = (r.randn(*s) * 0.3).astype("float32")
    d["bn/init/bn_gamma"] = (r.rand(4) + 0.5).astype("float32")
    d["bn/init/bn_beta"] = (r.randn(4) * 0.1).astype("float32")
    d["bn/aux/bn_moving_mean"] = (r.randn(4) * 0.1).astype("float32")
    d["bn/aux/bn_moving_var"] = (r.rand(4) + 0.5).astype("float32")
    return d


@pytest.fixture(scope="module")
def jobs():
    d = tempfile.mkdtemp(prefix="torch_dist_module_")
    data = _inputs()
    inp = os.path.join(d, "in.npz")
    onp.savez(inp, **data)
    out = {"dir": d, "data": data, "inp": inp}
    for world in (2, 4):
        out[world] = _Job(world, "main", inp, os.path.join(d, f"w{world}"),
                          os.path.join(d, f"ck{world}", "ck"))
    return out


def _ranks(jobs, world, name=None):
    rc, out, err = jobs[world].result()
    name = name or f"w{world}"
    files = [os.path.join(jobs["dir"], f"{name}.r{r}.npz")
             for r in range(world)]
    assert all(os.path.exists(f) for f in files), err[-3000:]
    return [dict(onp.load(f)) for f in files]


def _case(res, case):
    pre = case + "/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _resumed(jobs):
    """The world-2 job resuming the world-2 and world-4 drills (started
    once both have drained)."""
    if "resume" not in jobs:
        for world in (2, 4):
            rc, _, err = jobs[world].result()
            assert rc != 0, "the drill's drain did not end its workers"
            assert "COMPLETED" not in jobs[world].result()[1]
        jobs["resume"] = _Job(2, "resume", jobs["inp"],
                              os.path.join(jobs["dir"], "rs"),
                              *[os.path.join(jobs["dir"], f"ck{w}", "ck")
                                for w in (2, 4)])
    rc, _, err = jobs["resume"].result()
    assert rc == 0, err[-3000:]
    return [dict(onp.load(os.path.join(jobs["dir"], f"rs.r{r}.npz")))
            for r in range(2)]


# ------------------------------------------------------------ the oracle
_REF = {}


def _jarr(a):
    return jmx.nd.array(a)


def _jmlp(**kw):
    s = jmx.sym
    d = s.Variable("data")
    fc1 = s.FullyConnected(d, num_hidden=16, name="fc1")
    act = s.Activation(fc1, act_type="relu", name="relu1")
    fc2 = s.FullyConnected(act, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(fc2, s.Variable("softmax_label"),
                           name="softmax", **kw)


def _ref_mc(n):
    key = ("mc", n)
    if key not in _REF:
        d = _inputs()
        it = jmx.io.NDArrayIter(d["mc/X"], d["mc/y"], batch_size=32,
                                shuffle=False)
        mod = jmx.mod.Module(_jmlp(), context=[jmx.gpu(i) for i in
                                               range(n)])
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(initializer=jmx.init.Xavier())
        mod.set_params({k: _jarr(d[f"mc/init/{k}"]) for k in PARAMS}, {})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.2),
                                             ("momentum", 0.9)))
        for _ in range(3):
            it.reset()
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
        score = mod.score(it, jmx.metric.Accuracy())[0][1]
        it.reset()
        mod.forward(next(iter(it)), is_train=False)
        _REF[key] = (score, mod.get_outputs()[0].asnumpy(),
                     {k: v.asnumpy() for k, v in mod.get_params()[0]
                      .items()})
    return _REF[key]


def _lrwd(mod, epoch):
    if epoch == 2:
        mod._optimizer.set_learning_rate(0.01)
        mod._optimizer.wd = 1e-2


def _mom(mod, epoch):
    if epoch == 2:
        mod._optimizer.momentum = 0.0
        mod._optimizer.clip_gradient = 0.05


#: the worker's FIT_CASES: optimizer, epochs, extra parameters, mutation
FIT = {"sgd": ("sgd", 2, (), None),
       "wd": ("sgd", 2, (("wd", 1e-2),), None),
       "adam": ("adam", 2, (("begin_num_update", 5),), None),
       "lrwd": ("sgd", 4, (), _lrwd),
       "mom": ("sgd", 4, (), _mom)}


def _ref_fit(case):
    """The reference's ``_fit_module("dist_sync", ...)`` on its 2-device
    mesh: the sharded updater there too."""
    key = ("fit", case)
    if key not in _REF:
        optimizer, epochs, extra, mutate = FIT[case]
        d = _inputs()
        it = jmx.io.NDArrayIter(d["fit/X"], d["fit/y"], batch_size=8,
                                shuffle=False)
        mod = jmx.mod.Module(_jmlp(), context=[jmx.gpu(0), jmx.gpu(1)])
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(initializer=jmx.init.Xavier())
        mod.set_params({k: _jarr(d[f"fit/init/{k}"]) for k in PARAMS},
                       {})
        opt_params = [("learning_rate", 0.1)]
        if optimizer == "sgd":
            opt_params.append(("momentum", 0.9))
        opt_params.extend(extra)
        mod.init_optimizer(kvstore="dist_sync", optimizer=optimizer,
                           optimizer_params=tuple(opt_params))
        for epoch in range(epochs):
            if mutate is not None:
                mutate(mod, epoch)
            it.reset()
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
        _REF[key] = {k: v.asnumpy() for k, v in mod.get_params()[0]
                     .items()}
    return _REF[key]


def _ref_grads(head, backwards=1, inputs_need_grad=False):
    """One device, the global batch: the reference's mesh computes the
    same gradients."""
    d = _inputs()
    s = jmx.sym
    fc = s.FullyConnected(s.Variable("data"), num_hidden=4, name="fc")
    if head == "linear":
        net = s.LinearRegressionOutput(fc, s.Variable("softmax_label"),
                                       name="lin")
        y = d["norm/ylin"]
    else:
        net = s.SoftmaxOutput(fc, s.Variable("softmax_label"),
                              normalization=head, name="softmax")
        y = d["norm/y"]
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.bind(data_shapes=[("data", d["norm/X"].shape)],
             label_shapes=[("softmax_label", y.shape)],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(arg_params={k: _jarr(d[f"norm/init/{k}"])
                                for k in ("fc_weight", "fc_bias")},
                    aux_params={})
    batch = jmx.io.DataBatch([_jarr(d["norm/X"])], [_jarr(y)])
    mod.forward(batch, is_train=True)
    mod.backward()
    out = {f"g/{n}": mod._exec.grad_dict[n].asnumpy() * backwards
           for n in ("fc_weight", "fc_bias")}
    if inputs_need_grad:
        out["dx"] = mod.get_input_grads()[0].asnumpy()
    return out


def _ref_bn():
    if "bn" not in _REF:
        d = _inputs()
        s = jmx.sym
        x = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                          pad=(1, 1), name="conv")
        x = s.BatchNorm(x, fix_gamma=False, name="bn")
        x = s.Activation(x, act_type="relu", name="relu")
        x = s.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="pool")
        x = s.FullyConnected(x, num_hidden=3, name="fc")
        net = s.SoftmaxOutput(x, s.Variable("softmax_label"),
                              name="softmax")
        mod = jmx.mod.Module(net, context=[jmx.gpu(0), jmx.gpu(1)])
        mod.bind(data_shapes=[("data", d["bn/X"].shape)],
                 label_shapes=[("softmax_label", d["bn/y"].shape)])
        mod.init_params(
            arg_params={k[len("bn/init/"):]: _jarr(v) for k, v in d.items()
                        if k.startswith("bn/init/")},
            aux_params={k[len("bn/aux/"):]: _jarr(v) for k, v in d.items()
                        if k.startswith("bn/aux/")})
        mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),
                                             ("momentum", 0.9)))
        batch = jmx.io.DataBatch([_jarr(d["bn/X"])], [_jarr(d["bn/y"])])
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        arg, aux = mod.get_params()
        _REF["bn"] = ({k: v.asnumpy() for k, v in arg.items()},
                      {k: v.asnumpy() for k, v in aux.items()})
    return _REF["bn"]


def _close(got, want, tol, what):
    for k, v in want.items():
        onp.testing.assert_allclose(got[k], v, err_msg=f"{what} {k}",
                                    **tol)


def _params(case_res):
    return {k[2:]: v for k, v in case_res.items() if k.startswith("p/")}


def _replicas_equal(ranks, case):
    first = _case(ranks[0], case)
    for res in ranks[1:]:
        for k, v in _case(res, case).items():
            onp.testing.assert_array_equal(v, first[k], err_msg=k)


# ------------------------------------------------------------ the contract
@pytest.mark.parametrize("world", [2, 4])
def test_multi_context_matches_the_reference_mesh(jobs, world):
    ranks = _ranks(jobs, world)
    score, out, ref_p = _ref_mc(world)
    _replicas_equal(ranks, "mc")
    mc, one = _case(ranks[0], "mc"), _case(ranks[0], "mc1")
    _close(_params(mc), ref_p, MESH_TOL, f"world {world}")
    _close(_params(one), ref_p, MESH_TOL, "one context")
    # the metric reads the global batch's rows: the reference's score
    assert float(mc["score"]) > 0.85
    assert abs(float(mc["score"]) - score) <= 1.0 / 256
    # get_outputs: the global batch's rows, in rank order
    assert mc["out"].shape == (32, 4)
    onp.testing.assert_allclose(mc["out"], out, **MESH_TOL)
    onp.testing.assert_allclose(mc["out"], one["out"], **MESH_TOL)


def test_several_contexts_outside_a_job_raise():
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=2)
    with pytest.raises(MXNetError, match=r"outside a launched job.*§C"):
        tmx.mod.Module(s, context=[tmx.cpu(0), tmx.cpu(1)])


def test_a_batch_the_mesh_does_not_divide_raises(jobs):
    res = _case(_ranks(jobs, 2)[0], "divide")
    assert bool(res["raised"])
    # group2ctxs cannot combine with the mesh (reference module.py:154)
    assert bool(res["group2ctxs"])


def test_dist_sync_maps_to_the_sharded_updater(jobs):
    ranks = _ranks(jobs, 2)
    _replicas_equal(ranks, "fit_dist_sync_sgd")
    s = _case(ranks[0], "fit_dist_sync_sgd")
    loc = _case(ranks[0], "fit_local_sgd")
    assert bool(s["sharded"]) and not bool(loc["sharded"])
    # on the host with nothing forced: the plain rule
    assert int(s["pallas"]) == 0
    _close(_params(s), _params(loc), SHARD_TOL, "sharded vs local")
    _close(_params(s), _ref_fit("sgd"), MESH_TOL, "against the reference")


@pytest.mark.parametrize("case", ["wd", "adam", "lrwd", "mom"])
def test_sharded_follows_the_per_parameter_updater(jobs, case):
    ranks = _ranks(jobs, 2)
    s = _case(ranks[0], f"fit_dist_sync_{case}")
    loc = _case(ranks[0], f"fit_local_{case}")
    assert bool(s["sharded"]) and not bool(loc["sharded"])
    _close(_params(s), _params(loc), SHARD_TOL, f"{case}: sharded vs local")
    _close(_params(s), _ref_fit(case), MESH_TOL, f"{case}: the reference")
    if case in ("wd", "lrwd"):
        # biases (wd_mult 0) and weights in buckets of their own
        assert int(s["groups"]) == 2
    if case == "adam":
        # 2 epochs of 8 batches over begin_num_update 5, both clocks
        assert int(s["num_update"]) == int(loc["num_update"]) == 21
        assert int(s["t"]) == 21


def test_the_bucket_kernels_run_on_owned_shards(jobs):
    ranks = _ranks(jobs, 2)
    k = _case(ranks[0], "fit_dist_sync_kernel")
    assert int(k["pallas"]) == 1
    _close(_params(k), _params(_case(ranks[0], "fit_dist_sync_sgd")),
           SHARD_TOL, "kernel arm vs plain rule")


def test_the_states_contract(jobs):
    st = _case(_ranks(jobs, 2)[0], "states")
    assert int(st["dump_num_update"]) == 16
    assert list(st["legacy_keys"]) == sorted(PARAMS + ("__step",))
    assert bool(st["roundtrip_bitwise"])
    assert bool(st["repoint_dist_sync"]) and bool(st["repoint_local"])
    assert bool(st["step_restored"])
    assert int(st["stale_step_t"]) == 24
    assert bool(st["eager_seeded"])
    assert st["refused"].tolist() == [True, True, True]
    assert st["state_lost"].tolist() == [True, True, True]


def test_the_env_forces_off_and_falls_back(jobs):
    env = _case(_ranks(jobs, 2)[0], "env")
    # MXNET_OPTIMIZER_SHARDING=0, nadam's layouts, =ps with kvstore local
    assert env["sharded"].tolist() == [False, False, True]


def test_the_exchange_sums_one_all_reduce_a_bucket(jobs):
    ex = _case(_ranks(jobs, 2)[0], "exch")
    assert int(ex["all-reduce/launches"]) == int(ex["grad_buckets"]) >= 1
    assert int(ex["all-reduce/bytes"]) == 4 * int(ex["grad_size"])
    assert int(ex["all-gather/launches"]) == int(ex["upd_buckets"])
    assert int(ex["all-gather/bytes"]) == 4 * int(ex["upd_padded"])
    # rescale_grad: 1 / the global batch, not the process's rows
    assert float(ex["rescale_grad"]) == 1.0 / 8
    assert bool(ex["topology_agrees"])


@pytest.mark.parametrize("head", ["batch", "valid", "linear"])
def test_heads_divide_by_the_global_batch(jobs, head):
    ranks = _ranks(jobs, 2)
    _replicas_equal(ranks, f"norm_{head}")
    _close(_case(ranks[0], f"norm_{head}"), _ref_grads(head), GRAD_TOL,
           head)


def test_grad_add_and_the_input_gradients(jobs):
    ranks = _ranks(jobs, 2)
    _close(_case(ranks[0], "add"), _ref_grads("null", backwards=2),
           GRAD_TOL, "grad_req add")
    _close(_case(ranks[0], "ingrad"),
           _ref_grads("null", inputs_need_grad=True), GRAD_TOL,
           "input gradients")
    assert _case(ranks[0], "ingrad")["dx"].shape == (16, 10)


@pytest.mark.parametrize("world", [2, 4])
def test_batchnorm_is_global_and_equal_on_every_rank(jobs, world):
    ranks = _ranks(jobs, world)
    _replicas_equal(ranks, "bn")
    got = _case(ranks[0], "bn")
    assert int(got["bn_launches"]) > 0
    ref_p, ref_aux = _ref_bn()
    _close(_params(got), ref_p, MESH_TOL, "params")
    _close({k[4:]: v for k, v in got.items() if k.startswith("aux/")},
           ref_aux, MESH_TOL, "moving statistics")


def test_a_lost_collective_keeps_the_state_whole(jobs):
    f = _case(_ranks(jobs, 2)[0], "fault")
    assert bool(f["raised"])
    assert list(f["keys"]) == ["__step", "b", "w"]
    assert int(f["t"]) == 2  # the failed step did not count
    onp.testing.assert_allclose(f["w"], onp.full((16, 4), 1 - 2 * 0.05),
                                rtol=1e-6)


def test_bucketing_shares_its_arrays_over_the_mesh(jobs):
    ranks = _ranks(jobs, 2)
    b = _case(ranks[0], "bucketing")
    assert bool(b["shared"]) and bool(b["sharded"])
    _replicas_equal(ranks, "bucketing")


# ------------------------------------------------------------ resilience
def test_sharded_drain_then_resume_is_bit_exact(jobs):
    resumed = _case(_resumed(jobs)[0], "r0")
    assert not bool(resumed["reshard"]) and bool(resumed["sharded"])
    whole = _ranks(jobs, 2, "w2.drill")[0]
    for k, v in _params(resumed).items():
        onp.testing.assert_array_equal(v, whole[f"p/{k}"], err_msg=k)


def test_resize_drill_four_drained_resumed_at_two(jobs):
    ranks = _resumed(jobs)
    resumed = _case(ranks[0], "r1")
    assert bool(resumed["reshard"]) and int(resumed["old_world"]) == 4
    whole = _ranks(jobs, 4, "w4.drill")[0]
    _close(_params(resumed), {k[2:]: v for k, v in whole.items()},
           RESIZE_TOL, "world 4 -> 2")
    _replicas_equal(ranks, "r1")
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    st = CheckpointManager(os.path.join(jobs["dir"], "ck4", "ck")).load(
        ctx=tmx.cpu())
    assert st["epoch"] == 1 and st["batch_cursor"] == 3
    topo = st["topology"]
    assert topo["world_size"] == 4 and topo["sharding"] == "ps"
    assert topo["global_batch"] == 8 and topo["plan_fingerprint"]
    legacy, opt_copy = pickle.loads(st["optimizer_states"])
    assert set(legacy) == set(PARAMS) | {"__step"}
    assert opt_copy.num_update == 11
