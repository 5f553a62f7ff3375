"""The port's optimizer update ops (``ops/optimizer_ops.py``) and the
bucket-kernel ops (``ops/pallas_opt.py``'s ``_pallas_bucket_*``) held
against the JAX package's registered ops on the CPU.

- Each of the reference's 18 update-op names (17 ops and the alias
  ``_sparse_adagrad_update``) is registered in the port with the
  reference's output count and ``differentiable=False``; called through
  ``mx.nd`` on the same seeded inputs and hyper-parameters (rescale and
  clip included), every output equals the reference's to 1e-6 of its
  largest magnitude (XLA:CPU contracts ``a*b + c`` into fused
  multiply-adds that PyTorch rounds twice).
- ``_pallas_bucket_{sgd_mom,adam,lars}_update`` on CPU tensors are the
  plain versions of the bucket kernels: bit for bit the port's
  ``bucket_update`` twins, and within 1e-6 of the reference's
  ``_fused_bucket_*`` (the relation ``tests/test_pallas_opt.py`` holds
  for the reference's own kernels).  A bucket the kernels cannot run
  raises, naming the plain op.
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.ops import registry as j_reg  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import pallas_opt as t_po  # noqa: E402
from mxnet_tpu_torch.ops import registry as t_reg  # noqa: E402
from mxnet_tpu_torch.optimizer import optimizer as t_opt  # noqa: E402

TOL = 1e-6
SHAPE = (6, 7)
_PREP = dict(rescale_grad=0.5, clip_gradient=0.8)

#: name -> (number of state inputs, hyper-parameters)
OPS = {
    "sgd_update": (0, dict(lr=0.1, wd=0.01, **_PREP)),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01, **_PREP)),
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01, **_PREP)),
    "adam_update": (2, dict(lr=0.01, wd=0.01, t=3.0, **_PREP)),
    "rmsprop_update": (1, dict(lr=0.01, gamma1=0.9, wd=0.01,
                               clip_weights=0.9, **_PREP)),
    "rmspropalex_update": (3, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   wd=0.01, **_PREP)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.01, beta=1.0, wd=0.01,
                            **_PREP)),
    "signsgd_update": (0, dict(lr=0.01, wd=0.01, **_PREP)),
    "signum_update": (1, dict(lr=0.01, momentum=0.9, wd=0.01, wd_lh=0.01,
                              **_PREP)),
    "adagrad_update": (1, dict(lr=0.1, epsilon=1e-7, wd=0.01, **_PREP)),
    "_sparse_adagrad_update": (1, dict(lr=0.1, wd=0.01, **_PREP)),
    "_fused_bucket_sgd_mom_update": (1, dict(lr=0.1, momentum=0.9,
                                             wd=0.01, **_PREP)),
    "_fused_bucket_adam_update": (2, dict(lr=0.01, wd=0.01, t=2.0,
                                          **_PREP)),
}


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _close(got, want):
    got = onp.asarray(got, "float64")
    want = onp.asarray(want, "float64")
    assert got.shape == want.shape
    scale = max(float(onp.abs(want).max()), 1e-30)
    assert float(onp.abs(got - want).max()) <= TOL * scale


def _call(pkg, name, arrays, params):
    out = getattr(pkg.nd, name)(*[pkg.nd.array(a) for a in arrays],
                                **params)
    return [o.asnumpy() for o in (out if isinstance(out, (list, tuple))
                                  else [out])]


def _inputs(n_state, seed, shape=SHAPE):
    rng = onp.random.RandomState(seed)
    w = rng.randn(*shape).astype("float32")
    g = rng.randn(*shape).astype("float32")
    # moments and histories are non-negative where a rule takes a root;
    # the first state (a second moment) is at least 0.1, above the
    # square of any later one (rmspropalex's n - g_avg^2)
    states = [(onp.abs(rng.randn(*shape)) * 0.1 ** (i + 1)
               + (0.1 if i == 0 else 0.0)).astype("float32")
              for i in range(n_state)]
    return [w, g] + states


def test_every_reference_update_op_is_registered():
    names = sorted(n for n in j_reg.list_ops()
                   if n.endswith("_update") or n.startswith("multi_"))
    for name in names:
        if name == "multi_all_finite":
            continue  # the AMP op, ported with contrib.amp
        j, t = j_reg.get_op(name), t_reg.get_op(name)
        assert t.differentiable is j.differentiable is False, name
        params = {"num_weights": 3}
        assert t.out_count(params) == j.out_count(params), name
    assert t_reg.get_op("_sparse_adagrad_update") is \
        t_reg.get_op("adagrad_update")
    assert len([n for n in names if not n.startswith("_pallas")]) >= 18


@pytest.mark.parametrize("name", list(OPS))
def test_update_op_matches_reference(name):
    n_state, params = OPS[name]
    arrays = _inputs(n_state, seed=len(name))
    want = _call(jmx, name, arrays, params)
    got = _call(tmx, name, arrays, params)
    assert len(got) == len(want) == t_reg.get_op(name).out_count(params)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("clip", [-1.0, 0.3])
def test_ftrl_and_rmsprop_without_and_with_clip(clip):
    """The clip applies only when positive (reference ``_prep``)."""
    for name in ("ftrl_update", "rmsprop_update", "signum_update"):
        n_state, params = OPS[name]
        params = dict(params, clip_gradient=clip)
        arrays = _inputs(n_state, seed=3)
        for a, b in zip(_call(tmx, name, arrays, params),
                        _call(jmx, name, arrays, params)):
            _close(a, b)


@pytest.mark.parametrize("name,momentum", [("multi_sgd_update", None),
                                           ("multi_sgd_mom_update", 0.9)])
def test_multi_tensor_updates_match_reference(name, momentum):
    rng = onp.random.RandomState(5)
    shapes = [(4, 3), (7,), (2, 2, 2)]
    ws = [rng.randn(*s).astype("float32") for s in shapes]
    gs = [rng.randn(*s).astype("float32") for s in shapes]
    ms = [rng.randn(*s).astype("float32") for s in shapes]
    arrays = ws + gs + (ms if momentum is not None else [])
    params = dict(lrs=[0.1, 0.2, 0.05], wds=[0.0, 0.01, 0.1],
                  num_weights=3, **_PREP)
    if momentum is not None:
        params["momentum"] = momentum
    got, want = _call(tmx, name, arrays, params), \
        _call(jmx, name, arrays, params)
    assert len(got) == len(want) == (6 if momentum else 3)
    for a, b in zip(got, want):
        _close(a, b)


def test_lars_helpers_match_reference():
    rng = onp.random.RandomState(9)
    arrays = [rng.randn(5, 4).astype("float32"),
              rng.randn(9).astype("float32") * 3]
    got = _call(tmx, "multi_sum_sq", arrays, dict(num_arrays=2))
    want = _call(jmx, "multi_sum_sq", arrays, dict(num_arrays=2))
    _close(got[0], want[0])
    lrs = onp.array([0.1, 0.2, 0.3], "float32")
    wss = onp.array([4.0, 0.0, 9.0], "float32")
    gss = onp.array([1.0, 2.0, 0.0], "float32")
    wds = onp.array([0.01, 0.0, 0.1], "float32")
    p = dict(eta=0.001, eps=1e-8, rescale_grad=0.5)
    _close(_call(tmx, "multi_lars", [lrs, wss, gss, wds], p)[0],
           _call(jmx, "multi_lars", [lrs, wss, gss, wds], p)[0])


def _bucket(n, seed, nseg=None):
    rng = onp.random.RandomState(seed)
    w, g = rng.randn(n).astype("float32"), rng.randn(n).astype("float32")
    m = rng.randn(n).astype("float32") * 0.1
    v = onp.abs(rng.randn(n)).astype("float32") * 0.1
    seg = None if nseg is None else onp.sort(
        rng.randint(0, nseg, n)).astype("int32")
    return w, g, m, v, seg


def test_pallas_bucket_sgd_mom_matches_twin_and_reference():
    w, g, m, _, _ = _bucket(1000, 1)
    got = _call(tmx, "_pallas_bucket_sgd_mom_update", [w, g, m],
                dict(lr=0.1, momentum=0.9, wd=0.01))
    opt = t_opt.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
    tw, (tm,), _ = t_po.bucket_update(opt, torch.from_numpy(w),
                                      torch.from_numpy(g),
                                      (torch.from_numpy(m),), 1.0)
    assert onp.array_equal(got[0], tw.numpy())
    assert onp.array_equal(got[1], tm.numpy())
    want = _call(jmx, "_fused_bucket_sgd_mom_update", [w, g, m],
                 dict(lr=0.1, momentum=0.9, wd=0.01))
    for a, b in zip(got, want):
        _close(a, b)


def test_pallas_bucket_adam_matches_twin_and_reference():
    w, g, m, v, _ = _bucket(1000, 2)
    got = _call(tmx, "_pallas_bucket_adam_update", [w, g, m, v],
                dict(lr=0.01, wd=0.01))
    opt = t_opt.Adam(learning_rate=0.01, wd=0.01)
    tw, (tm, tv), _ = t_po.bucket_update(
        opt, torch.from_numpy(w), torch.from_numpy(g),
        (torch.from_numpy(m), torch.from_numpy(v)), 1.0)
    for a, b in zip(got, (tw, tm, tv)):
        assert onp.array_equal(a, b.numpy())
    want = _call(jmx, "_fused_bucket_adam_update", [w, g, m, v],
                 dict(lr=0.01, wd=0.01, t=1.0))
    for a, b in zip(got, want):
        _close(a, b)


def test_pallas_bucket_lars_matches_twin_and_reference():
    w, g, m, _, seg = _bucket(1200, 3, nseg=7)
    p = dict(lr=0.5, num_segments=7, momentum=0.9, wd=0.01)
    got = _call(tmx, "_pallas_bucket_lars_update", [w, g, m, seg], p)
    opt = t_opt.LARS(learning_rate=0.5, momentum=0.9, wd=0.01)
    tw, (tm,), _ = t_po.bucket_update(
        opt, torch.from_numpy(w), torch.from_numpy(g),
        (torch.from_numpy(m),), 1.0,
        seg=(torch.from_numpy(seg), 7))
    assert onp.array_equal(got[0], tw.numpy())
    assert onp.array_equal(got[1], tm.numpy())
    want = _call(jmx, "_fused_bucket_lars_update", [w, g, m, seg],
                 dict(p, lars_eta=0.001, lars_epsilon=0.0))
    for a, b in zip(got, want):
        _close(a, b)
    # the port's plain LARS op agrees too
    mine = _call(tmx, "_fused_bucket_lars_update", [w, g, m, seg],
                 dict(p, lars_eta=0.001, lars_epsilon=0.0))
    for a, b in zip(mine, want):
        _close(a, b)


def test_pallas_bucket_ops_refuse_what_the_kernels_cannot_run():
    w, g, m, v, _ = _bucket(64, 4)
    with pytest.raises(MXNetError, match="_fused_bucket"):
        tmx.nd._pallas_bucket_adam_update(
            *[tmx.nd.array(a, dtype="float64") for a in (w, g, m, v)],
            lr=0.01)
    with pytest.raises(MXNetError, match="segments"):
        tmx.nd._pallas_bucket_lars_update(
            *[tmx.nd.array(a) for a in (w, g, m)],
            tmx.nd.array(onp.zeros(64, "int32")), lr=0.1,
            num_segments=t_po.MAX_SEGMENTS + 1)
