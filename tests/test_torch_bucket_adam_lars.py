"""The flat-bucket Adam and LARS updates (``ops/pallas_opt.py``,
``optimizer/optimizer.py``) and the LARS segment ids
(``parallel/zero.py``) held against the JAX package on the CPU.

The port's wrappers compute their plain version on a CPU tensor; the
reference runs its Pallas kernels in interpret mode.  Each is held
against its like: the port's kernel arm (``bucket_update``) against the
reference's kernel arm, the port's rule (``fused_bucket_update``)
against the reference's rule.  The two arms differ in both packages:
the reference's jitted Adam rule takes ``1 - beta`` from ``f32(beta)``
(0.100000024 for 0.9), its kernel from the Python float (0.1), and the
port keeps the difference.

Adam is not bit-exact against the reference on this CPU: XLA:CPU
contracts multiply-adds into FMAs (up to a quarter of the elements of m
and v differ, 0.3% of w's).  The allowance is 4 fp32 ulps (2^-21) of
the element's terms: ``|beta1*m| + (1-beta1)*(|g| + |wd*w|)`` for m,
the same with squares for v, and for w ``|w|`` plus the step and the
step's share of m's and v's allowances (measured: at most 1.0 of the 4,
in both arms).  ``lr_t`` is computed
on the host with numpy's float32 pow; it equals JAX's for every t
tested (the allowance is 0 ulps).

LARS: the reference's tolerance between its kernel and its rule, rtol
and atol 1e-6 (the per-segment norms are sums in other orders).  The
non-finite verdict and count, and the segment ids, are exact.
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.base import MXNetError as JMXNetError  # noqa: E402
from mxnet_tpu.ops import pallas_opt as j_po  # noqa: E402
from mxnet_tpu.optimizer import optimizer as j_opt  # noqa: E402
from mxnet_tpu.parallel import zero as j_zero  # noqa: E402

from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res  # noqa: E402
from mxnet_tpu_torch.ops import pallas_opt as t_po  # noqa: E402
from mxnet_tpu_torch.optimizer import optimizer as t_opt  # noqa: E402
from mxnet_tpu_torch.parallel import zero as t_zero  # noqa: E402

ULPS = 2.0 ** -21
LARS_TOL = dict(rtol=1e-6, atol=1e-6)


def _flat(n, seed, scale=1.0):
    return (onp.random.RandomState(seed).randn(n) * scale).astype("float32")


def _t(*arrays):
    return tuple(torch.from_numpy(onp.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


ADAM_CASES = {
    "plain": dict(learning_rate=0.01, wd=1e-4),
    "rescale_clip": dict(learning_rate=0.002, wd=1e-3, beta1=0.8,
                         beta2=0.99, epsilon=1e-6, rescale_grad=0.5,
                         clip_gradient=0.7),
}


def _adam_inputs(n, planted=()):
    w, g, m = _flat(n, 0), _flat(n, 1, 2.0), _flat(n, 2, 0.1)
    v = onp.abs(_flat(n, 3, 0.1))
    g[list(planted)] = [float(b) for b in ("nan", "inf", "-inf")[:len(
        planted)]]
    return w, g, m, v


def _adam_allowance(kw, t, w, g, m, v, new_m, new_v):
    """4 ulps of each output's terms (module docstring), in float64."""
    b1, b2 = kw.get("beta1", 0.9), kw.get("beta2", 0.999)
    gp = g.astype(onp.float64) * kw.get("rescale_grad", 1.0)
    if kw.get("clip_gradient") is not None:
        gp = onp.clip(gp, -kw["clip_gradient"], kw["clip_gradient"])
    a = onp.abs(gp) + abs(kw["wd"]) * onp.abs(w)
    terms_m = b1 * onp.abs(m) + (1 - b1) * a
    terms_v = b2 * onp.abs(v) + (1 - b2) * a * a
    lr_t = t_opt.adam_lr_t(kw["learning_rate"], b1, b2, t)
    den = onp.sqrt(new_v.astype(onp.float64)) + kw.get("epsilon", 1e-8)
    step = lr_t * onp.abs(new_m) / den
    terms_w = onp.abs(w) + step * (1 + terms_v / new_v) + \
        lr_t * terms_m / den
    return terms_w * ULPS, terms_m * ULPS, terms_v * ULPS


def _within(got, want, allow):
    got, want = onp.asarray(got), onp.asarray(want)
    return bool((onp.abs(got.astype(onp.float64) - want) <= allow).all())


@pytest.mark.parametrize("t", [1, 3, 1000])
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_matches_reference(case, n, t):
    kw = ADAM_CASES[case]
    jopt, topt = j_opt.Adam(**kw), t_opt.Adam(**kw)
    w, g, m, v = _adam_inputs(n)
    jw, g_j, jm, jv = _j(w, g, m, v)
    tw, g_t, tm, tv = _t(w, g, m, v)
    arms = {
        "kernel": (j_po.bucket_update(jopt, jw, g_j, (jm, jv),
                                      jnp.float32(t), with_finite=True,
                                      interpret=True),
                   t_po.bucket_update(topt, tw, g_t, (tm, tv), t,
                                      with_finite=True)),
        "rule": ((*jopt.fused_bucket_update(jw, g_j, (jm, jv), float(t)),
                  None),
                 (*topt.fused_bucket_update(tw, g_t, (tm, tv), t), None)),
    }
    for arm, (want, got) in arms.items():
        (ww, (wm, wv), wfin), (gw, (gm, gv), gfin) = want, got
        allow = _adam_allowance(kw, t, w, g, m, v, onp.asarray(wm),
                                onp.asarray(wv))
        for name, a, b, al in zip("wmv", (gw, gm, gv), (ww, wm, wv), allow):
            assert a.dtype == torch.float32
            assert _within(a.numpy(), b, al), (arm, name)
        assert (gfin is None) == (wfin is None)
        assert gfin is None or bool(gfin) is bool(wfin) is True
    # lr_t: numpy's float32 pow on the host, JAX's in the graph
    b1, b2 = kw.get("beta1", 0.9), kw.get("beta2", 0.999)
    want = kw["learning_rate"] * jnp.sqrt(1.0 - b2 ** jnp.float32(t)) / (
        1.0 - b1 ** jnp.float32(t))
    assert t_opt.adam_lr_t(kw["learning_rate"], b1, b2, t) == float(
        want.astype(jnp.float32))


def test_adam_arms_differ_as_in_the_reference():
    """``1 - beta``: f32(0.1) in both kernels, 1 - f32(0.9) in both
    rules, read off the first moment of a unit gradient."""
    w, g, m, v = onp.zeros(8, "f4"), onp.ones(8, "f4"), onp.zeros(8, "f4"), \
        onp.zeros(8, "f4")
    jopt, topt = j_opt.Adam(), t_opt.Adam()
    _, (jk, _), _ = j_po.bucket_update(jopt, *_j(w, g), _j(m, v), 1.0,
                                       interpret=True)
    _, (tk, _), _ = t_po.bucket_update(topt, *_t(w, g), _t(m, v), 1)
    _, (jr, _) = jopt.fused_bucket_update(*_j(w, g), _j(m, v), 1.0)
    _, (tr, _) = topt.fused_bucket_update(*_t(w, g), _t(m, v), 1)
    assert float(jk[0]) == float(tk[0]) == float(onp.float32(0.1))
    assert float(jr[0]) == float(tr[0]) == float(
        onp.float32(1) - onp.float32(0.9))


@pytest.mark.parametrize("planted", [(5,), (0, 700), (3, 500, 999)])
def test_adam_non_finite_verdict_and_count(planted):
    jopt, topt = j_opt.Adam(), t_opt.Adam()
    w, g, m, v = _adam_inputs(1000, planted)
    *_, jfin = j_po.bucket_update(jopt, *_j(w, g), _j(m, v), 2.0,
                                  with_finite=True, interpret=True)
    *_, tfin = t_po.bucket_update(topt, *_t(w, g), _t(m, v), 2,
                                  with_finite=True)
    assert bool(tfin) is bool(jfin) is False
    *_, nf = t_po.bucket_adam(*_t(w, g, m, v), lr_t=0.001, wd=0.0,
                              beta1=0.9, beta2=0.999, eps=1e-8,
                              with_finite=True)
    assert int(nf) == len(planted)


def _tiny_resnet_params():
    with t_nn.default_layout("NHWC"):
        net = t_res.ResNetV1(t_res.BottleneckV1, [1, 1, 1, 1],
                             [8, 16, 32, 64, 128], classes=10, no_bias=True,
                             prefix="resnetv10_")
    return {n: p._tensor() for n, p in net.collect_params().items()}


@pytest.mark.parametrize("bound", [2000, 30000, 10 ** 6])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_bucket_segments_match_reference(bound, n_shards):
    params = _tiny_resnet_params()
    tplan = t_zero.plan_buckets(params, n_shards, capacity=bound)
    jplan = j_zero.plan_buckets({n: jnp.zeros(v.shape) for n, v in
                                 params.items()}, n_shards, capacity=bound)
    assert len(tplan) == len(jplan) > 0
    for tb, jb in zip(tplan, jplan):
        tids, tn = t_zero.bucket_segments(tb)
        jids, jn = j_zero.bucket_segments(jb)
        assert tids.dtype == torch.int32 and tn == jn
        assert onp.array_equal(tids.numpy(), jids)


def _plan_segments(n_min):
    """A real bucket of the tiny ResNet (the first of its plan with at
    least ``n_min`` elements): ``(ids, nseg)``."""
    plan = t_zero.plan_buckets(_tiny_resnet_params(), 1, capacity=4000)
    b = next(b for b in plan if b.padded >= n_min and len(b.names) > 2)
    return t_zero.bucket_segments(b)


LARS_CASES = {
    "plan": dict(learning_rate=0.1, wd=1e-4, momentum=0.9),
    "rescale_clip": dict(learning_rate=2.0, wd=5e-5, momentum=0.9,
                         lars_eta=0.01, lars_epsilon=1e-9, rescale_grad=0.25,
                         clip_gradient=0.5),
}


def _lars_ids(kind, n, seed):
    if kind == "plan":
        ids, nseg = _plan_segments(1000)
        return ids.numpy(), nseg
    nseg = int(kind)
    rng = onp.random.RandomState(seed)
    return rng.randint(0, nseg, n).astype("int32"), nseg


@pytest.mark.parametrize("ids_kind,n", [("plan", None), ("5", 1000),
                                        ("96", 4099), ("128", 1000),
                                        ("128", 4099)])
@pytest.mark.parametrize("case", sorted(LARS_CASES))
def test_lars_matches_reference(case, ids_kind, n):
    kw = LARS_CASES[case]
    ids, nseg = _lars_ids(ids_kind, n, seed=len(ids_kind))
    n = len(ids)
    w, g, m = _flat(n, 4), _flat(n, 5, 0.01), _flat(n, 6, 0.001)
    if ids_kind == "5":
        g[ids == 3] = 0.0  # a segment with no gradient: trust 1
    jopt, topt = j_opt.LARS(**kw), t_opt.LARS(**kw)
    want_k = j_po.bucket_update(jopt, *_j(w, g), _j(m), 1.0,
                                seg=(ids, nseg), with_finite=True,
                                interpret=True)
    got_k = t_po.bucket_update(topt, *_t(w, g), _t(m), 1,
                               seg=(torch.from_numpy(ids), nseg),
                               with_finite=True)
    want_r = jopt.fused_bucket_update(*_j(w, g), _j(m), 1.0,
                                      seg_ids=jnp.asarray(ids),
                                      num_segments=nseg)
    got_r = topt.fused_bucket_update(*_t(w, g), _t(m), 1,
                                     seg_ids=torch.from_numpy(ids),
                                     num_segments=nseg)
    for want, got in ((want_k[:2], got_k[:2]), (want_r, got_r)):
        onp.testing.assert_allclose(got[0].numpy(), onp.asarray(want[0]),
                                    **LARS_TOL)
        onp.testing.assert_allclose(got[1][0].numpy(),
                                    onp.asarray(want[1][0]), **LARS_TOL)
    assert bool(got_k[2]) is bool(want_k[2]) is True


def test_lars_phases_and_verdict():
    """Phase (c) given phase (b)'s slr is the rule's update; the count
    of non-finite raw gradient elements is exact."""
    ids, nseg = _lars_ids("96", 2000, seed=7)
    w, g, m = _flat(2000, 8), _flat(2000, 9, 0.01), _flat(2000, 10)
    g[[1, 1000, 1999]] = [float("nan"), float("inf"), float("-inf")]
    tw, tg, tm, tids = _t(w, g, m, ids)
    h = dict(wd=1e-4, rescale=1.0, clip=None)
    slr, w_ss, g_ss, nf = t_po.bucket_lars_norms(
        tw, tg, tids, nseg, lr=0.1, eta=0.001, eps=0.0, with_finite=True,
        **h)
    assert int(nf) == 3 and slr.shape == (nseg,)
    want_ss = t_opt.segment_sum((tw * tw).double(), tids, nseg).float()
    assert torch.equal(w_ss, want_ss)
    new_w, new_m = t_po.bucket_lars_update(tw, tg, tm, tids, slr,
                                           momentum=0.9, **h)
    want = t_opt._lars_momentum(tw, tm, tg, slr[tids], 1e-4, 0.9)
    for a, b in zip((new_w, new_m), want):
        assert torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
    jopt = j_opt.LARS(momentum=0.9, learning_rate=0.1, wd=1e-4)
    *_, jfin = j_po.bucket_update(jopt, *_j(w, g), _j(m), 1.0,
                                  seg=(ids, nseg), with_finite=True,
                                  interpret=True)
    assert bool(jfin) is False


@pytest.mark.parametrize("rule", ["adam", "lars"])
def test_in_place_update_writes_the_given_buckets(rule):
    n = 700
    ids = torch.from_numpy(_lars_ids("5", n, seed=3)[0])
    opt = t_opt.Adam(wd=1e-4) if rule == "adam" else \
        t_opt.LARS(momentum=0.9, learning_rate=0.1)
    w, g = _t(_flat(n, 11), _flat(n, 12))
    state = tuple(torch.from_numpy(onp.abs(_flat(n, s)))
                  for s in range(13, 15 if rule == "adam" else 14))
    seg = (ids, 5) if rule == "lars" else None
    want_w, want_s, _ = t_po.bucket_update(
        opt, w.clone(), g, tuple(s.clone() for s in state), 2, seg=seg)
    new_w, new_s, _ = t_po.bucket_update(opt, w, g, state, 2, seg=seg,
                                         out=(w, *state))
    assert new_w is w and all(a is b for a, b in zip(new_s, state))
    assert torch.equal(w, want_w)
    assert all(torch.equal(a, b) for a, b in zip(state, want_s))


def test_supported_and_refusals():
    adam, lars = t_opt.Adam(), t_opt.LARS(momentum=0.9)
    assert t_po.supported(adam, torch.float32) is None
    assert t_po.supported(lars, torch.float32, nseg=128) is None
    assert "float32" in t_po.supported(adam, torch.bfloat16)
    assert "float32" in t_po.supported(lars, torch.bfloat16, nseg=5)
    assert "129 segments" in t_po.supported(lars, torch.float32, nseg=129)
    # the reference refuses the same
    assert j_po.supported(j_opt.Adam(), "bfloat16") is not None
    assert j_po.supported(j_opt.LARS(), "float32", nseg=129) is not None
    assert j_po.supported(j_opt.LARS(), "float32", nseg=128) is None
    w = torch.zeros(300, dtype=torch.bfloat16)
    assert t_po.bucket_update(adam, w, w, (w, w), 1) is None
    w32 = torch.zeros(300)
    ids = torch.zeros(300, dtype=torch.int32)
    # LARS without segment ids has no kernel form, as in the reference
    assert t_po.bucket_update(lars, w32, w32, (w32,), 1) is None
    assert t_po.bucket_update(lars, w32, w32, (w32,), 1,
                              seg=(ids, 129)) is None
    with pytest.raises(MXNetError, match="segments"):
        t_po.bucket_lars_norms(w32, w32, ids, 129, lr=0.1, wd=0.0,
                               eta=0.001, eps=0.0)
    with pytest.raises(MXNetError, match="int32"):
        t_po.bucket_lars_update(w32, w32, w32, ids.long(), torch.zeros(3),
                                wd=0.0, momentum=0.9)
    with pytest.raises(MXNetError, match="float32"):
        t_po.bucket_adam(w, w, w, w, lr_t=0.1, wd=0.0, beta1=0.9,
                         beta2=0.999, eps=1e-8)


def test_forced_kernel_arm_raises_where_it_cannot_run():
    """zero.bucket_shard_update with the kernel arm forced never falls
    back to the plain rule."""
    params = {"a_weight": torch.zeros(10, 3), "b_weight": torch.zeros(5)}
    (b,) = t_zero.plan_buckets(params, 1)
    seg = t_zero.bucket_segments(b)
    w = torch.zeros(b.padded, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="adam kernel supports float32"):
        t_zero.bucket_shard_update(b, t_opt.Adam(), None, w, (w, w), 1,
                                   n_shards=1, idx=0, pallas=True, w_sh=w)
    w32 = torch.zeros(b.padded)
    lars = t_opt.LARS(momentum=0.9)
    with pytest.raises(MXNetError, match="segment ids"):
        t_zero.bucket_shard_update(b, lars, None, w32, (w32,), 1,
                                   n_shards=1, idx=0, pallas=True,
                                   w_sh=w32)
    many = (torch.arange(b.padded, dtype=torch.int32) % 129, 129)
    with pytest.raises(MXNetError, match="129 segments"):
        t_zero.bucket_shard_update(b, lars, None, w32, (w32,), 1,
                                   n_shards=1, idx=0, seg=many, pallas=True,
                                   w_sh=w32)
    # the plain arm takes the segment ids as the rule's keywords
    g = torch.from_numpy(_flat(b.padded, 1))
    wr = torch.from_numpy(_flat(b.padded, 2))
    _, uw, (um,) = t_zero.bucket_shard_update(
        b, lars, None, g, (torch.zeros_like(wr),), 1, n_shards=1, idx=0,
        seg=seg, pallas=False, w_sh=wr)
    kw, (km,) = lars.fused_bucket_update(wr, g, (torch.zeros_like(wr),), 1,
                                         seg_ids=seg[0], num_segments=seg[1])
    assert torch.equal(uw, kw) and torch.equal(um, km)
    # the norms sum over the shards' processes: a world of one
    # (tests/test_torch_zero.py holds two against the reference)
    sw, (sm,) = lars.fused_bucket_update(wr, g, (torch.zeros_like(wr),), 1,
                                         seg_ids=seg[0],
                                         num_segments=seg[1],
                                         axis_name="data")
    assert torch.equal(sw, kw) and torch.equal(sm, km)


def test_check_bucket_rule():
    t_zero.check_bucket_rule(t_opt.SGD(momentum=0.9))
    t_zero.check_bucket_rule(t_opt.Adam())
    t_zero.check_bucket_rule(t_opt.LARS())
    not_elementwise = type("RowWise", (t_opt.Optimizer,),
                           {"fused_elementwise": False})()
    with pytest.raises(MXNetError, match="no fused_bucket_update"):
        t_zero.check_bucket_rule(not_elementwise)
    with pytest.raises(JMXNetError, match="no fused_bucket_update"):
        j_zero.check_bucket_rule(type("RowWise", (j_opt.Optimizer,),
                                      {"fused_elementwise": False})())
