"""The fused flat-bucket SGD update (``ops/pallas_opt.py``) and the
bucket layout (``parallel/zero.py``) held against the JAX package on
the CPU.

The port's wrappers compute their plain version on a CPU tensor; the
reference runs its Pallas kernels in interpret mode.  The non-finite
verdict, the loss-scale bookkeeping and the bucket layout are exact.

fp32 SGD and SGD-momentum are not bit-exact against the reference on
this CPU: XLA:CPU contracts ``w - lr*t`` and ``momentum*m - lr*t`` into
fused multiply-adds, which skip up to two roundings that PyTorch (one
rounded operation per kernel, the port's plain version and its CUDA
kernel alike) performs; about 20% of the elements differ.  The
allowance is therefore 8 fp32 ulps (2^-21) of the element's terms,
``|w| + |momentum*m| + |lr*(g + wd*w)|`` (measured: at most 3.5).  The
port's own promise is bit-exactness of its kernel against its plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

bf16 buckets: XLA may also keep an intermediate in fp32 (excess
precision) where PyTorch rounds every operation to bf16, so results may
differ by one bf16 ulp of the value.
"""
import dataclasses

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_opt as j_po  # noqa: E402
from mxnet_tpu.optimizer.optimizer import SGD as JSGD  # noqa: E402
from mxnet_tpu.parallel import zero as j_zero  # noqa: E402

from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import pallas_opt as t_po  # noqa: E402
from mxnet_tpu_torch.optimizer import Optimizer  # noqa: E402
from mxnet_tpu_torch.optimizer import SGD as TSGD  # noqa: E402
from mxnet_tpu_torch.parallel import zero as t_zero  # noqa: E402


def _flat(n, seed, scale=1.0):
    return (onp.random.RandomState(seed).randn(n) * scale).astype("float32")


def _both(**kw):
    return JSGD(**kw), TSGD(**kw)


def _j_update(opt, w, g, state, with_finite=True):
    return j_po.bucket_update(opt, jnp.asarray(w), jnp.asarray(g),
                              tuple(jnp.asarray(s) for s in state), 1.0,
                              with_finite=with_finite, interpret=True)


def _t_update(opt, w, g, state, with_finite=True):
    return t_po.bucket_update(opt, torch.from_numpy(w), torch.from_numpy(g),
                              tuple(torch.from_numpy(s) for s in state),
                              1.0, with_finite=with_finite)


SGD_CASES = {
    "momentum": dict(momentum=0.9, learning_rate=0.1, wd=1e-4),
    "momentum_rescale_clip": dict(momentum=0.9, learning_rate=0.05,
                                  wd=1e-3, rescale_grad=0.5,
                                  clip_gradient=0.3),
    "no_momentum": dict(momentum=0.0, learning_rate=0.1, wd=1e-4),
    "no_momentum_clip": dict(momentum=0.0, learning_rate=0.2,
                             clip_gradient=0.1),
}


def _assert_fp32_close(got, want, w, g, m, kw):
    """Within 2^-21 of the element's terms (the FMA allowance above)."""
    gp = g * kw.get("rescale_grad", 1.0)
    if kw.get("clip_gradient") is not None:
        gp = onp.clip(gp, -kw["clip_gradient"], kw["clip_gradient"])
    terms = onp.abs(w) + onp.abs(kw["learning_rate"]
                                 * (gp + kw.get("wd", 0.0) * w))
    if m is not None:
        terms = terms + onp.abs(kw["momentum"] * m)
    diff = onp.abs(onp.asarray(got) - onp.asarray(want))
    assert (diff <= terms * 2.0 ** -21).all(), float((diff / terms).max())


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_fp32_bucket_update_matches_reference(case, n):
    kw = SGD_CASES[case]
    jopt, topt = _both(**kw)
    w, g, m = _flat(n, 0), _flat(n, 1, 3.0), _flat(n, 2)
    state = (m,) if jopt.momentum else ()
    jw, js, jfin = _j_update(jopt, w, g, state)
    tw, ts, tfin = _t_update(topt, w, g, state)
    mm = m if jopt.momentum else None
    _assert_fp32_close(tw.numpy(), jw, w, g, mm, kw)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        _assert_fp32_close(a.numpy(), b, w, g, mm, kw)
    assert bool(tfin) is bool(jfin) is True
    # the port's bucket rule and its per-tensor rule agree bit for bit
    pw, ps = topt.fused_update(torch.from_numpy(w), torch.from_numpy(g),
                               tuple(torch.from_numpy(s) for s in state),
                               1.0)
    assert torch.equal(pw, tw) and all(torch.equal(a, b)
                                       for a, b in zip(ps, ts))


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_non_finite_verdict_matches_reference(bad):
    jopt, topt = _both(momentum=0.9, learning_rate=0.1)
    w, g, m = _flat(777, 3), _flat(777, 4), _flat(777, 5)
    g[[0, 400, 776]] = float(bad)
    _, _, jfin = _j_update(jopt, w, g, (m,))
    tw, (tm,), tfin = _t_update(topt, w, g, (m,))
    assert bool(tfin) is bool(jfin) is False
    _, _, nf = t_po._sgd_reference(torch.from_numpy(w), torch.from_numpy(g),
                                   torch.from_numpy(m), 0.1, 0.0, 0.9, 1.0,
                                   None, True)
    assert int(nf) == 3
    _, _, none = _t_update(topt, w, g, (m,), with_finite=False)
    assert none is None


def test_momentum_zero_passes_state_through():
    """Momentum zeroed live: a stale slot passes through untouched."""
    jopt, topt = _both(momentum=0.0, learning_rate=0.1)
    w, g, stale = _flat(300, 6), _flat(300, 7), _flat(300, 8)
    jw, js, _ = _j_update(jopt, w, g, (stale,))
    tw, ts, _ = _t_update(topt, w, g, (stale,))
    _assert_fp32_close(tw.numpy(), jw, w, g, None,
                       dict(momentum=0.0, learning_rate=0.1))
    assert onp.array_equal(ts[0].numpy(), stale)
    assert onp.array_equal(onp.asarray(js[0]), stale)


def test_in_place_update_writes_the_given_buckets():
    topt = TSGD(momentum=0.9, learning_rate=0.1, wd=1e-4)
    w, g, m = (torch.from_numpy(_flat(500, s)) for s in (9, 10, 11))
    want_w, (want_m,), _ = t_po.bucket_update(topt, w.clone(), g,
                                              (m.clone(),), 1.0)
    new_w, (new_m,), _ = t_po.bucket_update(topt, w, g, (m,), 1.0,
                                            out=(w, m))
    assert new_w is w and new_m is m
    assert torch.equal(w, want_w) and torch.equal(m, want_m)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_bf16_bucket_within_one_ulp(momentum):
    """bf16 w/m, fp32 raw gradient (the ps step's unscaled shard)."""
    jopt, topt = _both(momentum=momentum, learning_rate=0.1, wd=1e-3)
    n = 2000
    jw = jnp.asarray(_flat(n, 12), jnp.bfloat16)
    jm = jnp.asarray(_flat(n, 13), jnp.bfloat16)
    g = _flat(n, 14)
    jstate = (jm,) if momentum else ()
    j_new_w, j_new_s, jfin = j_po.bucket_update(
        jopt, jw, jnp.asarray(g), jstate, 1.0, with_finite=True,
        interpret=True)
    tw = torch.from_numpy(onp.array(jw.astype(jnp.float32))).bfloat16()
    tm = torch.from_numpy(onp.array(jm.astype(jnp.float32))).bfloat16()
    t_new_w, t_new_s, tfin = t_po.bucket_update(
        topt, tw, torch.from_numpy(g), (tm,) if momentum else (), 1.0,
        with_finite=True)
    assert t_new_w.dtype == torch.bfloat16 and bool(tfin) is bool(jfin)
    pairs = [(t_new_w, j_new_w)] + list(zip(t_new_s, j_new_s))
    for got, want in pairs:
        got = got.float().numpy()
        want = onp.asarray(want.astype(jnp.float32))
        assert (onp.abs(got - want) <= onp.abs(want) * 2.0 ** -7).all()


@pytest.mark.parametrize("seq", [
    [True, True, True, False, True, True],
    [False, False, True],
    [True] * 7,
])
def test_scale_bookkeeping_matches_reference(seq):
    js, jg = jnp.float32(2.0 ** 16), jnp.zeros((), jnp.int32)
    ts, tg = torch.tensor(2.0 ** 16), torch.zeros((), dtype=torch.int32)
    for finite in seq:
        js, jg = j_po.scale_bookkeeping(jnp.asarray(finite), js, jg,
                                        growth_interval=3)
        ts, tg = t_po.scale_bookkeeping(torch.tensor(finite), ts, tg,
                                        growth_interval=3)
        assert float(ts) == float(js) and int(tg) == int(jg)
        assert ts.dtype == torch.float32


def test_supported_and_forced_arm_refusal():
    assert t_po.supported(TSGD(momentum=0.9), torch.float32) is None
    assert t_po.supported(TSGD(), torch.bfloat16) is None
    assert "float16" in t_po.supported(TSGD(), torch.float16)
    # a rule without a bucket kernel: the forced kernel arm raises
    opt = type("Ftml", (Optimizer,), {})()
    assert t_po.supported(opt, torch.float32) == "no bucket kernel for Ftml"
    plan = t_zero.plan_buckets({"a_weight": torch.zeros(4)}, 1)
    w = torch.zeros(4)
    with pytest.raises(MXNetError, match="no bucket kernel for Ftml"):
        t_zero.bucket_shard_update(plan[0], opt, None, w, (), 1.0,
                                   n_shards=1, idx=0, pallas=True, w_sh=w)
    assert t_po.bucket_update(TSGD(), torch.zeros(4, dtype=torch.float16),
                              torch.zeros(4), (), 1.0) is None


def _tree(shapes, seed=0):
    rng = onp.random.RandomState(seed)
    return {n: rng.randn(*s).astype("float32") for n, s in shapes}


@pytest.mark.parametrize("capacity", [1, 50, 130, 10 ** 6])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_plan_and_flat_layout_match_reference(capacity, n_shards):
    shapes = [("c_weight", (4, 3, 3, 2)), ("c_gamma", (4,)),
              ("d_weight", (10, 7)), ("d_bias", (10,)),
              ("e_running_mean", (33,))]
    tree = _tree(shapes)
    jplan = j_zero.plan_buckets({n: jnp.asarray(v) for n, v in
                                 tree.items()}, n_shards, capacity)
    tplan = t_zero.plan_buckets({n: torch.from_numpy(v) for n, v in
                                 tree.items()}, n_shards, capacity)
    assert [dataclasses.astuple(b) for b in tplan] == \
        [dataclasses.astuple(b) for b in jplan]
    for tb, jb in zip(tplan, jplan):
        tf = t_zero.flatten_bucket(tb, {n: torch.from_numpy(v)
                                        for n, v in tree.items()})
        jf = j_zero.flatten_bucket(jb, {n: jnp.asarray(v)
                                        for n, v in tree.items()})
        assert onp.array_equal(tf.numpy(), onp.asarray(jf))
        back = t_zero.unflatten_bucket(tb, tf)
        for n in tb.names:
            assert onp.array_equal(back[n].numpy(), tree[n])
            # views: an in-place bucket update reaches the parameter
            assert back[n].untyped_storage().data_ptr() == \
                tf.untyped_storage().data_ptr()


def test_bucket_variant_resolution(monkeypatch, tmp_path):
    """A force scope, then MXNET_PALLAS_OPT, then (on the host, nothing
    cached) undecided: the call-time consult, whose default is the plain
    arm."""
    monkeypatch.delenv("MXNET_PALLAS_OPT", raising=False)
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    t_at.cache_clear()
    plan = t_zero.plan_buckets({"w": torch.zeros(10)}, 1)
    opt = TSGD(momentum=0.9)

    def resolve():
        return t_zero.resolve_bucket_variant(opt, plan, platform="cpu")

    assert resolve() is None
    assert bool(t_at.variant_choice("fused_bucket_opt")) is False
    with t_at.force(fused_bucket_opt=True):
        assert resolve() is True
    monkeypatch.setenv("MXNET_PALLAS_OPT", "1")
    assert resolve() is True
    with t_at.force(fused_bucket_opt=False):
        assert resolve() is False
    monkeypatch.setenv("MXNET_PALLAS_OPT", "0")
    assert resolve() is False
    t_at.cache_clear()
