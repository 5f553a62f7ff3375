"""The port's eager optimizer rules, ``multi_precision`` and learning-rate
schedulers held against the JAX package on the CPU.

Each rule runs five updates through an ``Updater`` on the same weights
and gradients (numpy, from a seed) in both packages: plain, with weight
decay, gradient clipping and ``rescale_grad``, and with a parameter's
``lr_mult``/``wd_mult``.  fp32 weights and states are held to 1e-6 of
each tensor's largest magnitude: XLA:CPU contracts ``a*b + c`` into
fused multiply-adds that PyTorch rounds twice (see
``test_torch_pallas_opt.py``), so a few elements differ in the last
bits; over five updates the measured error is at most 7.8e-7 (centered
RMSProp, whose ``n - gavg*gavg`` cancels), 5.3e-7 for Signum and at
most 2.2e-7 for the other rules.  Against
the port's own fused rule (``fused_update``, what ``make_train_step``
runs) the eager update is bit-exact.

bf16 weights under ``multi_precision``: the fp32 master and the state
are held as above, and the bf16 weight must be the master rounded to
bf16, bit for bit, in the port, and within one bf16 ulp of the
reference's.

Schedulers: the learning rate over 200 updates equals the reference's
exactly (the same Python arithmetic).
"""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from mxnet_tpu import lr_scheduler as j_lrs  # noqa: E402
from mxnet_tpu import nd as j_nd  # noqa: E402
from mxnet_tpu.optimizer import optimizer as j_opt  # noqa: E402

from mxnet_tpu_torch import cpu as t_cpu  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as t_lrs  # noqa: E402
from mxnet_tpu_torch import nd as t_nd  # noqa: E402
from mxnet_tpu_torch import optimizer as t_opt  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

RULES = {
    "sgd": ("sgd", dict(learning_rate=0.1)),
    "sgd_momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9)),
    "adam": ("adam", dict(learning_rate=0.01)),
    "adamw": ("adamw", dict(learning_rate=0.01, eta=0.5)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, clip_weights=0.9)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01,
                                         centered=True, gamma2=0.8)),
    "adagrad": ("adagrad", dict(learning_rate=0.1)),
    "signum": ("signum", dict(learning_rate=0.01, momentum=0.9,
                              wd_lh=0.01)),
    "signum_no_momentum": ("signum", dict(learning_rate=0.01,
                                          momentum=0.0, wd_lh=0.01)),
    "lars": ("lars", dict(learning_rate=0.5, momentum=0.9, lars_eta=0.01)),
    "test": ("test", dict()),
    "adadelta": ("adadelta", dict(rho=0.9, epsilon=1e-5)),
    "adamax": ("adamax", dict(learning_rate=0.01)),
    "nadam": ("nadam", dict(learning_rate=0.01)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    "ftml": ("ftml", dict(learning_rate=0.01)),
    "lbsgd": ("lbsgd", dict(learning_rate=0.1, momentum=0.9)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
}
CONFIGS = {
    "plain": dict(),
    "wd_clip_rescale": dict(wd=1e-2, clip_gradient=0.5, rescale_grad=0.5),
    "mult": dict(wd=1e-2),
}
UPDATES = 5
TOL = 1e-6
SHAPES = [(16, 9), (33,)]


class _Mult:
    """A stand-in for a Parameter in ``param_dict``: its multipliers."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult


def _optimizers(rule, config, **extra):
    name, kw = RULES[rule]
    kw = dict(kw, **CONFIGS[config], **extra)
    if config == "mult":
        # index 0 takes multipliers; index 1 keeps the defaults
        kw["param_dict"] = {0: _Mult(0.5, 3.0)}
    return j_opt.create(name, **kw), t_opt.create(name, **kw)


def _data(seed, dtype="float32"):
    rng = onp.random.RandomState(seed)
    ws = [rng.randn(*s).astype("float32") for s in SHAPES]
    gs = [[rng.randn(*s).astype("float32") * 0.3 for s in SHAPES]
          for _ in range(UPDATES)]
    return ws, gs


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(),
                                                 1e-30))


def _flat_states(states):
    out = []
    for s in states:
        if isinstance(s, (tuple, list)):
            out.extend(_flat_states(s))
        else:
            out.append(s.asnumpy())
    return out


def _run(rule, config, dtype="float32", **extra):
    """Five updates of two parameters in both packages: (reference,
    port) weights and flattened states after each update."""
    jopt, topt = _optimizers(rule, config, **extra)
    ju, tu = j_opt.get_updater(jopt), t_opt.get_updater(topt)
    ws, gs = _data(7)
    jw = [j_nd.array(w, dtype=dtype) for w in ws]
    tw = [t_nd.array(w, dtype=dtype) for w in ws]
    trace = []
    for step in range(UPDATES):
        for i in range(len(ws)):
            ju(i, j_nd.array(gs[step][i], dtype=dtype), jw[i])
            tu(i, t_nd.array(gs[step][i], dtype=dtype), tw[i])
        trace.append(([w.asnumpy() for w in jw],
                      [w.asnumpy() for w in tw],
                      [_flat_states(ju.states[i]) for i in range(2)],
                      [_flat_states(tu.states[i]) for i in range(2)]))
    return trace, (jopt, topt, ju, tu, jw, tw)


@pytest.fixture(autouse=True)
def _host():
    """The port's arrays default to the card: these tests run on the
    host."""
    with t_cpu():
        yield


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("rule", list(RULES))
def test_eager_rule_matches_reference(rule, config):
    trace, (jopt, topt, *_rest) = _run(rule, config)
    for step, (jw, tw, js, ts) in enumerate(trace):
        for i in range(len(jw)):
            assert _rel(tw[i], jw[i]) <= TOL, (step, i)
            assert len(js[i]) == len(ts[i])
            for a, b in zip(ts[i], js[i]):
                assert _rel(a, b) <= TOL, (step, i)
    # the reference's Test rule counts no update
    assert topt.num_update == jopt.num_update == (
        0 if rule == "test" else UPDATES)
    assert topt._index_update_count == jopt._index_update_count


@pytest.mark.parametrize("rule", list(RULES))
def test_eager_update_is_the_fused_rule(rule):
    """``update`` (per parameter, multipliers 1) and ``fused_update``
    (the fused step's rule) give the same bits, step count included."""
    _, topt = _optimizers(rule, "wd_clip_rescale")
    ws, gs = _data(3)
    w = torch.from_numpy(ws[0])
    arr = t_nd.array(ws[0])
    state = topt.create_state(0, arr)
    fused = topt.fused_state(w)
    for step in range(UPDATES):
        g = torch.from_numpy(gs[step][0])
        topt.update(0, arr, t_nd.array(gs[step][0]), state)
        w, fused = topt.fused_update(w, g, fused, step + 1)
        assert torch.equal(arr._data, w), step
        for s, f in zip(state, fused):
            assert torch.equal(s._data, f), step


MP_RULES = ["sgd_momentum", "adam", "lars", "adadelta", "adamax", "nadam",
            "ftrl", "ftml", "lbsgd", "dcasgd"]


@pytest.mark.parametrize("rule", MP_RULES)
def test_multi_precision_bf16_matches_reference(rule):
    """bf16 weights with multi_precision: an fp32 master and fp32
    states, held to the reference; the weight is the master rounded to
    bf16."""
    trace, (jopt, topt, ju, tu, jw, tw) = _run(
        rule, "wd_clip_rescale", dtype="bfloat16", multi_precision=True)
    for i in range(len(SHAPES)):
        master, state = tu.states[i]
        assert master._data.dtype == torch.float32
        assert all(s._data.dtype == torch.float32 for s in state)
        assert tw[i]._data.dtype == torch.bfloat16
        assert torch.equal(tw[i]._data, master._data.to(torch.bfloat16))
    for step, (jwn, twn, js, ts) in enumerate(trace):
        for i in range(len(SHAPES)):
            for a, b in zip(ts[i], js[i]):  # master, then the state
                assert _rel(a, b) <= TOL, (step, i)
            ulp = onp.abs(jwn[i]) * 2.0 ** -7 + 1e-30
            assert onp.all(onp.abs(twn[i] - jwn[i]) <= ulp), (step, i)


def test_multi_precision_off_keeps_half_state():
    _, topt = _optimizers("sgd_momentum", "plain")
    arr = t_nd.array(onp.ones(4, "float32"), dtype="bfloat16")
    (mom,) = topt.create_state_multi_precision(0, arr)
    assert mom._data.dtype == torch.bfloat16


SCHEDULERS = {
    "factor": lambda m: m.FactorScheduler(step=7, factor=0.8,
                                          stop_factor_lr=1e-3,
                                          base_lr=0.1),
    "factor_warmup": lambda m: m.FactorScheduler(
        step=5, factor=0.9, base_lr=0.2, warmup_steps=20,
        warmup_begin_lr=0.01),
    "multifactor": lambda m: m.MultiFactorScheduler(
        step=[10, 40, 90], factor=0.5, base_lr=0.3),
    "poly": lambda m: m.PolyScheduler(max_update=150, base_lr=0.1, pwr=2,
                                      final_lr=1e-4, warmup_steps=10),
    "cosine": lambda m: m.CosineScheduler(
        max_update=120, base_lr=0.5, final_lr=0.01, warmup_steps=15,
        warmup_begin_lr=0.05, warmup_mode="constant"),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    js, ts = SCHEDULERS[name](j_lrs), SCHEDULERS[name](t_lrs)
    want = [js(n) for n in range(200)]
    assert [ts(n) for n in range(200)] == want
    # through an optimizer: the learning rate follows the update count
    jopt = j_opt.SGD(learning_rate=0.1, lr_scheduler=SCHEDULERS[name](
        j_lrs))
    topt = t_opt.SGD(learning_rate=0.1, lr_scheduler=SCHEDULERS[name](
        t_lrs))
    for n in range(60):
        jopt._update_count(0)
        topt._update_count(0)
        assert topt.learning_rate == jopt.learning_rate, n
    with pytest.raises(MXNetError, match="already been defined"):
        topt.set_learning_rate(0.5)


def test_registry_and_refusals():
    """Every rule name of the reference resolves in the port, by any
    case; an unknown name raises as there."""
    assert sorted(t_opt.optimizer._REGISTRY) == sorted(j_opt._REGISTRY)
    for name in j_opt._REGISTRY:
        assert type(t_opt.create(name)).__name__.lower() == name
        assert type(t_opt.create(name.upper())).__name__.lower() == name
        assert type(j_opt.create(name)).__name__.lower() == name
    opt = t_opt.SGD(learning_rate=0.3)
    assert t_opt.create(opt) is opt
    from mxnet_tpu_torch.optimizer import contrib as t_contrib

    assert t_contrib.GroupAdaGrad is t_opt.GroupAdaGrad
    with pytest.raises(MXNetError, match="Cannot find optimizer"):
        t_opt.create("bogus")


def test_wd_mult_by_name_matches_reference():
    """Without a param_dict, names pick the multipliers: weight decay
    applies to ``*_weight`` and ``*_gamma`` only."""
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma", 3: "bn_beta"}
    jopt = j_opt.SGD(wd=0.1, param_idx2name=names)
    topt = t_opt.SGD(wd=0.1, param_idx2name=names)
    topt.set_lr_mult({"fc_bias": 2.0})
    jopt.set_lr_mult({"fc_bias": 2.0})
    for i in names:
        assert topt._get_wd(i) == jopt._get_wd(i)
        assert topt._get_lr(i) == jopt._get_lr(i)


def test_updater_states_round_trip_keep_dtype_and_device():
    """get_states/set_states pickles the states through the host; a
    bf16 state comes back bf16, and each goes back to its weight's
    device at the next update."""
    _, topt = _optimizers("sgd_momentum", "plain")
    u = t_opt.get_updater(topt)
    w = t_nd.array(onp.ones(6, "float32"), dtype="bfloat16")
    u(0, t_nd.array(onp.full(6, 0.5, "float32"),
                    dtype="bfloat16"), w)
    blob = u.get_states(dump_optimizer=True)
    v = t_opt.get_updater(t_opt.SGD())
    v.set_states(blob)
    assert v.optimizer.momentum == 0.9 and v.states_synced == {0: False}
    (mom,) = v.states[0]
    assert mom._data.dtype == torch.bfloat16
    assert torch.equal(mom._data, u.states[0][0]._data)


def _three_steps(jopt, topt, ws, gs, dtype="float32"):
    ju, tu = j_opt.get_updater(jopt), t_opt.get_updater(topt)
    jw = [j_nd.array(w, dtype=dtype) for w in ws]
    tw = [t_nd.array(w, dtype=dtype) for w in ws]
    for step in range(3):
        for i in range(len(ws)):
            ju(i, j_nd.array(gs[step][i], dtype=dtype), jw[i])
            tu(i, t_nd.array(gs[step][i], dtype=dtype), tw[i])
        for i in range(len(ws)):
            assert _rel(tw[i].asnumpy(), jw[i].asnumpy()) <= TOL, (step, i)
            for a, b in zip(_flat_states(tu.states[i]),
                            _flat_states(ju.states[i])):
                assert _rel(a, b) <= TOL, (step, i)
    return ju, tu


@pytest.mark.parametrize("config", ["plain", "clip_rescale"])
def test_group_adagrad_matches_reference(config):
    """GroupAdaGrad: one history per row of a 2- or 3-dim weight; it
    refuses weight decay and a 1-dim weight, as the reference does."""
    kw = dict(learning_rate=0.1) if config == "plain" else dict(
        learning_rate=0.1, clip_gradient=0.5, rescale_grad=0.5)
    rng = onp.random.RandomState(11)
    shapes = [(6, 5), (4, 3, 2)]
    ws = [rng.randn(*s).astype("float32") for s in shapes]
    gs = [[rng.randn(*s).astype("float32") for s in shapes]
          for _ in range(3)]
    _, tu = _three_steps(j_opt.create("groupadagrad", **kw),
                         t_opt.create("groupadagrad", **kw), ws, gs)
    assert tuple(tu.states[1][0].shape) == (4, 1, 1)
    with pytest.raises(AssertionError, match="weight decay"):
        t_opt.get_updater(t_opt.GroupAdaGrad(wd=0.1))(
            0, t_nd.array(gs[0][0]), t_nd.array(ws[0]))
    with pytest.raises(AssertionError, match="2-dim"):
        t_opt.GroupAdaGrad().create_state(0, t_nd.array(onp.ones(3)))


def test_sgld_rule_and_noise():
    """SGLD's drift equals the reference's with the noise set to 0 in
    both; its noise has variance ``lr`` and repeats under one seed."""
    from mxnet_tpu_torch import random as t_random
    from mxnet_tpu_torch.optimizer import optimizer as t_optmod

    ws, gs = _data(5)
    kw = dict(learning_rate=0.05, wd=1e-2, rescale_grad=0.5,
              clip_gradient=0.4)
    zero_j = lambda loc, scale, shape, dtype: j_nd.zeros(shape,
                                                          dtype=dtype)
    j_ndmod = j_opt.nd
    zero_t = lambda shape, std, dtype, device, gen: torch.zeros(
        shape, dtype=dtype, device=device)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(j_ndmod, "random_normal", zero_j)
        m.setattr(t_optmod, "sgld_noise", zero_t)
        _three_steps(j_opt.create("sgld", **kw), t_opt.create("sgld", **kw),
                     ws, gs)
    lr = 0.04
    draws = []
    for _ in range(2):
        t_random.seed(5)
        w = t_nd.zeros((200, 200))
        t_opt.create("sgld", learning_rate=lr).update(
            0, w, t_nd.zeros((200, 200)), ())
        draws.append(w.asnumpy())
    assert onp.array_equal(draws[0], draws[1])
    assert abs(draws[0].mean()) < 0.01
    assert abs(draws[0].var() / lr - 1.0) < 0.05
    # the fused rule draws from its key's generator
    opt = t_opt.create("sgld", learning_rate=lr)
    a, _ = opt.fused_update(torch.zeros(64), torch.zeros(64), (), 1, key=3)
    b, _ = opt.fused_update(torch.zeros(64), torch.zeros(64), (), 1, key=3)
    c, _ = opt.fused_update(torch.zeros(64), torch.zeros(64), (), 1, key=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(MXNetError, match="needs a PRNG key"):
        opt.fused_update(torch.zeros(4), torch.zeros(4), (), 1)


def test_new_rules_keep_reference_state_layout():
    """Each rule's state: the reference's count and shapes, Nadam's
    fused third slot and DCASGD's copy of the weight."""
    w = onp.arange(6, dtype="float32").reshape(2, 3)
    for name in ("adadelta", "adamax", "nadam", "ftrl", "ftml", "dcasgd",
                 "test", "sgld", "lbsgd", "groupadagrad"):
        js = j_opt.create(name).create_state(0, j_nd.array(w))
        ts = t_opt.create(name).create_state(0, t_nd.array(w))
        assert [tuple(s.shape) for s in ts] == [tuple(s.shape) for s in js]
        for a, b in zip(ts, js):
            assert onp.array_equal(a.asnumpy(), b.asnumpy()), name
    fused = t_opt.create("nadam").fused_state(torch.zeros(3))
    assert len(fused) == 3 and float(fused[2]) == 1.0
