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
    assert topt.num_update == jopt.num_update == UPDATES
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


MP_RULES = ["sgd_momentum", "adam", "lars"]


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
    for name in ("sgd", "nag", "signum", "adam", "adamw", "adagrad",
                 "rmsprop", "lars"):
        assert type(t_opt.create(name)).__name__.lower() == name
        assert type(j_opt.create(name)).__name__.lower() == name
    opt = t_opt.SGD(learning_rate=0.3)
    assert t_opt.create(opt) is opt
    for name in ("adadelta", "adamax", "nadam", "ftrl", "ftml", "sgld"):
        with pytest.raises(MXNetError, match="Cannot find optimizer"):
            t_opt.create(name)
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
