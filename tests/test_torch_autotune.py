"""The in-step variant races held against the JAX package on the CPU.

- The knobs (``MXNET_DTYPE_LADDER``, ``MXNET_CONV_1X1_DOT``): the port's
  ``_parse_ladder``, ``ladder_rungs``, ``dtype_ladder_armed`` and
  ``variant_choice`` equal the reference's for a table of strings, and
  the precedence force > env > ``program_scope`` > default is the
  reference's.
- The cache: ``autotune.json``'s keys and entry fields equal the
  reference's for the same (op, shape, dtype, platform, mesh); a winner
  recorded by one process is seen by another; ``record`` merges; and
  ``mesh_desc`` of the one-card mesh is the reference's of a one-device
  mesh.
- The rosters: on ``cuda`` each race drops exactly the arms that compute
  a hand-written kernel's plain version, and ``program_scope`` there
  ignores a cached winner among them; on the CPU they are the
  reference's.
- ``parallel.zero.resolve_bucket_variant``: the port's answer on the CPU
  is the reference's in each case; on ``cuda`` what stays undecided is
  the kernel wherever the kernels take the rule.
- ``make_train_step`` races in the step on the CPU: ``conv1x1_dot``
  {conv, dot} with a rebuild that reloads and times nothing, the
  ladder only when armed, an explicit ``compute_dtype`` off the roster,
  a cached fp8 winner only under a roster that names fp8, a reload in
  another process, and ``sample_data`` under a mesh warns.
- ``conv1x1_dot``: the dot arm equals the conv arm and the reference's
  dot arm to 1e-5 (fp32, NHWC, strides 1 and 2).
- ``program_scope`` at the other entry points: a winner recorded for a
  hybridized block's signature makes the block take the fused
  BN-ReLU-conv op, and one recorded for a ``Module``'s data makes its
  executor take the dot arm, with no force scope, as the reference's do
  on the same recorded cache.
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import gluon as j_gluon  # noqa: E402
from mxnet_tpu import parallel as j_par  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.ops import conv as j_conv  # noqa: E402
from mxnet_tpu.optimizer import optimizer as j_opt  # noqa: E402
from mxnet_tpu.parallel import zero as j_zero  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import gluon as t_gluon  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.ops import conv as t_conv  # noqa: E402
from mxnet_tpu_torch.optimizer import optimizer as t_opt  # noqa: E402
from mxnet_tpu_torch.parallel import zero as t_zero  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("MXNET_DTYPE_LADDER", "MXNET_CONV_1X1_DOT", "MXNET_PALLAS_OPT",
          "MXNET_BNRELUCONV_VARIANT", "MXNET_AUTOTUNE",
          "MXNET_FUSED_BNRELUCONV", "MXNET_FLASH_ATTENTION")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' autotune caches in one fresh directory, every knob
    of the races unset."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    j_at.cache_clear()
    t_at.cache_clear()
    yield tmp_path
    j_at.cache_clear()
    t_at.cache_clear()


@pytest.fixture
def two_caches(tmp_path, monkeypatch, caches):
    """``switch(pkg)`` points the cache dir at the package's own folder."""
    def switch(pkg):
        monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path / pkg))
        (j_at if pkg == "jax" else t_at).cache_clear()
        return tmp_path / pkg / "autotune.json"

    return switch


# ------------------------------------------------------------ the knobs
LADDER_VALUES = [None, "", "0", "off", "false", "1", "auto", "fp32",
                 "float32", "bf16", "bfloat16", "fp8", "float8", "e4m3",
                 "FP8", "fp32,bf16,fp8", "fp8, bf16", "fp32,bf16",
                 "bf16,bogus,fp8", "bogus"]


@pytest.mark.parametrize("raw", LADDER_VALUES)
def test_ladder_knob_matches_reference(raw, caches, monkeypatch):
    if raw is None:
        monkeypatch.delenv("MXNET_DTYPE_LADDER", raising=False)
    else:
        monkeypatch.setenv("MXNET_DTYPE_LADDER", raw)
        assert t_at._parse_ladder(raw) == j_at._parse_ladder(raw)
    assert t_at.ladder_rungs() == j_at.ladder_rungs()
    assert t_at.dtype_ladder_armed() == j_at.dtype_ladder_armed()
    assert t_at.variant_choice("dtype_ladder") == \
        j_at.variant_choice("dtype_ladder")
    assert t_at.op_variants("dtype_ladder", "cpu") == \
        j_at.op_variants("dtype_ladder")


@pytest.mark.parametrize("raw", [None, "0", "1", "true", "on", "no",
                                 "bogus"])
def test_conv1x1_dot_knob_matches_reference(raw, caches, monkeypatch):
    if raw is not None:
        monkeypatch.setenv("MXNET_CONV_1X1_DOT", raw)
    for default in (False, None):
        assert t_at.variant_choice("conv1x1_dot", default) == \
            j_at.variant_choice("conv1x1_dot", default)


def _precedence(at, monkeypatch):
    """The reference's ``test_decision_precedence`` as a list of the
    decisions it reads."""
    out = []
    at.record("conv1x1_dot", (4, 8, 8, 3), "float32", winner="dot",
              platform="cpu", mesh="none")
    with at.program_scope((4, 8, 8, 3), "float32", platform="cpu",
                          mesh="none"):
        out.append(at.variant_choice("conv1x1_dot", default=False))
        # a winner of another signature, platform or mesh does not apply
        out.append(at.variant_choice("pallas_bnreluconv"))
    for other in (((8, 8, 8, 3), "float32", "cpu", "none"),
                  ((4, 8, 8, 3), "bfloat16", "cpu", "none"),
                  ((4, 8, 8, 3), "float32", "tpu", "none"),
                  ((4, 8, 8, 3), "float32", "cpu", "data=1")):
        with at.program_scope(other[0], other[1], platform=other[2],
                              mesh=other[3]):
            out.append(at.variant_choice("conv1x1_dot", default=False))
    monkeypatch.setenv("MXNET_CONV_1X1_DOT", "0")
    with at.program_scope((4, 8, 8, 3), "float32", platform="cpu",
                          mesh="none"):
        out.append(at.variant_choice("conv1x1_dot", default=False))
        with at.force(conv1x1_dot=True):
            out.append(at.variant_choice("conv1x1_dot", default=False))
    monkeypatch.delenv("MXNET_CONV_1X1_DOT")
    monkeypatch.setenv("MXNET_AUTOTUNE", "0")
    with at.program_scope((4, 8, 8, 3), "float32", platform="cpu",
                          mesh="none"):
        out.append(at.variant_choice("conv1x1_dot", default=False))
    monkeypatch.delenv("MXNET_AUTOTUNE")
    return out


def test_decision_precedence_matches_reference(two_caches, monkeypatch):
    two_caches("jax")
    want = _precedence(j_at, monkeypatch)
    two_caches("torch")
    got = _precedence(t_at, monkeypatch)
    assert got == want == [True, None, False, False, False, False, False,
                           True, False]


# ------------------------------------------------------------ the cache
KEYS = [("conv1x1_dot", (4, 8, 8, 3), "float32", "cpu", "none", "dot"),
        ("pallas_bnreluconv", (128, 224, 224, 3), "bfloat16", "cuda",
         "data=1", "pallas"),
        ("dtype_ladder", (8, 6), "float32", "cpu", "none", "fp8"),
        ("fused_bucket_opt", (2359296,), "float32", "cpu", "data=1",
         "jnp")]


@pytest.mark.parametrize("key", KEYS, ids=[k[0] for k in KEYS])
def test_cache_file_matches_reference(key, two_caches):
    op, shape, dtype, platform, mesh, winner = key
    timings = {"a": 1.5, "b": 0.5}
    files = {}
    for pkg, at, dt in (("jax", j_at, jnp.dtype(dtype)),
                        ("torch", t_at, getattr(torch, dtype))):
        path = two_caches(pkg)
        at.record(op, shape, dt, winner=winner, timings=timings,
                  platform=platform, mesh=mesh)
        with open(path) as f:
            files[pkg] = json.load(f)
        assert at.lookup(op, shape, dt, platform=platform,
                         mesh=mesh) == winner
    assert files["torch"].keys() == files["jax"].keys()
    assert files["torch"]["version"] == files["jax"]["version"]
    (tk, tv), = files["torch"]["entries"].items()
    (jk, jv), = files["jax"]["entries"].items()
    assert tk == jk
    assert sorted(tv) == sorted(jv) == ["recorded", "timings", "winner"]
    assert (tv["winner"], tv["timings"]) == (jv["winner"], jv["timings"])


def test_winner_seen_by_another_process_and_record_merges(caches):
    t_at.record("conv1x1_dot", (2, 4, 4, 3), torch.float32, winner="dot",
                timings={"conv": 2.0, "dot": 1.0}, platform="cpu",
                mesh="none")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from mxnet_tpu_torch import autotune as at\n"
        "w = at.lookup('conv1x1_dot', (2, 4, 4, 3), 'float32',\n"
        "              platform='cpu', mesh='none')\n"
        "assert w == 'dot', w\n"
        "at.record('pallas_bnreluconv', (2, 4, 4, 3), 'float32',\n"
        "          winner='jnp', platform='cpu', mesh='none')\n"
        "print('child-ok')\n" % _REPO)
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "child-ok" in out.stdout
    # the child's record is seen here, and the parent's survived it
    assert t_at.lookup("pallas_bnreluconv", (2, 4, 4, 3), "float32",
                       platform="cpu", mesh="none") == "jnp"
    assert t_at.lookup("conv1x1_dot", (2, 4, 4, 3), "float32",
                       platform="cpu", mesh="none") == "dot"
    with open(t_at.cache_path()) as f:
        assert len(json.load(f)["entries"]) == 2


def test_mesh_desc_matches_reference():
    j_mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
    t_mesh = t_par.get_mesh(devices=["cpu"])
    assert t_at.mesh_desc(t_mesh) == j_at.mesh_desc(j_mesh) == "data=1"
    assert t_at.mesh_desc(None) == j_at.mesh_desc(None) == "none"


# ----------------------------------------------------------- the rosters
CARD_DROPS = {"fused_bucket_opt": {"jnp"}, "pallas_bnreluconv": {"jnp"},
              "flash_attention": {"naive"}}


@pytest.mark.parametrize("op", sorted(j_at.VARIANT_OPS))
def test_rosters_by_platform(op, caches, monkeypatch):
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp32,bf16,fp8")
    assert t_at.VARIANT_OPS[op] == j_at.VARIANT_OPS[op]
    ref = j_at.op_variants(op)
    assert t_at.op_variants(op, "cpu") == ref
    card = t_at.op_variants(op, "cuda")
    assert set(ref) - set(card) == CARD_DROPS.get(op, set())
    assert all(card[k] == ref[k] for k in card)


def test_card_program_scope_ignores_plain_winners(caches):
    sig = ((4, 8, 8, 3), "float32")
    for platform in ("cuda", "cpu"):
        t_at.record("pallas_bnreluconv", *sig, winner="jnp",
                    platform=platform, mesh="none")
        t_at.record("flash_attention", *sig, winner="naive",
                    platform=platform, mesh="none")
        t_at.record("conv1x1_dot", *sig, winner="dot", platform=platform,
                    mesh="none")
    with t_at.program_scope(*sig, platform="cuda", mesh="none"):
        assert t_at.variant_choice("pallas_bnreluconv") is None
        assert t_at.variant_choice("flash_attention") is None
        assert t_at.variant_choice("conv1x1_dot") is True
    with t_at.program_scope(*sig, platform="cpu", mesh="none"):
        assert t_at.variant_choice("pallas_bnreluconv") == "jnp"
        assert t_at.variant_choice("flash_attention") == "naive"
    # a force scope naming a plain arm stays the user's choice
    with t_at.force(pallas_bnreluconv="jnp"), \
            t_at.program_scope(*sig, platform="cuda", mesh="none"):
        assert t_at.variant_choice("pallas_bnreluconv") == "jnp"


# ------------------------------------------- resolve_bucket_variant
def _plans():
    """The same plan in both packages: three tensors, two buckets."""
    rng = onp.random.RandomState(0)
    arrays = {"a_weight": rng.randn(40, 30), "b_bias": rng.randn(30),
              "c_weight": rng.randn(50, 20)}
    j_plan = j_zero.plan_buckets(
        {n: jnp.asarray(a, jnp.float32) for n, a in arrays.items()}, 1,
        capacity=1300)
    t_plan = t_zero.plan_buckets(
        {n: torch.tensor(a, dtype=torch.float32) for n, a in arrays.items()},
        1, capacity=1300)
    return j_plan, t_plan


RULES = {"sgd": (j_opt.SGD, t_opt.SGD, dict(momentum=0.9)),
         "adam": (j_opt.Adam, t_opt.Adam, {}),
         "lars": (j_opt.LARS, t_opt.LARS, dict(momentum=0.9)),
         "nag": (j_opt.NAG, t_opt.NAG, dict(momentum=0.9))}
BUCKET_CASES = {
    "undecided": {},
    "force_pallas": dict(force=True),
    "force_jnp": dict(force=False),
    "env_1": dict(env="1"),
    "env_0": dict(env="0"),
    "autotune_off": dict(autotune="0"),
    "cached_pallas": dict(cached="pallas"),
    "cached_jnp": dict(cached="jnp"),
    "cached_stage3_read_at_2": dict(cached="pallas", cached_stage=3),
    "cached_stage3_read_at_3": dict(cached="pallas", cached_stage=3,
                                    stage=3),
    "cached_none_read_at_2": dict(cached="pallas", cached_stage=None,
                                  stage=2),
    "cached_other_mesh": dict(cached="pallas", cached_mesh="none"),
}


def _resolve(pkg, rule, case, monkeypatch):
    j_plan, t_plan = _plans()
    j_cls, t_cls, kw = RULES[rule]
    if pkg == "jax":
        at, zero, plan, opt = j_at, j_zero, j_plan, j_cls(**kw)
        mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
    else:
        at, zero, plan, opt = t_at, t_zero, t_plan, t_cls(**kw)
        mesh = t_par.get_mesh(devices=["cpu"])
    if "env" in case:
        monkeypatch.setenv("MXNET_PALLAS_OPT", case["env"])
    if "autotune" in case:
        monkeypatch.setenv("MXNET_AUTOTUNE", case["autotune"])
    if "cached" in case:
        shape, dtype = zero.flat_variant_key(plan, case.get("cached_stage"))
        at.record("fused_bucket_opt", shape, dtype, winner=case["cached"],
                  platform="cpu", mesh=case.get("cached_mesh", "data=1"))
    try:
        if "force" in case:
            with at.force(fused_bucket_opt=case["force"]):
                return zero.resolve_bucket_variant(opt, plan, mesh,
                                                   case.get("stage"))
        return zero.resolve_bucket_variant(opt, plan, mesh,
                                           case.get("stage"))
    finally:
        for k in ("MXNET_PALLAS_OPT", "MXNET_AUTOTUNE"):
            monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_resolve_bucket_variant_matches_reference(rule, case, two_caches,
                                                  monkeypatch):
    spec = BUCKET_CASES[case]
    two_caches("jax")
    want = _resolve("jax", rule, spec, monkeypatch)
    two_caches("torch")
    got = _resolve("torch", rule, spec, monkeypatch)
    assert got == want


UPDATER_CASES = ("undecided", "force_pallas", "env_0", "autotune_off",
                 "cached_pallas", "cached_jnp", "cached_other_mesh")


def _updater_decides(pkg, rule, case, monkeypatch):
    """The Module's sharded updater's lowering (``_decide_variant``) over
    ``_plans``' tensors on a one-device mesh."""
    rng = onp.random.RandomState(0)
    arrays = {"a_weight": rng.randn(40, 30), "b_bias": rng.randn(30),
              "c_weight": rng.randn(50, 20)}
    j_cls, t_cls, kw = RULES[rule]
    if pkg == "jax":
        at, zero, opt = j_at, j_zero, j_cls(**kw)
        mesh = jax.sharding.Mesh(onp.array(jax.devices()[:1]), ("data",))
        params = {n: jnp.asarray(a, jnp.float32) for n, a in arrays.items()}
    else:
        at, zero, opt = t_at, t_zero, t_cls(**kw)
        mesh = t_par.get_mesh(devices=["cpu"])
        params = {n: torch.tensor(a, dtype=torch.float32)
                  for n, a in arrays.items()}
    upd = zero.ShardedBucketUpdater(opt, mesh, params, capacity=1300)
    if "env" in case:
        monkeypatch.setenv("MXNET_PALLAS_OPT", case["env"])
    if "autotune" in case:
        monkeypatch.setenv("MXNET_AUTOTUNE", case["autotune"])
    if "cached" in case:
        shape, dtype = zero.flat_variant_key(upd.plan)
        at.record("fused_bucket_opt", shape, dtype, winner=case["cached"],
                  platform="cpu", mesh=case.get("cached_mesh", "data=1"))
    try:
        if "force" in case:
            with at.force(fused_bucket_opt=case["force"]):
                return upd._decide_variant()
        return upd._decide_variant()
    finally:
        for k in ("MXNET_PALLAS_OPT", "MXNET_AUTOTUNE"):
            monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("case", UPDATER_CASES)
def test_sharded_updater_decides_as_the_reference(rule, case, two_caches,
                                                  monkeypatch):
    """Off the TPU with nothing set the reference's updater takes the
    plain rule, and so does the port's on the CPU; a winner recorded
    under the flat key and the mesh is read by both (the key the sharded
    train step consults)."""
    spec = BUCKET_CASES[case]
    two_caches("jax")
    want = _updater_decides("jax", rule, spec, monkeypatch)
    two_caches("torch")
    got = _updater_decides("torch", rule, spec, monkeypatch)
    assert bool(got) == bool(want)


def test_flat_variant_key_matches_reference():
    j_plan, t_plan = _plans()
    for stage in (None, 1, 2, 3):
        assert t_zero.flat_variant_key(t_plan, stage) == \
            j_zero.flat_variant_key(j_plan, stage)
    assert t_zero.flat_variant_key(t_plan, None) == \
        t_zero.flat_variant_key(t_plan, 2)
    assert t_zero.flat_variant_key([], None) == ((0,), "float32")


@pytest.mark.parametrize("rule,want", [("sgd", True), ("adam", True),
                                       ("lars", True), ("nag", False)])
def test_undecided_bucket_arm_on_the_card(rule, want, caches,
                                          monkeypatch):
    _, t_plan = _plans()
    _, cls, kw = RULES[rule]
    assert t_zero.resolve_bucket_variant(cls(**kw), t_plan,
                                         platform="cuda") is want
    # a jnp winner cached for the card is outside its roster
    shape, dtype = t_zero.flat_variant_key(t_plan)
    t_at.record("fused_bucket_opt", shape, dtype, winner="jnp",
                platform="cuda", mesh="none")
    assert t_zero.resolve_bucket_variant(cls(**kw), t_plan,
                                         platform="cuda") is want
    # the user's explicit choice holds on the card too
    monkeypatch.setenv("MXNET_PALLAS_OPT", "0")
    assert t_zero.resolve_bucket_variant(cls(**kw), t_plan,
                                         platform="cuda") is False


# ------------------------------------------ make_train_step in-step races
def _conv_net(pkg):
    nn = j_nn if pkg == "jax" else t_nn
    with nn.default_layout("NHWC"):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 1, use_bias=False, in_channels=3),
                    nn.GlobalAvgPool2D(), nn.Dense(3, in_units=4))
    if pkg == "jax":
        net.initialize(init=jmx.init.Xavier(), ctx=jmx.cpu())
    else:
        net.initialize(device="cpu")
    return net


def _sample(shape=(4, 4, 4, 3), classes=3):
    rng = onp.random.RandomState(0)
    return (rng.rand(*shape).astype("float32"),
            rng.randint(0, classes, (shape[0],)).astype("float32"))


def _port_build(net, counted=None, **kw):
    """``make_train_step`` of the port on the host; ``counted`` (a list)
    gets one entry per step that a race runs."""
    if counted is not None:
        real = t_at._step_chain_time

        def chain(step, *a, **k):
            def counting(*args):
                counted.append(1)
                return step(*args)
            return real(counting, *a, **k)

        t_at._step_chain_time = chain
    try:
        return t_par.make_train_step(
            net, t_gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            learning_rate=0.1, device="cpu", **kw)
    finally:
        if counted is not None:
            t_at._step_chain_time = real


def test_conv1x1_dot_race_then_rebuild_reloads(caches):
    x, y = _sample()
    net = _conv_net("torch")
    counted = []
    step, p, s = _port_build(net, counted, sample_data=(x, y))
    rep = t_at.last_report()
    assert rep["conv1x1_dot"]["cached"] is False
    assert set(rep["conv1x1_dot"]["timings"]) == {"conv", "dot"}
    assert all(v > 0 for v in rep["conv1x1_dot"]["timings"].values())
    assert len(counted) > 0
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert onp.isfinite(float(loss))
    counted.clear()
    _port_build(net, counted, sample_data=(x, y))
    rep2 = t_at.last_report()
    assert rep2["conv1x1_dot"]["cached"] is True
    assert rep2["conv1x1_dot"]["winner"] == rep["conv1x1_dot"]["winner"]
    assert counted == []  # pure lookups: no step ran
    # the file holds the reference's key for this signature
    key = "|".join(("conv1x1_dot", str(x.shape), "float32", "cpu", "none"))
    with open(t_at.cache_path()) as f:
        assert key in json.load(f)["entries"]
    # autotune=False: no race, even with sample data
    counted.clear()
    _port_build(net, counted, sample_data=(x, y), autotune=False)
    assert counted == []


def test_dtype_ladder_races_only_when_armed(caches, monkeypatch):
    x, y = _sample((4, 6), 3)
    net = t_nn.HybridSequential()
    with net.name_scope():
        net.add(t_nn.Dense(8, activation="relu", in_units=6),
                t_nn.Dense(3, in_units=8))
    net.initialize(device="cpu")
    _port_build(net, sample_data=(x, y))
    assert "dtype_ladder" not in t_at.last_report()

    monkeypatch.setenv("MXNET_DTYPE_LADDER", "1")
    step, p, s = _port_build(net, sample_data=(x, y))
    rep = t_at.last_report()
    assert rep["dtype_ladder"]["winner"] in ("fp32", "bf16")
    assert set(rep["dtype_ladder"]["timings"]) == {"fp32", "bf16"}
    assert "_fp8" not in s
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert onp.isfinite(float(loss))
    _port_build(net, sample_data=(x, y))
    assert t_at.last_report()["dtype_ladder"]["cached"] is True

    # a pinned rung is no race; an explicit compute_dtype is off the roster
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "bf16")
    step, p, s = _port_build(net, sample_data=(x, y))
    assert "dtype_ladder" not in t_at.last_report()
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert onp.isfinite(float(loss))
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "1")
    _port_build(net, sample_data=(x, y), compute_dtype="bfloat16")
    assert "dtype_ladder" not in t_at.last_report()


def _mlp(pkg):
    nn = j_nn if pkg == "jax" else t_nn
    net = nn.HybridSequential(prefix="fp8t_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6, prefix="d0_"),
                nn.Dense(3, in_units=16, prefix="d1_"))
    if pkg == "jax":
        net.initialize(init=jmx.init.Xavier(), ctx=jmx.cpu())
    else:
        net.initialize(device="cpu")
    return net


def test_three_rung_race_and_reload_in_another_process(caches,
                                                       monkeypatch):
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp32,bf16,fp8")
    x, y = _sample((8, 6), 3)
    step, p, s = _port_build(_mlp("torch"), sample_data=(x, y))
    rep = t_at.last_report()["dtype_ladder"]
    assert set(rep["timings"]) == {"fp32", "bf16", "fp8"}
    assert "_fp8" in s
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert onp.isfinite(float(loss))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as onp\n"
        "from mxnet_tpu_torch import autotune as at, parallel\n"
        "from mxnet_tpu_torch.gluon import loss, nn\n"
        "net = nn.HybridSequential(prefix='fp8t_')\n"
        "with net.name_scope():\n"
        "    net.add(nn.Dense(16, activation='relu', in_units=6,\n"
        "                     prefix='d0_'),\n"
        "            nn.Dense(3, in_units=16, prefix='d1_'))\n"
        "net.initialize(device='cpu')\n"
        "rng = onp.random.RandomState(0)\n"
        "x = rng.rand(8, 6).astype('float32')\n"
        "y = rng.randint(0, 3, (8,)).astype('float32')\n"
        "at._step_chain_time = None  # a reload times nothing\n"
        "parallel.make_train_step(net, loss.SoftmaxCrossEntropyLoss(),\n"
        "                         'sgd', learning_rate=0.1, device='cpu',\n"
        "                         sample_data=(x, y))\n"
        "rep = at.last_report()['dtype_ladder']\n"
        "assert rep['cached'] is True, rep\n"
        "assert rep['winner'] == %r, rep\n"
        "print('child-ok')\n" % (_REPO, rep["winner"]))
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "child-ok" in out.stdout


def _fp8_roster_reads(pkg, monkeypatch):
    """What the reference's ``test_cached_fp8_winner_needs_roster_opt_in``
    reads, for ``pkg``."""
    at = j_at if pkg == "jax" else t_at
    kw = {} if pkg == "jax" else {"platform": "cpu"}
    out = []
    for ladder in ("fp32,bf16,fp8", "fp32,bf16", "fp8", "1"):
        monkeypatch.setenv("MXNET_DTYPE_LADDER", ladder)
        out.append(sorted(at.op_variants("dtype_ladder", **kw)))
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp32,bf16,fp8")
    at.record("dtype_ladder", (8, 6), "float32", winner="fp8",
              platform="cpu", mesh="none")
    for ladder in ("fp32,bf16,fp8", "fp32,bf16"):
        monkeypatch.setenv("MXNET_DTYPE_LADDER", ladder)
        with at.program_scope((8, 6), "float32", platform="cpu",
                              mesh="none"):
            out.append(at.variant_choice("dtype_ladder"))
    monkeypatch.delenv("MXNET_DTYPE_LADDER")
    return out


def test_cached_fp8_winner_needs_roster_opt_in(two_caches, monkeypatch):
    two_caches("jax")
    want = _fp8_roster_reads("jax", monkeypatch)
    two_caches("torch")
    assert _fp8_roster_reads("torch", monkeypatch) == want
    assert want[-2:] == ["fp8", None]
    # a step built under "fp32,bf16" carries no fp8 state, and the
    # cached fp8 winner does not reach it
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp32,bf16")
    x, y = _sample((8, 6), 3)
    step, p, s = _port_build(_mlp("torch"))
    assert "_fp8" not in s
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert onp.isfinite(float(loss))
    # the same winner under a roster naming fp8 applies and moves the
    # delayed-scaling state
    monkeypatch.setenv("MXNET_DTYPE_LADDER", "fp32,bf16,fp8")
    step, p, s = _port_build(_mlp("torch"))
    before = s["_fp8"]["x"][1].clone()
    loss, p, s = step(p, s, x, y, None, 1.0)
    assert not torch.equal(s["_fp8"]["x"][1], before)


def test_sample_data_under_a_mesh_warns(caches):
    x, y = _sample()
    net = _conv_net("torch")
    counted = []
    with pytest.warns(UserWarning, match="under a mesh"):
        step, p, s = _port_build(
            net, counted, sample_data=(x, y),
            mesh=t_par.get_mesh(devices=["cpu"]), optimizer_sharding="ps")
    assert counted == []
    # winners cached for the mesh key still apply to the step's calls
    t_at.record("conv1x1_dot", x.shape, "float32", winner="dot",
                platform="cpu", mesh="data=1")
    dots = _count(t_conv, "_conv1x1_dot")
    with dots:
        loss, p, s = step(p, s, x, y, None, 1.0)
    assert dots.n > 0 and onp.isfinite(float(loss))


class _count:
    """Counts the calls of ``module.name`` while entered."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


# --------------------------------------------------------- conv1x1_dot
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_dot_matches_conv_and_reference(stride):
    rng = onp.random.RandomState(stride)
    x = rng.randn(2, 7, 9, 16).astype("float32")
    w = rng.randn(24, 1, 1, 16).astype("float32")
    kw = dict(kernel=(1, 1), num_filter=24, stride=(stride, stride),
              no_bias=True, layout="NHWC")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with t_at.force(conv1x1_dot=False):
        conv = t_conv.convolution(tx, tw, **kw)
    calls = _count(t_conv, "_conv1x1_dot")
    with t_at.force(conv1x1_dot=True), calls:
        dot = t_conv.convolution(tx, tw, **kw)
    assert calls.n == 1
    with j_at.force(conv1x1_dot=True):
        ref = onp.asarray(j_conv.convolution(jnp.asarray(x), jnp.asarray(w),
                                             **kw))
    assert dot.shape == conv.shape == ref.shape
    assert dot.is_contiguous()
    onp.testing.assert_allclose(dot.numpy(), conv.numpy(), rtol=1e-5,
                                atol=1e-5)
    onp.testing.assert_allclose(dot.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the arm is taken only where it applies: a 3x3 convolution is a
    # convolution whatever the variant says
    with t_at.force(conv1x1_dot=True), calls:
        t_conv.convolution(tx, torch.zeros(4, 3, 3, 16), kernel=(3, 3),
                           num_filter=4, pad=(1, 1), no_bias=True,
                           layout="NHWC")
    assert calls.n == 1


# ------------------------------------- program_scope at the entry points
def _bottleneck_net(pkg):
    from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res

    res, nn = (j_res, j_nn) if pkg == "jax" else (t_res, t_nn)
    with nn.default_layout("NHWC"):
        net = res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64,
                                                           128],
                           classes=10, no_bias=True, prefix="resnetv10_")
    return net


def _hybrid_fused_calls(pkg, winner):
    """Count of ``pallas_conv.enabled()`` answering True while the
    hybridized net runs one recorded training call, with ``winner``
    recorded for the call's signature (None: nothing recorded)."""
    x = onp.random.RandomState(1).randn(2, 32, 32, 3).astype("float32")
    if pkg == "jax":
        from mxnet_tpu import autograd
        from mxnet_tpu.ops import pallas_conv as pc
        mx, at = jmx, j_at
        net = _bottleneck_net("jax")
        net.initialize(init=jmx.init.Xavier(), ctx=jmx.cpu())
        net(jmx.nd.zeros((1, 32, 32, 3)))
        data = jmx.nd.array(x)
    else:
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.ops import pallas_conv as pc
        mx, at = tmx, t_at
        net = _bottleneck_net("torch")
        net.initialize(device="cpu")
        data = tmx.nd.array(x, ctx=tmx.cpu())
    if winner is not None:
        at.record("pallas_bnreluconv", x.shape, "float32", winner=winner,
                  platform="cpu", mesh="none")
    net.hybridize()
    real = pc.enabled
    seen = []

    def enabled():
        seen.append(real())
        return seen[-1]

    pc.enabled = enabled
    try:
        with mx.cpu(), autograd.record():
            out = net(data)
        out.backward()
    finally:
        pc.enabled = real
    return sum(seen)


@pytest.mark.parametrize("winner", [None, "stock", "pallas", "jnp"])
def test_block_takes_the_recorded_bnreluconv_winner(winner, two_caches):
    two_caches("jax")
    want = _hybrid_fused_calls("jax", winner)
    two_caches("torch")
    from mxnet_tpu_torch.ops import pallas_conv as t_pc

    fused = _count(t_pc, "fused_bn_relu_conv1x1")
    with fused:
        got = _hybrid_fused_calls("torch", winner)
    on = winner in ("pallas", "jnp")
    assert (got > 0) == (want > 0) == on
    assert fused.n == (4 if on else 0)  # one per bottleneck


def _module_dot_calls(pkg, winner):
    """Calls of the 1x1 convolution's dot arm while a ``Module`` over a
    channel-last symbol runs forward and backward on the host, with
    ``winner`` recorded for the data's signature."""
    x = onp.random.RandomState(2).randn(4, 6, 6, 3).astype("float32")
    mx, at, conv = (jmx, j_at, j_conv) if pkg == "jax" else \
        (tmx, t_at, t_conv)
    if winner is not None:
        at.record("conv1x1_dot", x.shape, "float32", winner=winner,
                  platform="cpu", mesh="none")
    data = mx.sym.var("data")
    weight = mx.sym.var("c_weight", shape=(5, 1, 1, 3))
    net = mx.sym.Convolution(data, weight, kernel=(1, 1), num_filter=5,
                             no_bias=True, layout="NHWC", name="c")
    net = mx.sym.mean(net, axis=(1, 2))
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(initializer=mx.init.Xavier())
    real = conv._conv1x1_dot
    calls = []

    def counted(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    conv._conv1x1_dot = counted
    try:
        with mx.cpu():
            batch = mx.io.DataBatch([mx.nd.array(x)],
                                    [mx.nd.array(onp.arange(4) % 5)])
            mod.forward(batch, is_train=True)
            mod.backward()
    finally:
        conv._conv1x1_dot = real
    return sum(calls)


@pytest.mark.parametrize("winner", [None, "conv", "dot"])
def test_module_executor_takes_the_recorded_dot_winner(winner, two_caches):
    two_caches("jax")
    want = _module_dot_calls("jax", winner)
    two_caches("torch")
    got = _module_dot_calls("torch", winner)
    assert (got > 0) == (want > 0) == (winner == "dot")

