"""The fused BN -> ReLU -> 1x1-conv block (``ops/pallas_conv.py``) held
against the JAX package on the CPU.

- pass 1: the port's plain ``_bwd_pass1_reference`` against the
  reference's Pallas kernel (interpret mode) and its ``_bwd_pass1_jnp``,
  with a ragged M (the kernel's tail block runs past M);
- the fused op: forward and all four gradients against ``jax.grad`` of
  the reference op, on both backward arms;
- a BottleneckV1 block: forward and every parameter gradient, stock and
  fused, against the reference block.

Tolerances: fp32 1e-5 relative to the largest magnitude (other
summation orders).  bf16: d_bn within one bf16 ulp of the value (the
fp32 d_act may round either way) plus 1e-5 of the largest value (a
d_act that cancels to near zero differs between summation orders by
more than its own ulp), and dW/s1/s2 1e-5 (fp32 sums of identical bf16
products).  Whole blocks in fp32: 1e-4 (a chain of
convolutions and BatchNorm reductions).
"""
import os

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autograd as j_autograd  # noqa: E402
from mxnet_tpu import autotune as j_at  # noqa: E402
from mxnet_tpu import nd  # noqa: E402
from mxnet_tpu.gluon import nn as j_nn  # noqa: E402
from mxnet_tpu.gluon.model_zoo.vision import resnet as j_res  # noqa: E402
from mxnet_tpu.ops import pallas_conv as j_pc  # noqa: E402

from mxnet_tpu_torch import autotune as t_at  # noqa: E402
from mxnet_tpu_torch import parallel as t_par  # noqa: E402
from mxnet_tpu_torch.gluon import nn as t_nn  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as t_res  # noqa: E402
from mxnet_tpu_torch.ops import pallas_conv as t_pc  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got = onp.asarray(got, dtype=onp.float32)
    want = onp.asarray(want, dtype=onp.float32)
    return float(onp.abs(got - want).max() / (onp.abs(want).max() + 1e-20))


def _pass1_inputs(m, ci, co, dtype, seed):
    rng = onp.random.RandomState(seed)
    arrs = dict(dy=rng.randn(m, co), u=rng.randn(m, ci),
                w2=rng.randn(ci, co) * 0.1, g=rng.rand(1, ci) + 0.5,
                b=rng.randn(1, ci) * 0.3, mu=rng.randn(1, ci) * 0.1,
                inv=rng.rand(1, ci) + 0.5)
    jdt, tdt = _DT[dtype]
    act = ("dy", "u", "w2")
    j = {k: jnp.asarray(v.astype("float32"), jdt if k in act
                        else jnp.float32) for k, v in arrs.items()}
    # the same (rounded) values on the port's side
    t = {k: torch.from_numpy(onp.array(j[k].astype(jnp.float32)))
         .to(tdt if k in act else torch.float32) for k in arrs}
    return j, t


@pytest.mark.parametrize("m", [300, 4133])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pass1_reference_matches_pallas_and_jnp(m, dtype):
    """4133 rows: two kernel blocks of 4096, the second ragged."""
    j, t = _pass1_inputs(m, 8, 24, dtype, seed=m)
    args = ("dy", "u", "w2", "g", "b", "mu", "inv")
    want_k = j_pc._bwd_pass1_pallas(*(j[k] for k in args), interpret=True)
    want_j = j_pc._bwd_pass1_jnp(*(j[k] for k in args))
    got = t_pc.bnreluconv_bwd(*(t[k] for k in args))
    assert got[0].dtype == t["dy"].dtype and tuple(got[0].shape) == (m, 8)
    assert tuple(got[1].shape) == (8, 24) and got[1].dtype == torch.float32
    assert tuple(got[2].shape) == tuple(got[3].shape) == (1, 8)
    for want in (want_k, want_j):
        d_bn = got[0].float().numpy()
        ref = onp.asarray(want[0].astype(jnp.float32))
        if dtype == "float32":
            assert _rel(d_bn, ref) <= 1e-5
        else:  # one bf16 ulp of each value, plus 1e-5 of the largest
            assert (onp.abs(d_bn - ref) <= onp.abs(ref) * 2.0 ** -7
                    + 1e-5 * onp.abs(ref).max()).all()
        for a, b in zip(got[1:], want[1:]):
            assert _rel(a.numpy(), b) <= 1e-5


#: ResNet-50's four stage shapes (M, Ci, Co) at batch 128, and two ragged
_PLAN_SHAPES = [(401408, 64, 256), (100352, 128, 512), (25088, 256, 1024),
                (6272, 512, 2048), (77, 100, 70), (4133, 64, 250)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", _PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_covers_every_row_once(shape, dtype):
    """The kernel's plan: its d_act row groups and its dW splits, walked
    as the kernel walks them, cover every row exactly once and none is
    without rows, so the grid is exactly the scratch the wrapper sizes
    (s_part [2, groups, Ci], dw_part [splits, Ci, Co]); at the stage
    shapes each pass has two waves of CTAs or more on 132 SMs."""
    m, ci, co = shape
    tdt = _DT[dtype][1]
    groups, splits = t_pc._bwd_plan(m, ci, co, tdt)
    tiles = t_pc._TILES[tdt]
    assert 1 <= groups <= 65535 and 1 <= splits <= 65535
    block = tiles["rows"]
    n_blocks = -(-m // block)
    per = t_pc._group_blocks(n_blocks, groups)
    seen = onp.zeros(m, dtype=int)
    for grp in range(groups):
        b0, b1 = grp * per, min(n_blocks, (grp + 1) * per)
        assert b1 > b0, f"group {grp} has no rows"
        seen[b0 * block:min(m, b1 * block)] += 1
    assert (seen == 1).all()
    rows = t_pc._split_rows(m, splits)
    assert rows % t_pc._SPLIT_ALIGN == 0
    seen[:] = 0
    for split in range(splits):
        r0 = min(m, split * rows)
        r1 = min(m, r0 + rows)
        assert r1 > r0, f"split {split} has no rows"
        seen[r0:r1] += 1
    assert (seen == 1).all()
    if shape in _PLAN_SHAPES[:4]:
        dact_ctas = groups * -(-ci // tiles["dact_ci"])
        dw_ctas = splits * -(-ci // tiles["ci"]) * -(-co // tiles["co"])
        assert min(dact_ctas, dw_ctas) >= 2 * 132


def _fused_inputs(seed, dtype):
    rng = onp.random.RandomState(seed)
    u = rng.randn(2, 5, 7, 16).astype("float32")
    gamma = (rng.rand(16) + 0.5).astype("float32")
    beta = (rng.randn(16) * 0.2).astype("float32")
    w = (rng.randn(40, 1, 1, 16) * 0.1).astype("float32")
    r = rng.randn(2, 5, 7, 40).astype("float32")
    return u, gamma, beta, w, r


@pytest.mark.parametrize("arm", ["jnp", "pallas"])
def test_fused_op_forward_and_grads_match_reference(arm):
    """y, the batch statistics, and du/dgamma/dbeta/dW of sum(y * r)."""
    u, gamma, beta, w, r = _fused_inputs(3, "float32")

    def j_loss(u_, g_, b_, w_):
        y, _, _ = j_pc.fused_bn_relu_conv1x1(u_, g_, b_, w_)
        return jnp.sum(y * r)

    with j_at.force(pallas_bnreluconv=arm):
        j_y, j_mean, j_var = j_pc.fused_bn_relu_conv1x1(
            jnp.asarray(u), jnp.asarray(gamma), jnp.asarray(beta),
            jnp.asarray(w))
        j_grads = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(u), jnp.asarray(gamma), jnp.asarray(beta),
            jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (u, gamma, beta, w)]
    with t_at.force(pallas_bnreluconv=arm):
        t_y, t_mean, t_var = t_pc.fused_bn_relu_conv1x1(*leaves)
        (t_y * torch.from_numpy(r)).sum().backward()
    for got, want in ((t_y, j_y), (t_mean, j_mean), (t_var, j_var)):
        assert _rel(got.detach().numpy(), want) <= 1e-5
    for leaf, want in zip(leaves, j_grads):
        assert leaf.grad.shape == tuple(want.shape)
        assert _rel(leaf.grad.numpy(), want) <= 1e-5


@pytest.mark.parametrize("arm,kernel_calls", [("jnp", 0), ("pallas", 1)])
def test_pass1_choice_follows_the_forward_scope(arm, kernel_calls,
                                                monkeypatch):
    """The backward takes the pass 1 that the forward's scope chose, even
    when it runs on another thread outside that scope (the autograd
    engine runs a CUDA backward on its own thread): the reference
    decides while it traces the step."""
    import threading

    calls = []
    real = t_pc.bnreluconv_bwd

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(t_pc, "bnreluconv_bwd", counted)
    u, gamma, beta, w, r = _fused_inputs(4, "float32")
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (u, gamma, beta, w)]
    with t_at.force(pallas_bnreluconv=arm):
        y, _, _ = t_pc.fused_bn_relu_conv1x1(*leaves)
    # the other arm holds in the thread that runs the backward
    other = "pallas" if arm == "jnp" else "jnp"

    def backward():
        with t_at.force(pallas_bnreluconv=other):
            (y * torch.from_numpy(r)).sum().backward()

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert len(calls) == kernel_calls
    assert all(leaf.grad is not None for leaf in leaves)


def test_fused_op_bf16_matches_reference():
    """bf16 activations and weight: y within one bf16 ulp of the
    largest value (the products round the same way, their fp32 sums in
    another order), the statistics 1e-5, du one bf16 ulp."""
    u, gamma, beta, w, r = _fused_inputs(4, "bfloat16")
    ju = jnp.asarray(u, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)

    def j_loss(u_):
        y, _, _ = j_pc.fused_bn_relu_conv1x1(u_, jnp.asarray(gamma),
                                             jnp.asarray(beta), jw)
        return jnp.sum(y.astype(jnp.float32) * r)

    with j_at.force(pallas_bnreluconv="pallas"):
        j_y, j_mean, _ = j_pc.fused_bn_relu_conv1x1(
            ju, jnp.asarray(gamma), jnp.asarray(beta), jw)
        j_du = jax.grad(j_loss)(ju)
    tu = torch.from_numpy(onp.array(ju.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(onp.array(jw.astype(jnp.float32))).to(
        torch.bfloat16)
    with t_at.force(pallas_bnreluconv="pallas"):
        t_y, t_mean, _ = t_pc.fused_bn_relu_conv1x1(
            tu, torch.from_numpy(gamma), torch.from_numpy(beta), tw)
        (t_y.float() * torch.from_numpy(r)).sum().backward()
    assert _rel(t_y.detach().float().numpy(), j_y.astype(jnp.float32)) \
        <= 2.0 ** -7
    assert _rel(t_mean.detach().numpy(), j_mean) <= 1e-5
    assert _rel(tu.grad.float().numpy(), j_du.astype(jnp.float32)) \
        <= 2.0 ** -7


@pytest.fixture
def fused_env():
    os.environ["MXNET_FUSED_BNRELUCONV"] = "1"
    yield
    os.environ.pop("MXNET_FUSED_BNRELUCONV", None)


def test_enabled_and_use_pallas_follow_the_reference(fused_env,
                                                     monkeypatch):
    x = torch.zeros(1)
    assert t_pc.enabled() is j_pc.enabled() is True
    with t_at.force(pallas_bnreluconv="stock"), \
            j_at.force(pallas_bnreluconv="stock"):
        assert t_pc.enabled() is j_pc.enabled() is False
    monkeypatch.delenv("MXNET_FUSED_BNRELUCONV")
    assert t_pc.enabled() is j_pc.enabled() is False
    for arm, want in (("jnp", False), ("pallas", True)):
        with t_at.force(pallas_bnreluconv=arm):
            assert t_pc.enabled() is True
            assert t_pc._use_pallas(x) is want
    monkeypatch.setenv("MXNET_BNRELUCONV_VARIANT", "jnp")
    assert t_pc.enabled() is True and t_pc._use_pallas(x) is False
    monkeypatch.setenv("MXNET_PALLAS", "0")
    with t_at.force(pallas_bnreluconv="pallas"):
        assert t_pc._use_pallas(x) is False
    # the kernel's target is a CUDA tensor; on the host MXNET_PALLAS=1
    # asks for what cannot run there
    monkeypatch.setenv("MXNET_PALLAS", "1")
    assert t_pc._use_pallas(x) is False


def _blocks(seed):
    mx.random.seed(seed)
    onp.random.seed(seed)
    # built inside a parent's name scope, so the layer names come from
    # that scope's counters and not from how many layers the process
    # built before
    with j_nn.default_layout("NHWC"):
        jouter = j_nn.HybridSequential(prefix="blk_")
        with jouter.name_scope():
            jblk = j_res.BottleneckV1(64, 1, downsample=True,
                                      in_channels=16, no_bias=True,
                                      prefix="")
    jblk.initialize()
    x = onp.random.RandomState(seed).randn(2, 6, 6, 16).astype("float32")
    jblk(nd.array(x))  # deferred shapes
    rng = onp.random.RandomState(seed + 1)
    for name, p in jblk.collect_params().items():
        if name.endswith("gamma"):
            p.set_data(nd.array(rng.rand(*p.shape).astype("float32") + 0.5))
        elif name.endswith("beta"):
            p.set_data(nd.array(rng.randn(*p.shape).astype("float32") * 0.2))
    with t_nn.default_layout("NHWC"):
        touter = t_nn.HybridSequential(prefix="blk_")
        with touter.name_scope():
            tblk = t_res.BottleneckV1(64, 1, downsample=True,
                                      in_channels=16, no_bias=True,
                                      prefix="")
    tblk.initialize(device="cpu")
    t_par.load_jax_params(tblk, {n: p.data().asnumpy()
                                 for n, p in jblk.collect_params().items()})
    assert tblk._fusable_tail and jblk._fusable_tail
    return jblk, tblk, x


@pytest.mark.parametrize("arm", ["stock", "jnp", "pallas"])
def test_bottleneck_block_matches_reference(arm, fused_env):
    """Training-mode forward of sum(block(x) * r) and every parameter
    gradient; bn2's running statistics fold in on the fused tail as on
    the layer path."""
    jblk, tblk, x = _blocks(7)
    r = onp.random.RandomState(9).randn(2, 6, 6, 64).astype("float32")
    with j_at.force(pallas_bnreluconv=arm):
        with j_autograd.record():
            jl = (jblk(nd.array(x)) * nd.array(r)).sum()
        jl.backward()
    j_grads = {n: p.grad().asnumpy() for n, p in
               jblk.collect_params().items() if p.grad_req == "write"}
    tblk.train()
    with t_at.force(pallas_bnreluconv=arm):
        tl = (tblk(torch.from_numpy(x)) * torch.from_numpy(r)).sum()
        tl.backward()
    assert abs(float(tl.detach()) - float(jl.asnumpy())) <= 1e-4 * abs(
        float(jl.asnumpy()))
    t_params = tblk.collect_params()
    assert sorted(j_grads) == sorted(
        n for n, p in t_params.items() if p.grad_req == "write")
    for n, want in j_grads.items():
        assert _rel(t_params[n].data()._data.grad.numpy(), want) <= 1e-4, n
    for n, p in jblk.collect_params().items():
        if n.endswith(("running_mean", "running_var")):
            assert _rel(t_params[n].data().asnumpy(),
                        p.data().asnumpy()) <= 1e-5, n
