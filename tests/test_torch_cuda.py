"""The port on a CUDA card: every test here is marked ``cuda`` and
skips on a host without one.  The file imports neither JAX nor the JAX
package, so on the card's host it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Each kernel is held against its plain version on the same inputs:
flash attention fp32 1e-4 (another exp/sum order) and bf16 2e-2 (one
bf16 rounding of the output) and, row by row, 2^-6 of the row's largest
value (``chip_smoke.row_rel_err``), with fully masked rows exactly 0; the
fused BN-ReLU-conv backward as its test states; the bucket SGD and Adam
kernels bit for bit; the LARS update (phase c) bit for bit given the
same per-segment lr, and the whole LARS update to rtol/atol 1e-6 (the
norms are sums in other orders), the same bits on two runs.  Train
steps of a tiny ResNet show the launch counts, through the fused step
and through the imperative Gluon loop (``gluon.Trainer``), whose LeNet
step on the card is held against the host's.  Indices out of range
(pick, Embedding, gather_nd) give the host's values on the card and
leave its context alive; Dropout's masks follow the step's key there.
A block hybridized with both static flags replays CUDA graphs: three
graphed steps equal eager's bit for bit, the fused backward runs inside
the replayed backward with the arm in force at capture, held outputs
and gradients survive later replays, a block called twice in one
``record()`` captures a second program and gives eager's gradients, a
static child of a plain Block replays graphs of its own (held to eager
at 1e-6), a replayed Dropout draws as eager does, a block that syncs
with the host raises, and an export on the card writes a host export's
bytes.  The asynchronous checkpoint's capture of card tensors, updated
in place right after ``save_async`` returns, writes a synchronous
``save``'s bytes.
"""
import contextlib
import os

import numpy as onp
import pytest
import torch

from chip_smoke import BF16_ROW_TOL, host_syncs, row_rel_err
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no host mode")
    return torch.device("cuda", 0)


def _qkv(b, h, sq, sk, d, dtype, device, seed=3):
    rng = onp.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, h, s, d).astype("float32"))
                 .to(device, getattr(torch, dtype))
                 for s in (sq, sk, sk))


def _assert_close(got, want, dtype):
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    if dtype == "bfloat16":
        assert row_rel_err(got, want) <= BF16_ROW_TOL


@pytest.mark.parametrize("case", [
    (1, 2, 16, 16, 8, "float32", True),
    (1, 2, 5, 37, 16, "float32", True),
    (2, 4, 130, 130, 64, "float32", False),
    (2, 4, 40, 9, 128, "bfloat16", True),
    (1, 3, 70, 70, 32, "bfloat16", False),
])
def test_kernel_matches_plain(card, case):
    b, h, sq, sk, d, dtype, causal = case
    q, k, v = _qkv(b, h, sq, sk, d, dtype, card)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, variant="pallas")
    want = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(got, want, dtype)
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,d", [(63, 63, 64), (65, 65, 64),
                                     (130, 67, 128), (67, 130, 128),
                                     (33, 33, 8), (70, 150, 16),
                                     (100, 129, 32)])
def test_kernel_tile_edges_and_depths(card, sq, sk, d, dtype, causal):
    """Ragged q and key tiles on both sides of the 64-row edges, every
    head_dim (bf16 D = 8 pads its depth to 16), held against the plain
    version; fully masked rows exactly 0."""
    q, k, v = _qkv(2, 3, sq, sk, d, dtype, card, seed=sq + sk)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    _assert_close(got, want, dtype)
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 16])
def test_key_split_arm_matches_plain_and_repeats(card, sq, dtype):
    """Sq << Sk takes the key-split arm (partials merged in a fixed
    order): within tolerance of the plain version, the same bits on
    two runs."""
    q, k, v = _qkv(2, 16, sq, 2048, 128, dtype, card)
    _, _, split, _ = tfa._plan_on(q.device, 32, sq, 2048, True,
                                  tfa._KERNEL_DTYPES[q.dtype], 128)
    assert split
    got = tfa.flash_attention(q, k, v, causal=True)
    again = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    assert torch.equal(got, again)


def test_kernel_refuses_a_misaligned_view(card):
    """A contiguous view one element past its storage's start is not
    16-byte aligned: the wrapper raises and launches nothing."""
    q, k, v = _qkv(1, 2, 8, 8, 8, "float32", card)
    q = torch.zeros(q.numel() + 1, device=card)[1:].view(q.shape)
    assert q.is_contiguous()
    before = tfa.flash_attention.launches
    with pytest.raises(MXNetError, match="aligned"):
        tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention.launches == before


def test_naive_variant_launches_nothing(card):
    q, k, v = _qkv(1, 2, 8, 8, 8, "float32", card)
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v, causal=True, variant="naive")
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguity"])
def test_kernel_refuses_what_it_does_not_take(card, bad):
    q, k, v = _qkv(1, 2, 8, 8, 8, "float32", card)
    if bad == "head_dim":  # no depth at all
        q, k, v = _qkv(1, 2, 8, 8, 0, "float32", card)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = tfa.flash_attention.launches
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, causal=True, variant="pallas_pad")
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [24, 40, 96])
def test_kernel_runs_head_dims_without_tiles(card, d, causal, dtype):
    """A head_dim between the kernel's depths runs the kernel at the
    next depth, zero-padded, and comes back at its own depth: held
    against the plain version under the usual tolerances."""
    q, k, v = _qkv(2, 3, 70, 90, d, dtype, card, seed=d)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert got.is_contiguous()
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 192, 256, 320])
def test_kernel_runs_head_dims_above_128(card, d, causal, dtype):
    """A head_dim above 128 runs the slab kernel (128-wide slabs of the
    output, Q K^T over 128-deep chunks) at the next multiple of 128,
    zero-padded, in one launch: held against the plain version under
    the usual tolerances, across ragged q and key tiles."""
    q, k, v = _qkv(2, 3, 150, 131, d, dtype, card, seed=d)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert got.is_contiguous()
    _assert_close(got, want, dtype)
    if causal:
        assert bool((got[:, :, :150 - 131] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 16])
def test_key_split_arm_at_head_dim_256(card, sq, dtype):
    """Sq << Sk at head_dim 256: the key split's partials of both slabs
    merge to the plain version's result, the same bits on two runs."""
    q, k, v = _qkv(2, 16, sq, 2048, 256, dtype, card)
    _, _, split, _ = tfa._plan_on(q.device, 32, sq, 2048, True,
                                  tfa._KERNEL_DTYPES[q.dtype], 256)
    assert split
    got = tfa.flash_attention(q, k, v, causal=True)
    again = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("needs", ["q", "k", "v"])
def test_kernel_refuses_operands_that_require_grad(card, needs):
    """The kernel has no backward: an operand that requires grad raises
    and launches nothing, where it would otherwise get no gradient;
    under torch.no_grad() the kernel runs."""
    ops = dict(zip("qkv", _qkv(1, 2, 16, 16, 32, "float32", card)))
    ops[needs].requires_grad_(True)
    before = tfa.flash_attention.launches
    with pytest.raises(MXNetError, match="no backward"):
        tfa.flash_attention(ops["q"], ops["k"], ops["v"], causal=True)
    assert tfa.flash_attention.launches == before
    with torch.no_grad():
        out = tfa.flash_attention(ops["q"], ops["k"], ops["v"], causal=True)
    assert tfa.flash_attention.launches == before + 1
    assert not out.requires_grad


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _served_tokens(params, device, head_dim=8, pool_budget=1 << 16):
    from mxnet_tpu_torch.serving import GenerativeServer

    srv = GenerativeServer(params=params, device=device, head_dim=head_dim,
                           prompt_buckets=(4, 8), max_new=6, slots=4,
                           page_tokens=4, pool_budget=pool_budget,
                           kv_dtype="float32")
    srv.start(warm=True)
    try:
        return [srv.submit(p, max_new=6).result(timeout=60)
                for p in ([1, 2, 3], [5], [7, 3, 9, 2, 11])]
    finally:
        srv.close()


def test_server_tokens_equal_on_card_and_host(card):
    from mxnet_tpu_torch.serving import toy_decoder_params

    params = toy_decoder_params(seed=0, device="cpu")
    assert _served_tokens(params, card) == _served_tokens(params, "cpu")


def test_server_serves_a_padded_head_dim_with_the_grad_guard(card):
    """head_dim 24 prefills through the kernel at depth 32, and serving
    runs with the gradient guard in place (its parameters require no
    grad): the same tokens as on the host."""
    from mxnet_tpu_torch.serving import toy_decoder_params

    params = toy_decoder_params(seed=0, head_dim=24, device="cpu")
    assert not any(t.requires_grad for t in _tensors(params))
    before = tfa.flash_attention.launches
    on_card = _served_tokens(params, card, head_dim=24)
    assert tfa.flash_attention.launches > before
    assert on_card == _served_tokens(params, "cpu", head_dim=24)


def test_server_serves_head_dim_256(card):
    """head_dim 256 prefills through the slab kernel: the same tokens as
    on the host, with fp32 KV."""
    from mxnet_tpu_torch.serving import toy_decoder_params

    params = toy_decoder_params(seed=0, head_dim=256, device="cpu")
    # the pool's byte budget scaled with the head: the same pages as at
    # head_dim 8
    kw = dict(head_dim=256, pool_budget=1 << 21)
    before = tfa.flash_attention.launches
    on_card = _served_tokens(params, card, **kw)
    assert tfa.flash_attention.launches > before
    assert on_card == _served_tokens(params, "cpu", **kw)


# ------------------------------------------- the ResNet training slice
def _brc_inputs(m, ci, co, dtype, device, seed=5):
    rng = onp.random.RandomState(seed)
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0, cast=True):
        a = torch.from_numpy((rng.randn(*shape) * scale).astype("float32"))
        return a.to(device, dt if cast else torch.float32)

    w = t(co, ci, scale=0.1)
    return (t(m, co), t(m, ci), w.t(), t(1, ci, cast=False).abs() + 0.5,
            t(1, ci, scale=0.3, cast=False), t(1, ci, scale=0.1, cast=False),
            t(1, ci, cast=False).abs() + 0.5)


@pytest.mark.parametrize("case", [
    (300, 8, 24, "float32"), (4133, 64, 256, "float32"),
    (4133, 64, 256, "bfloat16"), (1000, 512, 2048, "bfloat16"),
    (77, 100, 70, "float32"),
    # bf16 on the tensor cores: ragged widths and an unaligned Co (the
    # element-load arm), and a stage-4-like shape
    (77, 100, 70, "bfloat16"), (300, 8, 24, "bfloat16"),
    (4133, 64, 250, "bfloat16"), (6272, 512, 2048, "bfloat16"),
])
def test_bnreluconv_kernel_matches_plain(card, case):
    """d_bn: fp32 1e-5 of the largest value, bf16 one ulp of each value
    plus 1e-5 of the largest (a d_act that cancels to near zero differs
    between fp32 sums in other orders by more than its bf16 ulp);
    dW/s1/s2 1e-4 (fp32 sums in another order)."""
    from mxnet_tpu_torch.ops import pallas_conv as pc

    m, ci, co, dtype = case
    args = _brc_inputs(m, ci, co, dtype, card)
    before = pc.bnreluconv_bwd.launches
    got = pc.bnreluconv_bwd(*args)
    want = pc._bwd_pass1_reference(*args)
    torch.cuda.synchronize()
    assert pc.bnreluconv_bwd.launches == before + 1
    d_bn, ref = got[0].float(), want[0].float()
    if dtype == "float32":
        assert float((d_bn - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    else:
        assert bool(((d_bn - ref).abs() <= ref.abs() * 2.0 ** -7
                     + 1e-5 * ref.abs().max()).all())
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    again = pc.bnreluconv_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape"])
def test_bnreluconv_kernel_refuses(card, bad):
    from mxnet_tpu_torch.ops import pallas_conv as pc

    dy, u, w2, g, b, mu, inv = _brc_inputs(64, 8, 16, "float32", card)
    if bad == "dtype":
        u = u.half()
    elif bad == "contiguity":
        dy = dy.t().contiguous().t()
    else:
        w2 = w2[:4]
    before = pc.bnreluconv_bwd.launches
    with pytest.raises(MXNetError):
        pc.bnreluconv_bwd(dy, u, w2, g, b, mu, inv)
    assert pc.bnreluconv_bwd.launches == before


@pytest.mark.parametrize("case", [
    ("float32", 0.9, 1000003), ("float32", 0.0, 4099),
    ("bfloat16", 0.9, 2049), ("bfloat16", 0.0, 77),
])
def test_bucket_kernel_bit_identical_to_plain(card, case):
    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.optimizer.optimizer import scalar_as

    dtype, momentum, n = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(n)
    w = torch.randn(n, generator=gen, device=card).to(dt)
    m = torch.randn(n, generator=gen, device=card).to(dt)
    g = torch.randn(n, generator=gen, device=card)
    g[[1, n // 2, n - 1]] = torch.tensor([float("nan"), float("inf"),
                                          float("-inf")], device=card)
    # hyper-parameters rounded to the bucket's dtype, as bucket_update
    # passes them (the kernel's contract)
    lr, wd, clip = (scalar_as(v, dt) for v in (0.1, 1e-4, 0.3))
    hyper = dict(lr=lr, wd=wd, rescale=0.5, clip=clip, with_finite=True)
    mom = scalar_as(momentum, dt)
    want = po._sgd_reference(w, g, m if momentum else None, lr, wd, mom,
                             0.5, clip, True)
    if momentum:
        before = po.bucket_sgd_mom.launches
        got = po.bucket_sgd_mom(w, g, m, momentum=mom, **hyper)
        assert po.bucket_sgd_mom.launches == before + 1
        pairs = [(got[0], want[0]), (got[1], want[1])]
    else:
        before = po.bucket_sgd.launches
        got = po.bucket_sgd(w, g, **hyper)
        assert po.bucket_sgd.launches == before + 1
        pairs = [(got[0], want[0])]
    torch.cuda.synchronize()
    for a, b in pairs:
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        assert torch.equal(a[~nan], b[~nan])
    assert int(got[-1]) == int(want[2]) == 3


def test_resnet_train_step_launches_kernels(card):
    """A tiny NHWC ResNetV1 trains on the card through both kernels:
    one bnreluconv launch per bottleneck per step, one bucket launch
    per bucket per step, finite falling losses, running statistics
    unchanged."""
    from mxnet_tpu_torch import autotune, initializer, parallel
    from mxnet_tpu_torch.gluon import loss, nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.ops import pallas_conv as pc
    from mxnet_tpu_torch.ops import pallas_opt as po

    with nn.default_layout("NHWC"):
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [8, 16, 32, 64, 128], classes=10,
                              no_bias=True)
    net.initialize(initializer.Xavier(), device=card,
                   generator=torch.Generator().manual_seed(0))
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 64, 64, 3).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, 8).astype("float32"))
    with autotune.force(pallas_bnreluconv="pallas", fused_bucket_opt=True):
        step, p, s = parallel.make_train_step(
            net, loss.SoftmaxCrossEntropyLoss(), "sgd", learning_rate=0.1,
            momentum=0.9, mesh=parallel.get_mesh(), loss_scale="dynamic",
            compute_dtype="bfloat16", optimizer_sharding="ps",
            bucket_bound=30000)
        stats = {n: v.clone() for n, v in p.items()
                 if n.endswith(("running_mean", "running_var"))}
        b0, m0 = pc.bnreluconv_bwd.launches, po.bucket_sgd_mom.launches
        losses = []
        for i in range(3):
            loss_v, p, s = step(p, s, x, y, None, float(i + 1))
            losses.append(float(loss_v))
    assert pc.bnreluconv_bwd.launches - b0 == 4 * 3
    assert po.bucket_sgd_mom.launches - m0 == len(step.zero_plan) * 3
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0]
    for n, v in stats.items():
        assert torch.equal(p[n], v), n


def _same_bits(a, b):
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan],
                                                            b[~nan])


@pytest.mark.parametrize("n,t,clip", [(1000003, 1, None), (4099, 1000, 0.3),
                                      (77, 3, None), (1, 2, 0.5)])
def test_adam_kernel_bit_identical_to_plain(card, n, t, clip):
    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.optimizer.optimizer import adam_lr_t

    gen = torch.Generator(device=card).manual_seed(n)
    w, g, m = (torch.randn(n, generator=gen, device=card) for _ in range(3))
    v = torch.randn(n, generator=gen, device=card).abs()
    bad = sorted({0, n // 2, n - 1})
    g[bad] = torch.tensor([float("nan"), float("inf"), float("-inf")][
        :len(bad)], device=card)
    lr_t = adam_lr_t(1e-3, 0.9, 0.999, t)
    hyper = dict(wd=1e-4, beta1=0.9, beta2=0.999, eps=1e-8)
    before = po.bucket_adam.launches
    got = po.bucket_adam(w, g, m, v, lr_t=lr_t, rescale=0.5, clip=clip,
                         with_finite=True, **hyper)
    want = po._adam_reference(w, g, m, v, lr_t, *hyper.values(), 0.5, clip,
                              True)
    torch.cuda.synchronize()
    assert po.bucket_adam.launches == before + 1
    assert all(_same_bits(a, b) for a, b in zip(got[:3], want[:3]))
    assert int(got[3]) == int(want[3]) == len(bad)


@pytest.mark.parametrize("n,nseg,kind", [(100003, 128, "arbitrary"),
                                         (4099, 5, "sorted"),
                                         (33, 2, "sorted")])
def test_lars_kernels_match_plain_and_repeat(card, n, nseg, kind):
    from mxnet_tpu_torch.ops import pallas_opt as po

    gen = torch.Generator(device=card).manual_seed(n)
    if kind == "arbitrary":
        ids = torch.randint(0, nseg, (n,), generator=gen, device=card,
                            dtype=torch.int32)
    else:
        ids = (torch.arange(n, device=card) * nseg // n).to(torch.int32)
    w = torch.randn(n, generator=gen, device=card)
    g = torch.randn(n, generator=gen, device=card) * 0.01
    m = torch.randn(n, generator=gen, device=card)
    g[ids == nseg - 1] = 0.0  # a segment without gradient: trust 1
    g[n // 3] = float("nan")
    hp = dict(lr=5.0, wd=5e-5, eta=0.001, eps=0.0)
    runs = []
    for _ in range(2):
        slr, w_ss, g_ss, nf = po.bucket_lars_norms(
            w, g, ids, nseg, rescale=0.5, clip=0.02, with_finite=True, **hp)
        new = po.bucket_lars_update(w, g, m, ids, slr, wd=hp["wd"],
                                    momentum=0.9, rescale=0.5, clip=0.02)
        runs.append((slr, w_ss, g_ss, nf, *new))
    rw_ss, rg_ss, rnf = po._lars_norms_reference(w, g, ids, nseg, 0.5, 0.02,
                                                 True)
    rslr = po._lars_trust_reference(rw_ss, rg_ss, **hp)
    same_slr = po._lars_update_reference(w, g, m, ids, runs[0][0], hp["wd"],
                                         0.9, 0.5, 0.02)
    whole = po._lars_update_reference(w, g, m, ids, rslr, hp["wd"], 0.9, 0.5,
                                      0.02)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(runs[0], runs[1]))
    assert all(_same_bits(a, b) for a, b in zip(runs[0][4:], same_slr))
    assert int(runs[0][3]) == int(rnf) == 1
    finite = torch.isfinite(rg_ss)
    assert torch.allclose(runs[0][1], rw_ss, rtol=1e-6, atol=0)
    assert torch.allclose(runs[0][2][finite], rg_ss[finite], rtol=1e-6,
                          atol=0)
    for a, b in zip(runs[0][4:], whole):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_bucket_kernels_refuse_instead_of_falling_back(card):
    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.optimizer import LARS, Adam
    from mxnet_tpu_torch.parallel import zero

    x16 = torch.zeros(300, device=card, dtype=torch.bfloat16)
    x32 = torch.zeros(300, device=card)
    ids = torch.zeros(300, device=card, dtype=torch.int32)
    counts = (po.bucket_adam.launches, po.bucket_lars_norms.launches,
              po.bucket_lars_update.launches)
    with pytest.raises(MXNetError, match="float32"):
        po.bucket_adam(x16, x16, x16, x16, lr_t=0.1, wd=0.0, beta1=0.9,
                       beta2=0.999, eps=1e-8)
    with pytest.raises(MXNetError, match="segments"):
        po.bucket_lars_norms(x32, x32, ids, 129, lr=1.0, wd=0.0, eta=0.001,
                             eps=0.0)
    with pytest.raises(MXNetError, match="segments"):
        po.bucket_lars_update(x32, x32, x32, ids, torch.zeros(
            129, device=card), wd=0.0, momentum=0.9)
    (b,) = zero.plan_buckets({"a_weight": torch.zeros(300)}, 1)
    with pytest.raises(MXNetError, match="adam kernel supports float32"):
        zero.bucket_shard_update(b, Adam(), None, x16, (x16, x16), 1,
                                 n_shards=1, idx=0, pallas=True, w_sh=x16)
    with pytest.raises(MXNetError, match="129 segments"):
        zero.bucket_shard_update(b, LARS(momentum=0.9), None, x32, (x32,), 1,
                                 n_shards=1, idx=0, seg=(ids, 129),
                                 pallas=True, w_sh=x32)
    assert counts == (po.bucket_adam.launches, po.bucket_lars_norms.launches,
                      po.bucket_lars_update.launches)


@pytest.mark.parametrize("n,nseg,kind", [(1000003, 7, "arbitrary"),
                                         (2359296, 3, "sorted")])
def test_lars_split_launches_equal_the_fused_at_world_one(card, n, nseg,
                                                          kind):
    """A bucket sharded over processes takes LARS's split launches (the
    reduce of the partials, the all-reduce of the sums and the count,
    the trust from the summed norms).  Over a world of one they give the
    fused reduce-and-trust launch's bits, and so the plain version's
    agreement."""
    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.ops.collective_ops import Exchange
    from mxnet_tpu_torch.parallel import get_mesh

    gen = torch.Generator(device=card).manual_seed(n)
    if kind == "arbitrary":
        ids = torch.randint(0, nseg, (n,), generator=gen, device=card,
                            dtype=torch.int32)
    else:
        ids = (torch.arange(n, device=card) * nseg // n).to(torch.int32)
    w = torch.randn(n, generator=gen, device=card)
    g = torch.randn(n, generator=gen, device=card) * 0.01
    g[n // 5] = float("inf")
    hp = dict(lr=5.0, wd=5e-5, eta=0.001, eps=0.0, rescale=0.5, clip=0.02,
              with_finite=True)
    before = (po.bucket_lars_norms.launches,
              po.bucket_lars_norms.reduce_launches,
              po.bucket_lars_norms.trust_launches)
    fused = po.bucket_lars_norms(w, g, ids, nseg, **hp)
    split = po.bucket_lars_norms(w, g, ids, nseg,
                                 axis=Exchange(get_mesh(devices=[card])),
                                 **hp)
    torch.cuda.synchronize()
    assert (po.bucket_lars_norms.launches,
            po.bucket_lars_norms.reduce_launches,
            po.bucket_lars_norms.trust_launches) == \
        (before[0] + 2, before[1] + 1, before[2] + 2)
    assert all(_same_bits(a, b) for a, b in zip(fused, split))
    assert int(split[3]) == 1
    rw_ss, rg_ss, _ = po._lars_norms_reference(w, g, ids, nseg, 0.5, 0.02,
                                               True)
    assert torch.allclose(split[1], rw_ss, rtol=1e-6, atol=0)


@pytest.mark.parametrize("opt", ["lars", "adam"])
def test_lars_adam_train_steps_launch_kernels(card, opt):
    """A tiny NHWC ResNetV1 trains on the card through
    ``DataParallelTrainer``: one launch of each bucket kernel per bucket
    per step, finite falling losses."""
    from mxnet_tpu_torch import autotune, initializer, parallel
    from mxnet_tpu_torch.gluon import loss, nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.ops import pallas_opt as po

    with nn.default_layout("NHWC"):
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [8, 16, 32, 64, 128], classes=10,
                              no_bias=True)
    net.initialize(initializer.Xavier(), device=card,
                   generator=torch.Generator().manual_seed(0))
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 64, 64, 3).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, 8).astype("float32"))
    kw = dict(learning_rate=2.0, momentum=0.9, wd=5e-5, lars_eta=0.01) \
        if opt == "lars" else dict(learning_rate=1e-3, wd=1e-4)
    counters = [(po.bucket_lars_norms, "launches"),
                (po.bucket_lars_norms, "trust_launches"),
                (po.bucket_lars_update, "launches")] if opt == "lars" \
        else [(po.bucket_adam, "launches")]
    with autotune.force(pallas_bnreluconv="pallas", fused_bucket_opt=True):
        trainer = parallel.DataParallelTrainer(
            net, loss.SoftmaxCrossEntropyLoss(), opt,
            mesh=parallel.get_mesh(), loss_scale="dynamic",
            compute_dtype="bfloat16", optimizer_sharding="ps",
            bucket_bound=30000, **kw)
        before = [getattr(f, a) for f, a in counters]
        losses = [float(trainer.fit_batch(x, y)) for _ in range(3)]
    n_b = len(trainer.step_fn.zero_plan)
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == \
        [n_b * 3] * len(counters)
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------- the plugin's scaled add
def _plugin():
    import os

    import mxnet_tpu_torch as mx

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return mx, mx.library.load(os.path.join(
        root, "mxnet_tpu_torch", "example", "plugin", "cuda_ops.py"),
        verbose=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "int64"])
@pytest.mark.parametrize("shape", ["one", "seven", "ragged", "empty",
                                   "transposed", "permuted", "strided",
                                   "misaligned"])
def test_scaled_add_bit_identical_to_plain(card, dtype, shape):
    """The kernel against ``x + y * s`` on the card, bit for bit and in
    the same layout: one element, an odd count, a ragged million, none,
    a transposed and a permuted view (taken as they lie), a strided
    view (copied first) and a view one element off 16-byte alignment
    (the scalar path)."""
    _, mod = _plugin()
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(5)
    n = {"one": 1, "seven": 7, "ragged": 1000003, "empty": 0,
         "transposed": 64 * 33, "permuted": 4 * 8 * 33, "strided": 2 * 999,
         "misaligned": 4099}[shape]
    raw = [torch.randn(n + 1, generator=gen, device=card) * 1000
           for _ in range(2)]
    x, y = (r.to(tdt) for r in raw)
    if shape == "misaligned":
        x, y = x[1:], y[1:]
    else:
        x, y = x[:n], y[:n]
    if shape == "transposed":
        x, y = x.reshape(64, 33).t(), y.reshape(64, 33).t()
    if shape == "permuted":
        x, y = (t.reshape(4, 8, 33).permute(2, 0, 1) for t in (x, y))
    if shape == "strided":
        x, y = x[::2], y[::2]
    scale = 0.1 if tdt.is_floating_point else 3.7
    before = mod.scaled_add.launches
    got = mod.scaled_add(x, y, scale)
    want = mod._scaled_add_plain(x, y, mod._scale_tensor(scale, tdt))
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == tdt
    assert torch.equal(got, want)
    if shape != "strided":
        assert got.stride() == want.stride()
    assert mod.scaled_add.launches == before + (1 if n else 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scaled_add_many_waves_bit_identical(card, dtype):
    """ResNet-50's second residual shape, 128x28x28x512 (51.4 M
    elements, many waves of CTAs), bit for bit."""
    _, mod = _plugin()
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(9)
    x, y = (torch.randn((128, 28, 28, 512), generator=gen, device=card)
            .to(tdt) for _ in range(2))
    before = mod.scaled_add.launches
    got = mod.scaled_add(x, y, 0.3)
    want = mod._scaled_add_plain(x, y, mod._scale_tensor(0.3, tdt))
    torch.cuda.synchronize()
    assert mod.scaled_add.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "uint8", "bool"])
def test_scaled_add_refuses_other_dtypes(card, dtype):
    _, mod = _plugin()
    x = torch.ones(8, device=card, dtype=getattr(torch, dtype))
    with pytest.raises(MXNetError, match="scaled_add kernel takes"):
        mod.scaled_add(x, x, 2.0)
    with pytest.raises(MXNetError, match="one shape"):
        mod.scaled_add(torch.ones(8, device=card), torch.ones(4, device=card),
                       2.0)


def test_nd_plugin_scaled_add_launches_the_kernel(card):
    mx, mod = _plugin()
    rng = onp.random.RandomState(2)
    a = mx.nd.array(rng.randn(4, 6, 8), ctx=mx.gpu(0), dtype="bfloat16")
    b = mx.nd.array(rng.randn(8), ctx=mx.gpu(0), dtype="bfloat16")
    a.attach_grad()
    b.attach_grad()
    before = mod.scaled_add.launches
    with mx.autograd.record():
        out = mx.nd.plugin_scaled_add(a, b, scale=0.5)
    out.backward()
    torch.cuda.synchronize()
    assert mod.scaled_add.launches == before + 1
    assert out.context == mx.gpu(0)
    want = a._data.detach() + b._data.detach() * torch.tensor(
        0.5, dtype=torch.bfloat16)
    assert torch.equal(out._data.detach(), want)
    assert torch.equal(a.grad._data, torch.ones_like(a._data))
    assert torch.equal(b.grad._data.float(),
                       torch.full((8,), 4 * 6 * 0.5, device=card))


# ------------------------------------------------ the Gluon training loop
def _gluon_step(net, trainer, x, y):
    from mxnet_tpu_torch import autograd, gluon

    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def test_gluon_lenet_step_on_card_matches_host(card):
    """One Gluon step of the example's LeNet (deferred shapes, SGD
    momentum) from the same weights on the card and on the host, TF32
    off, with a float64 host step as the yardstick, held as
    ``chip_smoke.py`` holds the card's ResNet steps (``CUDA_CPU_TOL``):
    the loss to 1e-5 relative; each parameter's update and momentum no
    farther from the float64 step's than twice the host's fp32 one,
    plus 1e-3 of its norm.  The first convolution's weight gradient
    takes that room: cuDNN's fp32 algorithm for it (one input channel,
    5x5) reads 2.4e-4 off float64 with TF32 off, where the host reads
    1.8e-6.  The parameters and states stay on the card."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.example import train_mnist

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = onp.random.RandomState(2)
    xs = rng.rand(8, 1, 28, 28).astype("float32")
    ys = rng.randint(0, 10, 8).astype("int32")
    with mx.cpu():
        host = train_mnist.build("lenet")
        host.initialize(mx.init.Xavier(),
                        generator=torch.Generator().manual_seed(0))
        host(mx.nd.zeros((1, 1, 28, 28)))  # resolves the deferred shapes
    before = {n: p.data().asnumpy().astype("float64")
              for n, p in host.collect_params().items()}
    got = {}
    try:
        for key, ctx, dtype in (("cpu", mx.cpu(), "float32"),
                                ("cpu64", mx.cpu(), "float64"),
                                ("cuda", mx.gpu(0), "float32")):
            net = copy.deepcopy(host).to(ctx.torch_device())
            net.cast(dtype)
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.02,
                                     "momentum": 0.9})
            loss = _gluon_step(net, trainer,
                               mx.nd.array(xs, ctx=ctx, dtype=dtype),
                               mx.nd.array(ys, ctx=ctx))
            params = net.collect_params()
            moms = trainer._updaters[0].states
            assert all(p.data().context == ctx for p in params.values())
            assert all(s.context == ctx for (s,) in moms.values())
            names = list(params)
            got[key] = (
                float(loss.asnumpy().astype("float64").mean()),
                {n: p.data().asnumpy().astype("float64") - before[n]
                 for n, p in params.items()},
                {names[i]: s.asnumpy().astype("float64")
                 for i, (s,) in moms.items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    card, host_, exact = got["cuda"], got["cpu"], got["cpu64"]
    assert abs(card[0] - host_[0]) <= 1e-5 * abs(host_[0])
    for k in (1, 2):
        for n, want in exact[k].items():
            norm = onp.linalg.norm(want)
            err_card = onp.linalg.norm(card[k][n] - want) / norm
            err_host = onp.linalg.norm(host_[k][n] - want) / norm
            assert err_card <= 2 * err_host + 1e-3, (n, err_card, err_host)


def test_gluon_resnet_steps_launch_fused_backward(card):
    """A tiny channel-last ResNetV1 (deferred stem, bf16 with
    multi_precision) trains through the Gluon loop on the card: one
    fused-backward launch per bottleneck per step, finite losses,
    running statistics that move, fp32 masters and momenta on the
    card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.ops import pallas_conv as pc

    with nn.default_layout("NHWC"):
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [8, 16, 32, 64, 128], classes=10,
                              no_bias=True, in_channels=0)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                   generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True})
    rng = onp.random.RandomState(0)
    x = mx.nd.array(rng.randn(8, 64, 64, 3).astype("float32"),
                    ctx=mx.gpu(0), dtype="bfloat16")
    y = mx.nd.array(rng.randint(0, 10, 8).astype("int32"), ctx=mx.gpu(0))
    with autotune.force(pallas_bnreluconv="pallas"):
        before = pc.bnreluconv_bwd.launches
        losses = [float(_gluon_step(net, trainer, x, y).asnumpy()
                        .mean())]
        stats = {n: p.data().asnumpy() for n, p in
                 net.collect_params().items() if "running" in n}
        losses += [float(_gluon_step(net, trainer, x, y).asnumpy()
                         .mean()) for _ in range(2)]
    assert pc.bnreluconv_bwd.launches - before == 4 * 3
    assert all(onp.isfinite(losses))
    params = net.collect_params()
    assert stats and all(not onp.array_equal(params[n].data().asnumpy(), v)
                         for n, v in stats.items())
    for i, state in trainer._updaters[0].states.items():
        # bf16 weights: (fp32 master, (momentum,)); BatchNorm's, which
        # cast keeps fp32: (momentum,)
        if params[list(params)[i]].dtype == "bfloat16":
            master, (mom,) = state
            assert master._data.dtype == torch.float32
            assert master._data.is_cuda
        else:
            (mom,) = state
        assert mom._data.dtype == torch.float32 and mom._data.is_cuda


def test_gluon_trainer_refuses_dist_kvstore(card):
    """A dist store outside a launched job is a group of one on the card:
    the Trainer's step through it equals the local step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    outs = []
    for kv in ("dist_sync", "dist_device_sync", "device"):
        mx.random.seed(0)
        net = gluon.nn.Dense(3, in_units=4)
        net.initialize(init=mx.init.Constant(0.5), ctx=mx.gpu(0))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv)
        x = mx.nd.ones((2, 4), ctx=mx.gpu(0))
        with autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
        assert net.weight.is_cuda
        outs.append(net.weight.detach().cpu().numpy())
    assert (outs[0] == outs[2]).all() and (outs[1] == outs[2]).all()


# ------------------------------------------------------- the symbolic half
def _mlp_symbol(sym):
    fc1 = sym.FullyConnected(sym.var("data"), num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.var("softmax_label"), name="softmax")


def _module_step(mx, ctx, arg, x, y, dtype="float32"):
    """One Module step (SGD momentum) of a small conv net with a
    BatchNorm on ``ctx``; float64 through the executor and updater."""
    s = mx.sym
    data = s.var("data")
    c = s.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                      name="c1")
    b = s.BatchNorm(c, fix_gamma=False, name="bn1")
    p = s.Pooling(s.Activation(b, act_type="relu"), global_pool=True,
                  kernel=(1, 1), pool_type="avg")
    net = s.SoftmaxOutput(s.FullyConnected(p, num_hidden=5, name="fc"),
                          s.var("softmax_label"), name="softmax")
    with ctx:
        mod = mx.mod.Module(net, context=ctx)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        if dtype == "float64":
            for store in (mod._exec.arg_dict, mod._exec.aux_dict,
                          mod._exec.grad_dict):
                for a in store.values():
                    a._adopt(a._data.to(torch.float64))
        arg_nd = {n: mx.nd.array(v, ctx=ctx, dtype=dtype)
                  for n, v in arg.items() if not n.startswith("bn1_moving")}
        aux_nd = {n: mx.nd.array(v, ctx=ctx, dtype=dtype)
                  for n, v in arg.items() if n.startswith("bn1_moving")}
        mod.set_params(arg_nd, aux_nd)
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),
                                             ("momentum", 0.9)))
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x, ctx=mx.cpu(), dtype=dtype)],
            [mx.nd.array(y, ctx=mx.cpu(), dtype=dtype)]))
        mod.update()
        ex = mod._exec
        on = [a.context for a in list(ex.arg_dict.values())
              + list(ex.grad_dict.values()) + list(ex.aux_dict.values())]
        return ({n: ex.arg_dict[n].asnumpy().astype("float64")
                 for n in arg if n in ex.arg_dict},
                {n: st[0].asnumpy().astype("float64")
                 for n, st in mod._updater.states.items()},
                {n: a.asnumpy().astype("float64")
                 for n, a in ex.aux_dict.items()}, on)


def test_module_step_on_card_matches_host(card):
    """One ``mx.mod.Module`` step (host batches fed to the card) from the
    same parameters on the card and on the host, TF32 off, with a float64
    step as the yardstick: each parameter, momentum and moving statistic
    no farther from float64 than twice the host's fp32 one plus 1e-3 of
    its norm (``chip_smoke.CUDA_CPU_TOL``); everything bound stays on the
    card."""
    import mxnet_tpu_torch as mx

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = onp.random.RandomState(4)
    x = rng.randn(8, 3, 10, 10).astype("float32")
    y = rng.randint(0, 5, 8).astype("float32")
    arg = {"c1_weight": rng.randn(8, 3, 3, 3) * 0.2,
           "c1_bias": rng.randn(8) * 0.1, "bn1_gamma": rng.rand(8) + 0.5,
           "bn1_beta": rng.randn(8) * 0.1, "fc_weight": rng.randn(5, 8),
           "fc_bias": rng.randn(5) * 0.1,
           "bn1_moving_mean": rng.randn(8) * 0.1,
           "bn1_moving_var": rng.rand(8) + 0.5}
    try:
        cuda = _module_step(mx, mx.gpu(0), arg, x, y)
        host = _module_step(mx, mx.cpu(), arg, x, y)
        exact = _module_step(mx, mx.cpu(), arg, x, y, "float64")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert all(c == mx.gpu(0) for c in cuda[3])
    for k in range(3):
        for n, want in exact[k].items():
            if n == "c1_bias":
                continue  # a BatchNorm follows: its gradient is 0
            norm = onp.linalg.norm(want - (arg[n] if k != 1 else 0))
            err_card = onp.linalg.norm(cuda[k][n] - want) / norm
            err_host = onp.linalg.norm(host[k][n] - want) / norm
            assert err_card <= 2 * err_host + 1e-3, (k, n, err_card,
                                                     err_host)


def test_module_default_context_is_the_card(card):
    import mxnet_tpu_torch as mx

    mod = mx.mod.Module(_mlp_symbol(mx.sym))
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))])
    mod.init_params()
    ex = mod._exec
    assert all(a._data.device == card for a in
               list(ex.arg_dict.values()) + list(ex.grad_dict.values()))
    # host arrays given to bind are moved, never left on the host
    s = _mlp_symbol(mx.sym)
    args = {n: mx.nd.zeros(sh, ctx=mx.cpu()) for n, sh in zip(
        s.list_arguments(),
        s.infer_shape(data=(2, 10), softmax_label=(2,))[0])}
    ex = s.bind(None, args)
    assert all(a._data.device == card for a in ex.arg_arrays)
    out = ex.forward(data=mx.nd.ones((2, 10), ctx=mx.cpu()))
    assert out[0]._data.device == card


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 7, 7, 64, 256), (3, 5, 5, 24, 40),
                                   (1, 3, 3, 8, 250)])
def test_symbol_bnreluconv_launches_the_kernel(card, dtype, shape):
    """``sym._contrib_BNReluConv`` bound on the card: one fused-backward
    launch per backward, gradients held against the plain version by
    ``chip_smoke.BRC_TOL``; the shapes the Gluon fused tail takes
    (ragged rows, channels not a multiple of 8) are taken here too."""
    import mxnet_tpu_torch as mx
    from chip_smoke import BRC_TOL
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import pallas_conv as pc

    n, h, w, ci, co = shape
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(1)
    feeds = {"u": torch.randn((n, h, w, ci), generator=gen,
                              device=card).to(tdt),
             "gamma": torch.rand((ci,), generator=gen, device=card) + 0.5,
             "beta": torch.randn((ci,), generator=gen, device=card) * 0.3,
             "weight": (torch.randn((co, 1, 1, ci), generator=gen,
                                    device=card) * 0.1).to(tdt)}
    s = mx.sym._contrib_BNReluConv(*[mx.sym.var(k) for k in feeds])
    ex = s.simple_bind(mx.gpu(0), type_dict={k: v.dtype
                                             for k, v in feeds.items()},
                       **{k: tuple(v.shape) for k, v in feeds.items()})
    before = pc.bnreluconv_bwd.launches
    ex.forward(is_train=True, **{k: mx.nd.NDArray(v)
                                 for k, v in feeds.items()})
    ex.backward()
    assert pc.bnreluconv_bwd.launches == before + 1
    ug = {k: v.clone().requires_grad_(True) for k, v in feeds.items()}
    with autotune.force(pallas_bnreluconv="jnp"):
        outs = pc.fused_bn_relu_conv1x1(*ug.values())
        torch.autograd.backward(list(outs),
                                [torch.ones_like(o) for o in outs])
    assert pc.bnreluconv_bwd.launches == before + 1
    d_tol, s_tol = BRC_TOL[dtype]
    for k, tol in (("u", d_tol), ("gamma", s_tol), ("beta", s_tol),
                   ("weight", s_tol)):
        got, want = ex.grad_dict[k]._data.float(), ug[k].grad.float()
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max()), k


def test_symbol_bnreluconv_never_takes_the_plain_version(card,
                                                         monkeypatch):
    """Whatever the variant settings say, the registered op's backward
    on the card is the kernel."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import pallas_conv as pc

    monkeypatch.setenv("MXNET_PALLAS", "0")
    u = mx.nd.NDArray(torch.randn((2, 4, 4, 16), device=card))
    g = mx.nd.NDArray(torch.ones((16,), device=card))
    b = mx.nd.NDArray(torch.zeros((16,), device=card))
    w = mx.nd.NDArray(torch.randn((32, 1, 1, 16), device=card) * 0.1)
    for a in (u, g, b, w):
        a.attach_grad()
    before = pc.bnreluconv_bwd.launches
    with autotune.force(pallas_bnreluconv="stock"):
        with mx.autograd.record():
            y, _, _ = mx.nd._contrib_BNReluConv(u, g, b, w)
        y.backward()
    assert pc.bnreluconv_bwd.launches == before + 1


def test_out_of_range_indices_leave_the_card_alive(card):
    import mxnet_tpu_torch as tmx

    x = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    idx = onp.arange(-5, 7, dtype=onp.float32)

    def calls(ctx):
        nd = tmx.nd
        return [nd.pick(nd.array(onp.tile(x[:1], (12, 1)), ctx=ctx),
                        nd.array(idx, ctx=ctx)),
                nd.Embedding(nd.array(idx, ctx=ctx), nd.array(x, ctx=ctx),
                             input_dim=3, output_dim=4),
                nd.gather_nd(nd.array(x, ctx=ctx),
                             nd.array(onp.stack([idx, idx]), ctx=ctx))]

    on_card = [a.asnumpy() for a in calls(tmx.gpu(0))]
    torch.cuda.synchronize()
    on_host = [a.asnumpy() for a in calls(tmx.cpu())]
    for c, h in zip(on_card, on_host):
        onp.testing.assert_array_equal(c, h)
    assert onp.isnan(on_card[0]).sum() == 4  # -5, 4, 5 and 6
    assert float(torch.ones(8, device=card).sum()) == 8.0


def test_dropout_masks_follow_the_key_on_card(card):
    from mxnet_tpu_torch import _rng
    from mxnet_tpu_torch.ops.nn import dropout

    x = torch.ones(64, 256, device=card)

    def masked(key):
        with _rng.key_scope(key):
            return dropout(x, p=0.5, train=True,
                           key=_rng.take_key(card)) != 0

    a, b, c = masked(3), masked(3), masked(4)
    assert a.device == card and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert abs(float(a.float().mean()) - 0.5) < 0.02


# ------------------------------------------------------------ the RNN op
def _rnn_inputs(mode, layers, bi, dtype, device, seed=0, T=7, N=3, I=5,
                H=8):
    from mxnet_tpu_torch.ops import rnn as rnn_op

    d = 2 if bi else 1
    rs = onp.random.RandomState(seed)
    n = rnn_op.rnn_param_size(mode, layers, I, H, bi)
    arrays = [rs.randn(T, N, I), rs.randn(n) * 0.3,
              rs.randn(layers * d, N, H)]
    if mode == "lstm":
        arrays.append(rs.randn(layers * d, N, H))
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi,
              state_outputs=True)
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays], kw


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False),
                                     ("rnn_tanh", True)])
def test_rnn_op_runs_cudnn_on_card(card, mode, bi):
    """On a CUDA tensor the op runs its cuDNN arm (one call a layer, no
    loop) and agrees with the host's loop to 1e-4 of each output's
    largest magnitude (fp32, TF32 off), gradients included."""
    from mxnet_tpu_torch.ops import rnn as rnn_op

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {}
        for dev in ("cpu", card):
            ts, kw = _rnn_inputs(mode, 2, bi, torch.float32, dev)
            for t in ts:
                t.requires_grad_()
            rnn_op.cudnn_layer.launches = rnn_op.loop_layer.launches = 0
            outs = rnn_op.rnn(*ts, **kw)
            sum(o.sum() for o in outs).backward()
            res[str(dev)] = [o.detach().cpu() for o in outs] + \
                [t.grad.cpu() for t in ts]
            calls = (rnn_op.cudnn_layer.launches, rnn_op.loop_layer.launches)
            assert calls == ((0, 2) if dev == "cpu" else (2, 0))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for g, w in zip(res[str(card)], res["cpu"]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_rnn_op_raises_where_cudnn_refuses(card):
    from mxnet_tpu_torch.ops import rnn as rnn_op

    ts, kw = _rnn_inputs("lstm", 1, False, torch.bfloat16, card)
    rnn_op.loop_layer.launches = 0
    with pytest.raises(MXNetError, match="cuDNN"):
        rnn_op.rnn(*ts, **kw)
    assert rnn_op.loop_layer.launches == 0


def test_gluon_lstm_trains_on_card(card):
    """A Gluon LSTM on ``mx.gpu(0)``: the step under ``record()`` runs
    cuDNN, the parameters stay on the card and move."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as rnn_op

    layer = mx.gluon.rnn.LSTM(16, num_layers=2, dropout=0.3, input_size=8)
    layer.initialize(ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(layer.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    x = mx.nd.array(onp.random.RandomState(0).randn(6, 4, 8), ctx=mx.gpu(0))
    rnn_op.cudnn_layer.launches = rnn_op.loop_layer.launches = 0
    before = {n: p.data().asnumpy() for n, p in
              layer.collect_params().items()}
    with mx.autograd.record():
        out = layer(x)
    out.backward()
    trainer.step(4)
    assert (rnn_op.cudnn_layer.launches, rnn_op.loop_layer.launches) == (2, 0)
    for n, p in layer.collect_params().items():
        assert p.data()._data.is_cuda
        assert not onp.array_equal(p.data().asnumpy(), before[n]), n


# ------------------------------------------------------ detection ops
def _det_inputs(seed=0, batch=4, n=600, m=3):
    """Anchors, labels, class logits and probabilities, location
    predictions and box_nms rows on the host."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 2, generator=g) * 0.8
    anchors = torch.cat([xy, xy + torch.rand(n, 2, generator=g) * 0.2
                         + 0.02], 1)[None]
    labels = torch.full((batch, m, 5), -1.0)
    for b in range(batch):
        for k in range(1 + b % m):
            lo = torch.rand(2, generator=g) * 0.6
            labels[b, k] = torch.cat([torch.tensor([float(k + b)]), lo,
                                      lo + 0.3])
    logits = torch.randn(batch, 6, n, generator=g)
    loc = torch.randn(batch, n * 4, generator=g) * 0.5
    score = torch.rand(batch, n, 1, generator=g)
    score[:, 1::2] = score[:, 0::2]
    rows = torch.cat([torch.randint(-1, 5, (batch, n, 1), generator=g)
                      .float(), score, anchors.expand(batch, n, 4)], -1)
    return {"anchors": anchors, "labels": labels, "logits": logits,
            "prob": torch.softmax(logits * 3, 1), "loc": loc, "rows": rows}


def test_detection_ops_on_card_match_host(card):
    """MultiBoxTarget (positives, masks and negatives identical: no
    score ties at the mining boundary here), MultiBoxDetection and
    box_nms (ids and kept rows identical, values to 1e-5), the sort ops
    (identical on ties)."""
    from mxnet_tpu_torch.ops import detection_ops as det
    from mxnet_tpu_torch.ops import sort_ops

    h = _det_inputs()
    c = {k: v.to(card) for k, v in h.items()}
    for fn in (
            lambda t: det.multibox_target(t["anchors"], t["labels"],
                                          t["logits"],
                                          negative_mining_ratio=3.0),
            lambda t: (det.multibox_detection(t["prob"], t["loc"],
                                              t["anchors"], nms_topk=400),),
            lambda t: (det.box_nms(t["rows"], topk=400, id_index=0),),
            lambda t: sort_ops.topk(torch.round(t["prob"] * 10),
                                    k=50, ret_typ="both"),
            lambda t: (sort_ops.argsort(torch.round(t["prob"] * 10)),)):
        for a, b in zip(fn(c), fn(h)):
            a = a.cpu()
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5
            if a.dim() == 3 and a.shape[-1] == 6:
                assert torch.equal(a[..., 0], b[..., 0])


def test_roi_ops_gradients_on_card_match_host(card):
    from mxnet_tpu_torch.ops import detection_ops as det

    g = torch.Generator().manual_seed(3)
    data = torch.randn(2, 8, 19, 25, generator=g)
    data[0, :, :6, :6] = 0.5  # tied maxima
    rois = torch.tensor([[0, 3.0, 2.0, 200.0, 150.0], [1, 0.0, 0.0, 90.0,
                                                        70.0],
                         [0, 250.0, 200.0, 500.0, 400.0]])  # past the edge
    head = torch.randn(3, 8, 7, 7, generator=g)
    for fn, kw in ((det.roi_pooling, {}), (det.roi_align, {}),
                   (det.roi_align, {"aligned": True})):
        res = []
        for dev in (card, torch.device("cpu")):
            d = data.detach().to(dev).requires_grad_()
            out = fn(d, rois.to(dev), pooled_size=(7, 7),
                     spatial_scale=1 / 16, **kw)
            out.backward(head.to(dev))
            res.append((out.detach().cpu(), d.grad.cpu()))
        for a, b in zip(*res):
            assert float((a - b).abs().max()) <= 1e-5 * float(
                b.abs().max())


def test_targets_and_detection_make_no_host_sync(card):
    from mxnet_tpu_torch.ops import detection_ops as det

    c = {k: v.to(card) for k, v in _det_inputs(seed=1).items()}
    calls = (lambda: det.multibox_target(c["anchors"], c["labels"],
                                         c["logits"],
                                         negative_mining_ratio=3.0),
             lambda: det.multibox_detection(c["prob"], c["loc"],
                                            c["anchors"], nms_topk=400),
             lambda: det.box_nms(c["rows"], topk=400, id_index=0))
    for fn in calls:
        fn()  # warm-up
        torch.cuda.synchronize()
        with host_syncs() as hs:
            fn()
        assert hs.count == 0


# ------------------------------------------- hybridize as CUDA graphs
def _tiny_resnet(seed=0):
    """A channel-last bottleneck ResNetV1 in bf16 (deferred stem), as
    ``GLUON_RESNET`` builds it, at a few channels: 4 fused tails."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

    with nn.default_layout("NHWC"):
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [8, 16, 32, 64, 128], classes=10,
                              no_bias=True, in_channels=0, prefix="net_")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                   generator=torch.Generator().manual_seed(seed))
    net.cast("bfloat16")
    return net


def _tiny_batch(seed=0, n=8):
    import mxnet_tpu_torch as mx

    rng = onp.random.RandomState(seed)
    x = mx.nd.array(rng.randn(n, 64, 64, 3).astype("float32"),
                    ctx=mx.gpu(0), dtype="bfloat16")
    y = mx.nd.array(rng.randint(0, 10, n).astype("int32"), ctx=mx.gpu(0))
    return x, y


def _train_tiny(hybrid, steps=3, seed=0):
    """``steps`` Gluon steps of the tiny ResNet, the fused tail's kernel
    forced, cuDNN deterministic: the losses and the parameters after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, gluon

    net = _tiny_resnet(seed)
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True})
    x, y = _tiny_batch(seed)
    losses = []
    with autotune.force(pallas_bnreluconv="pallas"):
        for _ in range(steps):
            losses.append(_gluon_step(net, trainer, x, y)._data.clone())
    torch.cuda.synchronize()
    return net, losses, {n: p.data()._data.clone() for n, p in
                         net.collect_params().items()}


@pytest.fixture
def deterministic():
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def test_graphed_steps_equal_eager(card, deterministic):
    """Three Gluon steps through CUDA-graph replays equal three eager
    steps from the same weights, bit for bit: losses, every parameter
    and running statistic.  One cache entry, captured once."""
    from mxnet_tpu_torch.gluon import _graph

    before = _graph.captures
    _, eager_losses, eager_params = _train_tiny(False)
    net, losses, params = _train_tiny(True)
    assert _graph.captures - before == 1
    entries = list(net._cached_op.values())
    assert len(entries) == 1 and entries[0].graphed \
        and entries[0].calls == 3
    for a, b in zip(losses, eager_losses):
        assert torch.equal(a, b)
    for n in eager_params:
        assert torch.equal(params[n], eager_params[n]), n


def test_fused_backward_runs_inside_the_replay(card):
    """The fused tail's backward kernel is launched from the captured
    backward graph: once per bottleneck in a replayed step, by kernel
    name, and the wrapper is not called again."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, gluon
    from mxnet_tpu_torch.ops import pallas_conv as pc

    net = _tiny_resnet()
    net.hybridize(static_alloc=True, static_shape=True)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "multi_precision": True})
    x, y = _tiny_batch()
    with autotune.force(pallas_bnreluconv="pallas"):
        _gluon_step(net, trainer, x, y)  # warm-up and capture
        torch.cuda.synchronize()
        calls = pc.bnreluconv_bwd.launches
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            _gluon_step(net, trainer, x, y)
            torch.cuda.synchronize()
    assert pc.bnreluconv_bwd.launches == calls
    dact = sum(e.count for e in prof.key_averages()
               if "dact_mma_kernel" in e.key)
    assert dact == 4
    assert net.output.weight.is_cuda


def test_capture_freezes_the_fused_tail_arm(card):
    """The fused tail's arm in force when a signature is captured is the
    one its replays run, as the reference's jit keeps the arm of its
    first trace: captured under ``pallas``, a replay outside the scope
    still launches the kernel; after ``hybridize()`` clears the cache,
    a capture under ``stock`` launches none."""
    from mxnet_tpu_torch import autotune, gluon

    net = _tiny_resnet()
    net.hybridize(static_alloc=True, static_shape=True)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "multi_precision": True})
    x, y = _tiny_batch()
    counts = []
    for arm, capture in (("pallas", True), (None, False), ("stock", True)):
        if capture:
            net.hybridize(static_alloc=True, static_shape=True)
        scope = autotune.force(pallas_bnreluconv=arm) if arm else \
            contextlib.nullcontext()
        with scope:
            if capture:
                _gluon_step(net, trainer, x, y)
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                _gluon_step(net, trainer, x, y)
                torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if "dact_mma_kernel" in e.key))
    assert counts == [4, 4, 0]


def test_held_outputs_and_gradients_survive_replays(card):
    """A replay writes the graph's static buffers: an output, a loss
    and a gradient the caller holds keep their values through the next
    replays."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    net = _tiny_resnet()
    net.hybridize(static_alloc=True, static_shape=True)
    x, y = _tiny_batch(0)
    x2, _ = _tiny_batch(1)
    out1 = net(x)
    keep = out1._data.clone()
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    w = net.collect_params()["net_dense0_weight"]
    g1 = w.grad()._data  # the tensor backward wrote; the buffer moves on
    g1_keep = g1.clone()
    loss_keep = loss._data.clone()
    for _ in range(2):
        net(x2)
        with autograd.record():
            l2 = gluon.loss.SoftmaxCrossEntropyLoss()(net(x2), y)
        l2.backward()
    torch.cuda.synchronize()
    assert torch.equal(out1._data, keep)
    assert torch.equal(loss._data, loss_keep)
    assert torch.equal(g1, g1_keep)
    assert not torch.equal(w.grad()._data, g1_keep)
    assert len(net._cached_op) == 2  # predicting and recording
    assert mx.gpu(0) == out1.context


def test_graphed_block_called_twice_in_one_record(card, deterministic):
    """A block called twice inside one ``record()`` (a GAN's
    discriminator on real and fake data): the second call, made while
    the first replay is held, captures a program on its own pool, and
    one backward gives eager's gradients bit for bit.  The next step
    replays the two programs again, and a second backward of one replay
    raises."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import _graph

    x, _ = _tiny_batch(0)
    x2, _ = _tiny_batch(1)
    grads = {}
    for hybrid in (False, True):
        net = _tiny_resnet()
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
        before = _graph.captures
        for _ in range(2):
            with autograd.record():
                loss = net(x).sum() + net(x2).sum()
            loss.backward()
        grads[hybrid] = {n: p.grad()._data.clone()
                         for n, p in net.collect_params().items()
                         if p.grad_req != "null"}
    assert _graph.captures - before == 2
    entries = list(net._cached_op.values())
    assert len(entries) == 1 and len(entries[0].programs) == 2 \
        and entries[0].calls == 4
    for n, g in grads[False].items():
        assert torch.equal(grads[True][n], g), n
    with autograd.record():
        loss = net(x).sum()
    loss.backward(retain_graph=True)
    with pytest.raises(Exception, match="runs once"):
        loss.backward()
    assert len(entries[0].programs) == 2


def test_static_child_of_a_plain_block_is_captured(card):
    """On the card, a child hybridized with both static flags under a
    plain ``Sequential`` (which hands it tensors) replays CUDA graphs of
    its own, and predicts and trains as the eager net (1e-6)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    rng = onp.random.RandomState(0)
    x = mx.nd.array(rng.randn(4, 8).astype("float32"), ctx=mx.gpu(0))
    res = {}
    for hybrid in (False, True):
        onp.random.seed(0)
        net = nn.Sequential(prefix="seq_")
        with net.name_scope():
            net.add(nn.Dense(16, in_units=8, activation="relu"),
                    nn.Dense(4, in_units=16))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
        pred = net(x)._data.clone()
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        res[hybrid] = [pred, loss._data.clone()] + [
            p.grad()._data.clone() for p in net.collect_params().values()]
        if hybrid:
            assert all(len(c._cached_op) == 2 and all(
                e.graphed for e in c._cached_op.values()) for c in net)
    for a, b in zip(res[True], res[False]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_graphed_dropout_draws_fresh_masks_and_follows_keys(card):
    """A Dropout net captured with both static flags: each replay draws
    a fresh mask, equal keys give equal masks, and the masks are the
    ones an eager call draws from the same generator state."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _rng, autograd
    from mxnet_tpu_torch.gluon import nn

    def build(hybrid):
        net = nn.HybridSequential(prefix="drop_")
        with net.name_scope():
            net.add(nn.Dense(64, in_units=32), nn.Dropout(0.5))
        net.initialize(mx.init.One(), ctx=mx.gpu(0))
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
        return net

    x = mx.nd.ones((16, 32), ctx=mx.gpu(0))
    outs = {}
    for hybrid in (False, True):
        net = build(hybrid)
        mx.random.seed(5)
        with autograd.train_mode():
            free = [net(x)._data.clone() for _ in range(3)]
            keyed = []
            for k in (7, 7, 8):
                with _rng.key_scope(k):
                    keyed.append(net(x)._data.clone())
        outs[hybrid] = free + keyed
    eager, graphed = outs[False], outs[True]
    assert not torch.equal(graphed[0], graphed[1])
    assert not torch.equal(graphed[1], graphed[2])
    assert torch.equal(graphed[3], graphed[4])
    assert not torch.equal(graphed[4], graphed[5])
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)


def test_uncapturable_block_raises_naming_the_op(card):
    """A block that reads a value on the host cannot be captured: static
    hybridize raises and names the op, it does not run eagerly."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridLambda(lambda F, x: x * float(x.sum().asscalar()))
    net.hybridize(static_alloc=True, static_shape=True)
    with pytest.raises(MXNetError, match="cannot be captured"):
        net(mx.nd.ones((4,), ctx=mx.gpu(0)))
    assert not net._cached_op


def test_export_on_card_writes_the_host_bytes(card, tmp_path):
    """``export`` of a net on the card writes the bytes that a host copy
    of it writes, and ``SymbolBlock.imports`` on the card predicts as
    the net."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.symbol import symbol as sym

    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = mx.nd.array(onp.random.RandomState(0).rand(2, 3, 32, 32),
                    ctx=mx.gpu(0))
    with autograd.record():
        net(x)  # the running statistics move
    host = copy.deepcopy(net)
    host.collect_params().reset_ctx(mx.cpu())
    files = {}
    for where, block in (("card", net), ("host", host)):
        sym._UNNAMED_COUNT.clear()
        block.export(str(tmp_path / where))
        files[where] = [(tmp_path / f"{where}{s}").read_bytes()
                        for s in ("-symbol.json", "-0000.params")]
    assert files["card"] == files["host"]
    sb = gluon.SymbolBlock.imports(str(tmp_path / "card-symbol.json"),
                                   ["data"],
                                   str(tmp_path / "card-0000.params"),
                                   ctx=mx.gpu(0))
    got, want = sb(x)._data, net(x)._data
    assert got.is_cuda
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


# ------------------------------------------------- serving on the card
def _served_net(seed=0):
    """A ResNet-18 v1 (10 classes) on the card, the host's weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    onp.random.seed(seed)
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def _images(n, seed=1):
    return onp.random.RandomState(seed).rand(n, 3, 32, 32).astype("float32")


def _eager_rows(net, x):
    import mxnet_tpu_torch as mx

    return net(mx.nd.array(x, ctx=mx.gpu(0)))._data.cpu().numpy()


@contextlib.contextmanager
def _cudnn_deterministic():
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev


def test_each_served_bucket_replays_eager_bit_for_bit(card, tmp_path):
    """Every bucket of a ``from_predictor`` server and the one bucket of
    a ``from_artifact`` server run a captured graph whose rows equal the
    net's eager forward of the same batch bit for bit; one capture per
    bucket at warm-up, none after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import _graph
    from mxnet_tpu_torch.parallel import functionalize
    from mxnet_tpu_torch.serving import ModelServer

    with _cudnn_deterministic():
        net = _served_net()
        x = _images(8)
        params, apply_fn = functionalize(net)
        c0 = _graph.captures
        srv = ModelServer.from_predictor(apply_fn, params, x,
                                         candidates=(1,), tune_iters=2,
                                         slo_ms=60000)
        c1 = _graph.captures
        srv.start(warm=True)
        try:
            assert _graph.captures - c1 == len(srv.buckets) == 4
            for b in srv.buckets:
                got = srv._model_fn(x[:b])
                assert onp.array_equal(got, _eager_rows(net, x[:b])), b
            assert _graph.captures - c1 == 4
        finally:
            srv.close()
        path = str(tmp_path / "r18.mxje")
        mx.deploy.export_model(net, mx.nd.array(x, ctx=mx.gpu(0)), path)
        srv = ModelServer.from_artifact(path, slo_ms=60000)
        c2 = _graph.captures
        srv.start(warm=True)
        try:
            assert _graph.captures - c2 == 1
            assert onp.array_equal(srv._model_fn(x), _eager_rows(net, x))
            row = srv.submit(x[3]).result(timeout=60)
            assert row.shape == (10,)
        finally:
            srv.close()
        assert c1 - c0 == 1  # the race's one candidate


def test_retraces_stay_zero_after_warmup(card):
    """Single rows from several threads, so batches of every size pad to
    the buckets: 0 retraces and no capture after warm-up."""
    import threading

    from mxnet_tpu_torch.gluon import _graph
    from mxnet_tpu_torch.parallel import functionalize
    from mxnet_tpu_torch.serving import ModelServer

    net = _served_net()
    x = _images(16)
    params, apply_fn = functionalize(net)
    srv = ModelServer.from_predictor(apply_fn, params, x[:8],
                                     candidates=(1, 2), tune_iters=2,
                                     slo_ms=60000, coalesce_ms=1.0)
    srv.start(warm=True)
    c0 = _graph.captures
    outs = []
    try:
        def client(k):
            for i in range(12):
                outs.append(srv.submit(x[(k + i) % 16]).result(timeout=60))

        ts = [threading.Thread(target=client, args=(k,)) for k in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = srv.stats
    finally:
        srv.close()
    assert len(outs) == 72 and st["completed"] == 72
    assert st["retraces"] == 0 and _graph.captures == c0
    assert st["warm_traces"] == len(srv.buckets)


def test_capture_beside_a_live_batcher_raises_nothing(card, tmp_path):
    """A second server captures its graph (warm start) while the first
    serves clients: no request fails, both answer as their nets."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ModelServer

    net_a, net_b = _served_net(0), _served_net(1)
    x = _images(8)
    paths = {}
    for name, net in (("a", net_a), ("b", net_b)):
        paths[name] = str(tmp_path / f"{name}.mxje")
        mx.deploy.export_model(net, mx.nd.array(x, ctx=mx.gpu(0)),
                               paths[name])
    want_a, want_b = _eager_rows(net_a, x), _eager_rows(net_b, x)
    a = ModelServer.from_artifact(paths["a"], slo_ms=60000,
                                  coalesce_ms=0.5).start()
    stop = threading.Event()
    errors, rows = [], []

    def client(k):
        i = k
        while not stop.is_set():
            try:
                rows.append((i % 8, a.submit(x[i % 8]).result(timeout=60)))
            except Exception as e:  # noqa: BLE001 — counted, asserted 0
                errors.append(repr(e))
            i += 1

    ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    try:
        b = ModelServer.from_artifact(paths["b"], slo_ms=60000).start()
        got_b = b.submit(x[2]).result(timeout=60)
        b.close()
    finally:
        stop.set()
        for t in ts:
            t.join()
        a.close()
    assert not errors, errors[:3]
    assert rows
    scale = float(onp.abs(want_a).max())
    for i, r in rows:
        assert float(onp.abs(r - want_a[i]).max()) <= 1e-4 * scale
    assert float(onp.abs(got_b - want_b[2]).max()) <= 1e-4 * float(
        onp.abs(want_b).max())


def test_swap_under_load_fails_no_request_on_card(card, tmp_path):
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ModelHost

    nets = [_served_net(0), _served_net(1)]
    x = _images(8)
    paths = []
    for k, net in enumerate(nets):
        paths.append(str(tmp_path / f"v{k}.mxje"))
        mx.deploy.export_model(net, mx.nd.array(x, ctx=mx.gpu(0)), paths[k])
    host = ModelHost(hbm_budget_mb=4096, server_kw={"slo_ms": 60000,
                                                    "coalesce_ms": 0.5})
    host.load("m", paths[0])
    stop = threading.Event()
    errors, n = [], [0]

    def client(k):
        i = k
        while not stop.is_set():
            try:
                host.submit(x[i % 8], model="m").result(timeout=60)
                n[0] += 1
            except Exception as e:  # noqa: BLE001 — counted, asserted 0
                errors.append(repr(e))
            i += 1

    ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    try:
        swap_ms = host.swap("m", paths[1])
        after = host.submit(x[5], model="m").result(timeout=60)
    finally:
        stop.set()
        for t in ts:
            t.join()
        host.close_all()
    assert not errors, errors[:3]
    assert swap_ms > 0 and n[0] > 0
    want = _eager_rows(nets[1], x)[5]
    assert float(onp.abs(after - want).max()) <= 1e-4 * float(
        onp.abs(want).max())


def test_model_fault_on_card_trips_breaker_never_runs_on_host(card,
                                                              tmp_path):
    """A net whose outputs are non-finite on the card fails every batch
    there: the breaker counts the failures and trips; no batch ever runs
    on the host."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ModelServer, ServeRejected

    net = _served_net(2)
    w = next(iter(net.collect_params().values()))  # the stem's weight
    w.set_data(mx.nd.full(w.shape, float("nan"), ctx=mx.gpu(0)))
    x = _images(4)
    path = str(tmp_path / "nan.mxje")
    mx.deploy.export_model(net, mx.nd.array(x, ctx=mx.gpu(0)), path)
    srv = ModelServer.from_artifact(path, slo_ms=60000, breaker_limit=2,
                                    coalesce_ms=0.0)
    devices = []
    fn = srv._model_fn._fn

    def watched(t):
        devices.append(t.device.type)
        return fn(t)

    srv._model_fn._fn = watched
    srv.start(warm=True)
    try:
        reasons = []
        for i in range(2):
            with pytest.raises(ServeRejected) as e:
                srv.submit(x[i]).result(timeout=60)
            reasons.append(e.value.reason)
        st = srv.stats
        assert reasons == ["model_error"] * 2
        assert st["model_failures"] == 2 and st["breaker_trips"] == 1
        assert srv.health()["breaker"] == "open"
        with pytest.raises(ServeRejected, match="breaker_open"):
            srv.submit(x[0])
    finally:
        srv.close()
    assert devices and set(devices) == {"cuda"}


# ------------------------------------------- quantized and mixed precision
#: fp8 products against the plain fp32 product of the same e4m3 values,
#: over its largest |value| (``chip_smoke.QUANT["fp8_product_tol"]``)
FP8_PRODUCT_TOL = 1e-3


def _codes(shape, card, gen):
    return torch.randint(-127, 128, shape, generator=gen, device=card,
                         dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (16, 2048, 1000),
                                   (17, 64, 24), (40, 5, 7)])
def test_int8_products_equal_the_exact_host_result(card, m, k, n):
    """``torch._int_mm`` through the padding rules (m past 16 rows, k and
    n to multiples of 8) equals the host's exact product bit for bit."""
    from mxnet_tpu_torch.ops import quantization_ops as Q

    g = torch.Generator(device=card).manual_seed(m * k + n)
    a, w = _codes((m, k), card, g), _codes((n, k), card, g)
    Q.reset_counts()
    acc = Q._int8_gemm(a, w)
    assert Q.counts()["int_mm"] == 1 and acc.dtype == torch.int32
    exact = (a.cpu().double() @ w.cpu().double().t()).to(torch.int64)
    assert torch.equal(acc.cpu().to(torch.int64), exact)


@pytest.mark.parametrize("m,k,n", [(1, 147, 64), (32, 2048, 1000)])
def test_fp8_products_within_the_bound_of_the_plain_product(card, m, k,
                                                             n):
    from mxnet_tpu_torch.ops import quantization_ops as Q

    g = torch.Generator(device=card).manual_seed(k)
    a, w = ((torch.randn(s, generator=g, device=card) * 100).clamp(
        -448, 448).to(torch.float8_e4m3fn) for s in ((m, k), (n, k)))
    scale = torch.full((), 2.5e-5, device=card)
    Q.reset_counts()
    out = Q._fp8_gemm(a, w, scale)
    assert Q.counts()["scaled_mm"] == 1 and out.dtype == torch.float32
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain = (a.float() @ w.float().t()) * scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert float((out - plain).abs().max() / plain.abs().max()) <= \
        FP8_PRODUCT_TOL


@pytest.mark.parametrize("kw", [dict(kernel=(7, 7), stride=(2, 2),
                                     pad=(3, 3)),
                                dict(kernel=(3, 3), pad=(1, 1),
                                     num_group=2),
                                dict(kernel=(1, 1))])
def test_quantized_conv_on_card_equals_the_host(card, kw):
    from mxnet_tpu_torch.ops import quantization_ops as Q

    g = torch.Generator(device=card).manual_seed(5)
    groups = kw.get("num_group", 1)
    x = _codes((2, 4, 12, 12), card, g)
    w = _codes((8, 4 // groups) + kw["kernel"], card, g)
    b = _codes((8,), card, g)
    r = [torch.tensor([v], device=card) for v in
         (-1.5, 2.0, -0.2, 0.3, -0.1, 0.1)]
    out = Q.quantized_conv(x, w, b, *r, num_filter=8, **kw)
    host = Q.quantized_conv(x.cpu(), w.cpu(), b.cpu(), *[t.cpu() for t in r],
                            num_filter=8, **kw)
    for a, h in zip(out, host):
        assert torch.equal(a.cpu(), h)


def test_quantized_net_replays_in_a_cuda_graph(card):
    """A rewritten net hybridized with both static flags captures its
    int8 ops (calibrated ranges are constants, nothing reads the host)
    and its replays equal the eager int8 forward bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import quantization
    from mxnet_tpu_torch.gluon import nn

    onp.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(16, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=16), nn.Activation("relu"),
            nn.Conv2D(16, 1, in_channels=16), nn.MaxPool2D(), nn.Flatten(),
            nn.Dense(10, in_units=16 * 8 * 8))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = onp.random.RandomState(1).randn(32, 3, 16, 16).astype("float32")
    cal = quantization.calibrate(net, [x], mode="naive")
    quantization.quantize_net(net, cal)
    xd = mx.nd.array(x, ctx=mx.gpu(0))
    eager = net(xd).asnumpy()
    net.hybridize(static_alloc=True, static_shape=True)
    for _ in range(3):
        onp.testing.assert_array_equal(net(xd).asnumpy(), eager)
    entry = next(iter(net._cached_op.values()))
    assert entry.graphed


def test_amp_loss_scaler_skips_a_planted_overflow_on_card(card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    net = mx.gluon.nn.Dense(8, in_units=16)
    net.initialize(ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    amp.init_trainer(trainer)
    x = mx.nd.ones((4, 16), ctx=mx.gpu(0))
    amp.init("bfloat16")
    try:
        with mx.autograd.record():
            out = net(x)
            with amp.scale_loss(out.astype("float32").sum(),
                                trainer) as scaled:
                scaled.backward()
    finally:
        amp._off()
    assert out._data.dtype == torch.bfloat16
    w = next(iter(net.collect_params().values()))
    w.data()._grad._data[0, 0] = float("inf")
    before = w.data()._data.clone()
    trainer.step(4)
    assert torch.equal(w.data()._data, before)
    assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 15


# ------------------------------------------------------ the data plane
def _card_jpegs(card, sizes, seed=0):
    from chip_smoke import smooth_images
    from mxnet_tpu_torch.io import nvjpeg

    enc = nvjpeg.decoder(card)
    return [enc.encode(img, 90, 2)
            for img in (smooth_images(1, hw, seed + k, card)[0]
                        for k, hw in enumerate(sizes))]


def test_image_augment_kernel_equals_plain_bit_for_bit(card):
    from mxnet_tpu_torch.io import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia

    jpegs = _card_jpegs(card, [(375, 500), (101, 99), (17, 300), (1, 1),
                               (224, 223), (999, 31)])
    buf, offs, hs, ws, bad, _ = nvjpeg.decode_batch(jpegs, card)
    assert not bad
    rng = onp.random.RandomState(0)
    n = len(hs)
    for resize, out in ((256, (224, 224)), (-1, (224, 224)),
                        (100, (61, 47))):
        args = (buf, offs, hs, ws, out[0], out[1],
                rng.rand(n).astype("float32"), rng.rand(n).astype("float32"),
                (rng.rand(n) < 0.5).astype("uint8"), (1.0, 2.0, 3.0),
                (2.0, 3.0, 4.0), resize)
        before = ia.image_augment.launches
        got = ia.image_augment(*args)
        assert ia.image_augment.launches == before + 1
        assert torch.equal(got, ia.image_augment_plain(*args))


def test_card_record_iter_feeds_decoded_batches(card, tmp_path):
    """ImageRecordIter on the card: batches on cuda:0 with the host's
    labels and pads; a header nvJPEG cannot read is quarantined by its
    record id; a toolkit without nvJPEG raises at construction."""
    import json

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import nvjpeg

    path = str(tmp_path / "c.rec")
    w = mx.recordio.MXRecordIO(path, "w")
    for i, j in enumerate(_card_jpegs(card, [(60 + i, 80) for i in range(10)])):
        w.write(mx.recordio.pack(mx.recordio.IRHeader(0, float(i), i, 0),
                                 b"garbage" if i == 3 else j))
    w.close()
    kw = dict(path_imgrec=path, data_shape=(3, 48, 48), batch_size=4,
              rand_crop=True, rand_mirror=True, resize=56,
              max_skip_frac=0.5, quarantine_manifest=str(tmp_path / "q.json"))
    it = mx.io.ImageRecordIter(ctx=mx.gpu(0), **kw)
    got = [(b.data[0]._data, b.label[0].asnumpy(), b.pad) for b in it]
    it.close()
    assert all(d.is_cuda and d.shape == (4, 3, 48, 48) for d, _, _ in got)
    # record 3 drops out of the first batch (its row refilled and
    # counted as pad); the last batch wraps around twice
    assert [p for _, _, p in got] == [1, 0, 2]
    labels = onp.concatenate([l for _, l, _ in got])
    assert 3.0 not in labels
    man = json.load(open(tmp_path / "q.json"))
    assert [(e["record"], e["stage"]) for e in man["entries"]] == [
        (3, "decode")]
    home = os.environ.get("CUDA_HOME")
    try:
        os.environ["CUDA_HOME"] = str(tmp_path)
        nvjpeg._lib = None
        with pytest.raises(MXNetError, match="nvjpeg.h"):
            mx.io.ImageRecordIter(ctx=mx.gpu(0), **kw)
    finally:
        if home is None:
            os.environ.pop("CUDA_HOME", None)
        else:
            os.environ["CUDA_HOME"] = home
        nvjpeg._lib = None


def test_async_capture_of_cuda_tensors_equals_sync_save(card, tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import faultsim
    from mxnet_tpu_torch.resilience.checkpoint import CheckpointManager

    gen = torch.Generator(device=card).manual_seed(0)
    live = {f"p{i}": torch.randn((256, 1024), generator=gen, device=card)
            for i in range(4)}
    params = {k: mx.nd.NDArray(t) for k, t in live.items()}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, arg_params=params, batch_cursor=1)
    faultsim.reset("ckpt.async:delay=0.2@1")
    try:
        mgr.save_async(2, arg_params=params, batch_cursor=1)
        for t in live.values():  # the next step's in-place update
            t.mul_(-3.0).add_(1.0)
        torch.cuda.synchronize()
        assert mgr.wait_async(timeout=30)
    finally:
        faultsim.reset("")
        mgr.close_async()
    with open(mgr.params_path(1), "rb") as a, \
            open(mgr.params_path(2), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp8_qdq_on_the_card_equals_the_host(card, dtype):
    """The fp8 rung's quantize-dequantize, forward and backward, gives
    the host's bits on the card (values past both formats' ranges,
    zeros and subnormals included)."""
    from mxnet_tpu_torch.ops import pallas_opt as po

    gen = torch.Generator().manual_seed(5)
    v = (torch.randn(1 << 14, generator=gen)
         * 10.0 ** (torch.rand(1 << 14, generator=gen) * 12 - 6)).to(dtype)
    v[:4] = torch.tensor([0.0, -0.0, 1e6, -7e4])
    g = (torch.randn(1 << 14, generator=gen) * 1e4).to(dtype)
    out = []
    for dev in (card, torch.device("cpu")):
        vv = v.to(dev).requires_grad_(True)
        o = po.fp8_qdq(vv, torch.tensor(3.7, device=dev),
                       torch.tensor(0.013, device=dev))
        (gv,) = torch.autograd.grad(o, vv, g.to(dev))
        out.append((o.detach().cpu(), gv.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_default_sharded_step_launches_the_bucket_kernel(card, tmp_path,
                                                         monkeypatch):
    """With nothing forced and no variant env var, the sharded-bucket
    step on the card runs the bucket kernel once per bucket per step,
    and a ``pallas_bnreluconv`` winner recorded for its batch under the
    mesh key makes a rebuilt step launch the fused backward."""
    from mxnet_tpu_torch import autotune, initializer, parallel
    from mxnet_tpu_torch.gluon import loss, nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.ops import pallas_conv as pc
    from mxnet_tpu_torch.ops import pallas_opt as po

    for var in ("MXNET_PALLAS_OPT", "MXNET_BNRELUCONV_VARIANT",
                "MXNET_FUSED_BNRELUCONV", "MXNET_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    autotune.cache_clear()
    with nn.default_layout("NHWC"):
        net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                              [8, 16, 32, 64, 128], classes=10,
                              no_bias=True)
    net.initialize(initializer.Xavier(), device=card,
                   generator=torch.Generator().manual_seed(0))
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 64, 64, 3).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, 8).astype("float32"))

    def three_steps():
        step, p, s = parallel.make_train_step(
            net, loss.SoftmaxCrossEntropyLoss(), "sgd", learning_rate=0.1,
            momentum=0.9, mesh=parallel.get_mesh(), loss_scale="dynamic",
            compute_dtype="bfloat16", optimizer_sharding="ps",
            bucket_bound=30000)
        b0, m0 = pc.bnreluconv_bwd.launches, po.bucket_sgd_mom.launches
        for i in range(3):
            loss_v, p, s = step(p, s, x, y, None, float(i + 1))
            assert bool(torch.isfinite(loss_v))
        torch.cuda.synchronize()
        return (pc.bnreluconv_bwd.launches - b0,
                po.bucket_sgd_mom.launches - m0, len(step.zero_plan))

    brc, buckets, n = three_steps()
    assert (brc, buckets) == (0, n * 3)
    autotune.record("pallas_bnreluconv", x.shape, x.dtype, "pallas",
                    platform="cuda", mesh="data=1")
    brc, buckets, n = three_steps()
    assert (brc, buckets) == (4 * 3, n * 3)
    autotune.cache_clear()


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_sharded_updater_launches_the_bucket_kernel(card, tmp_path,
                                                    monkeypatch, rule):
    """The Module's sharded updater on the card: with nothing forced it
    takes the bucket kernel (its race times that arm alone and records
    it under the shared key), once a bucket an update, and the result
    is the plain rule's: SGD bit for bit; Adam within 1e-5 (its kernel
    takes f32(1 - beta1) where the rule takes 1 - f32(beta1), as the
    reference's do: read 2.9e-6 after 4 updates at lr 0.1)."""
    from mxnet_tpu_torch import autotune, optimizer, parallel
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.parallel import zero

    for var in ("MXNET_PALLAS_OPT", "MXNET_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    autotune.cache_clear()
    gen = torch.Generator(device=card).manual_seed(0)
    shapes = {"a_weight": (300, 200), "b_bias": (200,), "c_weight": (64,)}
    init = {n: torch.randn(s, generator=gen, device=card)
            for n, s in shapes.items()}
    grads = {n: NDArray(torch.randn(s, generator=gen, device=card))
             for n, s in shapes.items()}
    mesh = parallel.get_mesh(devices=[card])
    counter = po.bucket_sgd_mom if rule == "sgd" else po.bucket_adam
    finals = []
    for forced in (None, False):
        opt = optimizer.create(rule, learning_rate=0.1, momentum=0.9) \
            if rule == "sgd" else optimizer.create(rule, learning_rate=0.1)
        upd = zero.ShardedBucketUpdater(
            opt, mesh, {n: v.clone() for n, v in init.items()},
            capacity=30000)
        weights = {n: NDArray(v.clone()) for n, v in init.items()}
        ctx = contextlib.nullcontext() if forced is None else \
            autotune.force(fused_bucket_opt=forced)
        with ctx:
            upd.update_all([(n, grads[n], weights[n]) for n in shapes])
            n0 = counter.launches
            for _ in range(3):
                upd.update_all([(n, grads[n], weights[n]) for n in shapes])
            torch.cuda.synchronize()
        launched = counter.launches - n0
        assert launched == (len(upd.plan) * 3 if forced is None else 0)
        finals.append({n: w._data.clone() for n, w in weights.items()})
    shape, dtype = zero.flat_variant_key(upd.plan)
    assert autotune.lookup("fused_bucket_opt", shape, dtype,
                           platform="cuda", mesh="data=1") == "pallas"
    for n in shapes:
        if rule == "sgd":
            assert torch.equal(finals[0][n], finals[1][n]), n
        else:
            torch.testing.assert_close(finals[0][n], finals[1][n],
                                       rtol=1e-5, atol=1e-5)
    autotune.cache_clear()


def test_group2ctx_moves_between_the_card_and_the_host(card):
    """A graph split across the card and the host: each group's
    parameters live on its device, the crossing is one transfer each
    way, and the output and gradients equal the all-card run's."""
    import mxnet_tpu_torch as mx

    x = mx.sym.var("data")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.Activation(mx.sym.FullyConnected(
            x, mx.sym.var("w1"), num_hidden=8, no_bias=True, name="fc1"),
            act_type="tanh", name="act1")
    with mx.AttrScope(ctx_group="dev2"):
        y = mx.sym.FullyConnected(h, mx.sym.var("w2"), num_hidden=2,
                                  no_bias=True, name="fc2")
    rng = onp.random.RandomState(0)
    vals = {"data": rng.rand(4, 5), "w1": rng.rand(8, 5),
            "w2": rng.rand(2, 8)}
    runs = []
    for g2c in ({"dev1": mx.gpu(0), "dev2": mx.cpu()}, None):
        args = {n: mx.nd.array(v.astype("float32"), ctx=mx.cpu())
                for n, v in vals.items()}
        grads = {n: mx.nd.zeros(args[n].shape, ctx=mx.cpu())
                 for n in ("w1", "w2")}
        ex = y.bind(ctx=mx.gpu(0), args=args, args_grad=grads,
                    grad_req={"data": "null", "w1": "write",
                              "w2": "write"}, group2ctx=g2c)
        out = ex.forward(is_train=True)[0]
        ex.backward(mx.nd.ones((4, 2), ctx=mx.cpu()))
        runs.append((ex, out._data.cpu(), {
            n: ex.grad_dict[n]._data.cpu() for n in ("w1", "w2")}))
    (ex, out, g), (_, out0, g0) = runs
    assert ex.arg_dict["w1"]._data.device == card
    assert ex.arg_dict["w2"]._data.device.type == "cpu"
    assert ex.grad_dict["w2"]._data.device.type == "cpu"
    assert out.device.type == "cpu" and ex.transfers == 1
    torch.testing.assert_close(out, out0, rtol=1e-6, atol=1e-6)
    for n in g:
        torch.testing.assert_close(g[n], g0[n], rtol=1e-6, atol=1e-6)
