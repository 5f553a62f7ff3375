"""The port's attention (mxnet_tpu_torch.ops.flash_attention) held
against the JAX reference on the CPU.

The reference's Pallas ``_flash_kernel`` runs in interpret mode (its
``pallas_pad`` variant and ``_flash_forward_pallas`` with the padding
shim's ``kv_valid``/``q_valid``); the port's ``flash_attention`` on a
CPU tensor computes its plain version, which is what the CUDA kernel
is held against on the card.  Inputs are made with numpy from a seed
and handed to both.  Tolerances: fp32 1e-5 (the two frameworks sum in
another order); bf16 inputs are compared in fp32 at 1e-2 (one bf16
rounding of the output); fully masked rows exactly 0.
"""
import math

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import flash_attention as jfa  # noqa: E402
from mxnet_tpu.quantization import kv_quantize as j_kv_quantize  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def _qkv(b, h, sq, sk, d, seed):
    rng = onp.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype("float32"),
            rng.randn(b, h, sk, d).astype("float32"),
            rng.randn(b, h, sk, d).astype("float32"))


# (batch, heads, seq_q, seq_k, head_dim, causal)
_CASES = [
    (1, 2, 4, 4, 8, True),
    (1, 2, 8, 8, 8, True),
    (1, 2, 16, 16, 8, True),
    (1, 2, 100, 100, 8, True),
    (1, 2, 100, 100, 8, False),
    (2, 2, 130, 130, 16, True),
    (2, 2, 130, 130, 16, False),
    (1, 2, 5, 37, 8, True),     # Sq < Sk: bottom-right alignment
    (1, 2, 40, 9, 8, True),     # Sq > Sk: fully masked leading rows
]


def _ids(case):
    b, h, sq, sk, d, causal = case
    return f"{b}x{h}x{sq}x{sk}x{d}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_flash_matches_jax_pallas_pad(case):
    b, h, sq, sk, d, causal = case
    q, k, v = _qkv(b, h, sq, sk, d, seed=sq * 31 + sk)
    want = onp.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        variant="pallas_pad", interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              variant="pallas_pad")
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if causal and sq > sk:
        assert (got.numpy()[:, :, :sq - sk] == 0).all()
        assert (want[:, :, :sq - sk] == 0).all()


@pytest.mark.parametrize("case", [(1, 2, 16, 16, 8, True),
                                  (2, 2, 130, 130, 16, False),
                                  (1, 2, 40, 9, 8, True)], ids=_ids)
def test_flash_bf16_matches_jax(case):
    b, h, sq, sk, d, causal = case
    q, k, v = _qkv(b, h, sq, sk, d, seed=7)
    want = jfa.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=causal,
        variant="pallas_pad", interpret=True)
    got = tfa.flash_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), causal=causal,
        variant="pallas_pad")
    assert got.dtype == torch.bfloat16
    want32 = onp.asarray(want.astype(jnp.float32))
    onp.testing.assert_allclose(got.float().numpy(), want32, rtol=1e-2,
                                atol=1e-2)
    if causal and sq > sk:
        assert (got.float().numpy()[:, :, :sq - sk] == 0).all()


@pytest.mark.parametrize("valid", [(40, 9), (100, 100), (5, 37)])
def test_reference_matches_pallas_padding_shim(valid):
    """The plain version's kv_valid/q_valid contract equals the Pallas
    kernel's on padded operands: padding never shifts which keys a
    real query sees, and keys past kv_valid never score."""
    q_valid, kv_valid = valid
    q, k, v = _qkv(1, 2, 128, 128, 8, seed=q_valid)
    scale = 1.0 / math.sqrt(8)
    want = onp.asarray(jfa._flash_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, scale,
        kv_valid=kv_valid, q_valid=q_valid, interpret=True))
    got = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, sm_scale=scale, kv_valid=kv_valid, q_valid=q_valid)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_call_launches_no_kernel():
    saved = tfa.flash_attention.launches
    tfa.flash_attention.launches = 0
    try:
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 8, 0))
        for variant in (None, "naive", "pallas", "pallas_b256",
                        "pallas_pad"):
            tfa.flash_attention(q, k, v, causal=True, variant=variant)
        assert tfa.flash_attention.launches == 0
    finally:
        tfa.flash_attention.launches = saved


def test_unknown_variant_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 4, 8, 0))
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, variant="triton")


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguity",
                                 "shape", "empty", "alignment"])
def test_kernel_operand_checks_raise(bad):
    """What the wrapper refuses before a launch (checked on host
    tensors: the checks are plain Python)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 8, 0))
    if bad == "head_dim":  # no depth at all
        q, k, v = (torch.zeros(1, 2, 8, 0) for _ in range(3))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguity":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        k = k[:, :1].contiguous()
    elif bad == "alignment":  # contiguous, one element past the start
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
        assert q.is_contiguous()
    else:
        q = q[:, :, :0].contiguous()
    with pytest.raises(MXNetError, match="head_dim" if bad == "head_dim"
                       else None):
        tfa._check_kernel_operands(q, k, v)


@pytest.mark.parametrize("d", [1, 5, 8, 12, 24, 40, 96, 100, 128])
def test_head_dims_up_to_128_pass_the_checks(d):
    """Every head_dim from 1 to 128 is taken: it runs at the next depth
    the kernel has tiles for."""
    q, k, v = (torch.zeros(1, 2, 8, d) for _ in range(3))
    tfa._check_kernel_operands(q, k, v)
    depth = tfa._kernel_depth(d)
    assert depth in tfa._KERNEL_HEAD_DIMS and d <= depth
    assert depth == 8 or depth // 2 < d
    assert tfa._slabs(depth) == [(0, depth)]


@pytest.mark.parametrize("d", [129, 160, 192, 256, 320, 512])
def test_deep_head_dims_pass_the_checks_and_plan_whole_slabs(d):
    """A head_dim above 128 is taken: it runs at the next multiple of
    128, in 128-wide slabs that together write every output column of
    that depth once, the head's own columns among them."""
    q, k, v = (torch.zeros(1, 2, 8, d) for _ in range(3))
    tfa._check_kernel_operands(q, k, v)
    depth = tfa._kernel_depth(d)
    assert depth % 128 == 0 and d <= depth < d + 128
    slabs = tfa._slabs(depth)
    assert all(stop - start == 128 for start, stop in slabs)
    cols = [c for start, stop in slabs for c in range(start, stop)]
    assert cols == list(range(depth))
    assert len(slabs) == depth // 128 >= 2


@pytest.mark.parametrize("needs", ["q", "k", "v"])
def test_grad_guard_raises_when_an_operand_requires_grad(needs):
    """The kernel has no backward: with grad mode on, an operand that
    requires grad raises (checked on host tensors: the guard is plain
    Python, and the kernel path calls it before any launch)."""
    ops = {n: torch.from_numpy(a) for n, a in
           zip("qkv", _qkv(1, 2, 8, 8, 8, 0))}
    ops[needs].requires_grad_(True)
    with pytest.raises(MXNetError, match="no backward"):
        tfa._check_no_grad(ops["q"], ops["k"], ops["v"])
    with torch.no_grad():  # nothing will be differentiated: silent
        tfa._check_no_grad(ops["q"], ops["k"], ops["v"])


def test_grad_guard_is_silent_without_grads():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 8, 0))
    tfa._check_no_grad(q, k, v)
    with torch.inference_mode():
        tfa._check_no_grad(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [5, 24, 40, 96])
def test_padded_depth_equals_unpadded(d, causal):
    """What the kernel path does for a head_dim without tiles: q, k, v
    zero-padded to the next depth, sm_scale from the original head_dim,
    the output sliced back.  Zero columns add exact zeros to every
    score, so on the plain version the padded result equals the
    unpadded one to 1e-6; both equal the reference's _naive_attention
    to 1e-5 (another summation order)."""
    qn, kn, vn = _qkv(2, 3, 37, 45, d, seed=d)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    depth = tfa._kernel_depth(d)
    assert depth > d
    scale = 1.0 / math.sqrt(d)
    plain = tfa.flash_attention_reference(q, k, v, causal=causal,
                                          sm_scale=scale)
    padded = tfa.flash_attention_reference(
        *(tfa._pad_depth(t, depth) for t in (q, k, v)), causal=causal,
        sm_scale=scale)
    assert padded.shape == (2, 3, 37, depth)
    assert bool((padded[..., d:] == 0).all())
    sliced = padded[..., :d].contiguous()
    onp.testing.assert_allclose(sliced.numpy(), plain.numpy(), rtol=1e-6,
                                atol=1e-6)
    want = onp.asarray(jfa._naive_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, scale))
    for got in (plain, sliced):
        onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                    atol=1e-5)


# ------------------------------------- the kernel's plan and its numerics
def _plan_shapes():
    # (bh, sq, sk, causal): the server's prefills, the card checks, the
    # key-split shapes (Sq << Sk), fully masked q tiles (Sq > Sk)
    return [(2, 16, 16, True), (16, 128, 128, True), (16, 512, 512, True),
            (16, 2048, 2048, True), (32, 1, 2048, True), (32, 7, 2048, True),
            (32, 16, 2048, True), (32, 2048, 2048, False),
            (32, 300, 100, True), (2, 20, 5, True), (1, 65, 130, False),
            (3, 130, 67, True), (1, 1, 1, False)]


@pytest.mark.parametrize("shape", _plan_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_split_plan_covers_every_key_tile_once(shape):
    """Every key tile a q tile sees is in exactly one of its items, no
    item is empty unless its q tile sees no key, the slots of a q tile
    are contiguous, items run heaviest first, and the grid has at least
    132 CTAs where the shape has that much work."""
    bh, sq, sk, causal = shape
    bq, bk, n_sm = 64, 64, 132
    items, ranges, split = tfa._split_plan(bh, sq, sk, causal, bq, bk, n_sm)
    n_qt = -(-sq // bq)
    assert len(ranges) == n_qt
    sizes = [it[2] - it[1] for it in items]
    assert sizes == sorted(sizes, reverse=True)
    by_slot = {it[3]: it for it in items}
    assert sorted(by_slot) == list(range(len(items)))
    for qt, (first, count) in enumerate(ranges):
        mine = [by_slot[first + i] for i in range(count)]
        assert all(it[0] == qt for it in mine)
        last = sk - 1
        if causal:
            last = min(last, min((qt + 1) * bq, sq) - 1 + (sk - sq))
        want = last // bk + 1 if last >= 0 else 0
        covered = sorted(kt for it in mine for kt in range(it[1], it[2]))
        assert covered == list(range(want))
        if want == 0:
            assert count == 1 and mine[0][1] == mine[0][2] == 0
        else:
            assert all(it[2] > it[1] for it in mine)
    assert split == (len(items) > n_qt)
    most = sum(max(1, it) for it in (
        (min(sk - 1, min((qt + 1) * bq, sq) - 1 + sk - sq) if causal
         else sk - 1) // bk + 1 for qt in range(n_qt)))
    if bh * n_qt >= n_sm:
        assert not split
    elif bh * most >= n_sm:
        assert bh * len(items) >= n_sm
    else:
        assert len(items) == most  # every tile its own item


def _tf32(x):
    """cvt.rna.tf32.f32: the float32 mantissa rounded to 10 bits, ties
    away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulate_kernel(q, k, v, causal, scale, passes, n_sm=132, bq=64,
                    bk=64, fault=None, chunk=None, cols=None, plan_bh=None):
    """The kernel's algorithm in float32 torch ops on (bh, s, d)
    operands: the wrapper's plan, key tiles of ``bk``, the online
    softmax in the exp2 domain with the -inf guards, every product
    taken from TF32-rounded operands in ``passes`` passes (3: lo*hi +
    hi*lo + hi*hi) or, for ``passes="bf16"``, from bf16 operands (P
    rounded to bf16 before P V), key-split partials merged in slot
    order.  ``fault`` plants a defect: "drop_tile" skips key tile 8,
    "no_rescale" leaves the accumulator unscaled when the row max
    grows.  The slab kernel's CTA: ``chunk`` sums Q K^T over chunks of
    that depth, in order; ``cols`` = (start, stop) is its slab of V's
    and the output's columns; ``plan_bh`` the CTAs per item the plan
    counts (default ``bh``)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if cols is not None:
        v = v[..., cols[0]:cols[1]]
    c = scale * 1.4426950408889634
    ninf = torch.tensor(-math.inf)

    def prod(a, b):
        if passes == "bf16":
            return (a.to(torch.bfloat16).float() @
                    b.to(torch.bfloat16).float())
        ah, bh_ = _tf32(a), _tf32(b)
        if passes == 1:
            return ah @ bh_
        al, bl = _tf32(a - ah), _tf32(b - bh_)
        return al @ bh_ + ah @ bl + ah @ bh_

    def scores(a, b):
        if chunk is None:
            return prod(a, b)
        s = prod(a[..., :chunk], b[:, :chunk])
        for c0 in range(chunk, a.shape[-1], chunk):
            s = s + prod(a[..., c0:c0 + chunk], b[:, c0:c0 + chunk])
        return s

    items, ranges, split = tfa._split_plan(
        bh if plan_bh is None else plan_bh, sq, sk, causal, bq, bk, n_sm)
    d = v.shape[-1]
    out = torch.zeros((bh, sq, d))
    parts = {}
    for qt, kt0, kt1, slot in items:
        rows = torch.arange(qt * bq, min((qt + 1) * bq, sq))
        m = torch.full((bh, len(rows)), -math.inf)
        l = torch.zeros((bh, len(rows)))
        acc = torch.zeros((bh, len(rows), d))
        for kt in range(kt0, kt1):
            if fault == "drop_tile" and kt == 8:
                continue
            keys = torch.arange(kt * bk, min((kt + 1) * bk, sk))
            s = scores(q[:, rows], k[:, keys].transpose(1, 2)) * c
            if causal:
                seen = keys[None, :] <= rows[:, None] + (sk - sq)
                s = torch.where(seen, s, ninf)
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * alpha + p.sum(-1)
            if fault != "no_rescale":
                acc = acc * alpha[..., None]
            acc = acc + prod(p, v[:, keys])
            m = m_new
        if split:
            parts[slot] = (m, l, acc)
        else:
            out[:, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    if split:
        for qt, (first, count) in enumerate(ranges):
            rows = torch.arange(qt * bq, min((qt + 1) * bq, sq))
            ps = [parts[first + i] for i in range(count)]
            m = torch.stack([p_[0] for p_ in ps]).amax(0)
            base = torch.where(m == -math.inf, 0.0, m)
            l = torch.zeros_like(m)
            acc = torch.zeros((bh, len(rows), d))
            for pm, pl, pa in ps:
                w = torch.exp2(pm - base)
                l = l + w * pl
                acc = acc + w[..., None] * pa
            out[:, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out


def _float64_attention(q, k, v, causal, scale):
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
    sq, sk = q.shape[1], k.shape[1]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (
            sk - sq)
    s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, -1)
    p = torch.where(keep.any(-1, keepdim=True), p, torch.zeros_like(p))
    return p @ v.double()


def test_split_tf32_numerics_hold_fp32_accuracy():
    """The fp32 kernel's products are three TF32 passes: at (1, 4, 256,
    256, 128) causal they are within 1e-5 of float64, where one TF32
    pass is further off than the card's fp32 tolerance of 1e-4 (the
    reason for the split)."""
    rng = onp.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, 256, 128).astype("float32"))
               for _ in range(3))
    scale = 1.0 / math.sqrt(128)
    want = _float64_attention(q, k, v, True, scale)
    err3 = float((_emulate_kernel(q, k, v, True, scale, 3).double()
                  - want).abs().max())
    err1 = float((_emulate_kernel(q, k, v, True, scale, 1).double()
                  - want).abs().max())
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1  # one pass: 1e-3 class


@pytest.mark.parametrize("shape", [(4, 1, 700, True), (4, 7, 700, True),
                                   (2, 130, 67, True), (2, 300, 200, True),
                                   (2, 65, 200, False)],
                         ids=lambda s: "x".join(map(str, s)))
def test_key_split_partials_merge_to_the_reference(shape):
    """The key-split arm (partials per key range, merged in slot order)
    gives the plain version's result, and fully masked rows exactly 0."""
    bh, sq, sk, causal = shape
    rng = onp.random.RandomState(sq + sk)
    q, k, v = (torch.from_numpy(rng.randn(bh, s, 32).astype("float32"))
               for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(32)
    items, _, split = tfa._split_plan(bh, sq, sk, causal, 64, 64, 132)
    got = _emulate_kernel(q, k, v, causal, scale, 3)
    want = tfa.flash_attention_reference(q[None], k[None], v[None],
                                         causal=causal, sm_scale=scale)[0]
    assert split
    assert float((got - want).abs().max()) <= 1e-5
    if causal and sq > sk:
        assert (got[:, :sq - sk] == 0).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 256])
def test_slab_kernel_order_matches_naive_attention(d, causal):
    """The slab kernel's algorithm for a head_dim above 128: q, k, v
    zero-padded to the kernel depth, one CTA per 128-wide slab of V and
    the output, each summing split-TF32 Q K^T over 128-deep chunks in
    order and running the online softmax, the key split planned over
    batch*heads times slabs.  Its slabs, put side by side and sliced
    back, equal the reference's _naive_attention to 1e-5; every slab
    computes the same scores, so the sliced columns do not depend on
    which slab wrote them."""
    rng = onp.random.RandomState(d)
    bh, sq, sk = 3, 150, 200
    qn, kn, vn = (rng.randn(1, bh, s, d).astype("float32")
                  for s in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    depth = tfa._kernel_depth(d)
    q, k, v = (tfa._pad_depth(torch.from_numpy(a)[0], depth)
               for a in (qn, kn, vn))
    slabs = tfa._slabs(depth)
    got = torch.cat([
        _emulate_kernel(q, k, v, causal, scale, 3, bq=128, bk=64,
                        chunk=128, cols=cols, plan_bh=bh * len(slabs))
        for cols in slabs], dim=-1)
    assert got.shape == (bh, sq, depth)
    assert bool((got[..., d:] == 0).all())
    want = onp.asarray(jfa._naive_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal,
        scale))[0]
    onp.testing.assert_allclose(got[..., :d].numpy(), want, rtol=1e-5,
                                atol=1e-5)


@pytest.mark.parametrize("fault", [None, "drop_tile", "no_rescale"])
def test_bf16_card_check_passes_the_kernel_and_fails_planted_faults(
        fault):
    """The card's bf16 check (``chip_smoke.py``: max abs 2e-2 and, row
    by row, ``BF16_ROW_TOL`` of the row's largest value) against the
    bf16 kernel's numerics at (1, 2, 1024, 1024, 128) causal: the
    kernel as built passes; a dropped key tile (rows of 513 keys and
    more) or a missed rescale of the accumulator fails it row by row."""
    from chip_smoke import BF16_ROW_TOL, TOL, row_rel_err

    rng = onp.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 1024, 128).astype("float32"))
               .to(torch.bfloat16).float() for _ in range(3))
    scale = 1.0 / math.sqrt(128)
    # one SM: no key split, each q tile walks all its key tiles
    got = _emulate_kernel(q, k, v, True, scale, "bf16", n_sm=1,
                          fault=fault).to(torch.bfloat16)
    want = tfa.flash_attention_reference(
        *(t.to(torch.bfloat16)[None] for t in (q, k, v)), causal=True,
        sm_scale=scale)[0]
    rel = row_rel_err(got, want)
    err = float((got.float() - want.float()).abs().max())
    if fault is None:
        assert rel <= BF16_ROW_TOL and err <= TOL["bfloat16"], (rel, err)
    else:
        assert rel > BF16_ROW_TOL, (rel, err)


@pytest.mark.parametrize("shape", [(2, 512, 512, 128, True),
                                   (2, 300, 700, 64, True),
                                   (1, 256, 256, 128, False),
                                   (3, 7, 1024, 32, True)])
def test_bf16_kernel_emulation_matches_reference_naive_attention(shape):
    """The bf16 kernel's numerics (``_emulate_kernel(..., "bf16")``: bf16
    products, P rounded to bf16 before P V, the output rounded to bf16
    once) against the reference's ``_naive_attention`` on the same bf16
    operands, its output rounded to bf16.  Allowance, the card's: 2^-6
    of each row's largest value (``BF16_ROW_TOL``) and 2e-2 absolute.
    The reference keeps p and V in fp32, so the two differ by about one
    bf16 ulp of a row's largest value; a dropped key tile fails it
    (``test_bf16_card_check_passes_the_kernel_and_fails_planted_faults``)."""
    from chip_smoke import BF16_ROW_TOL, TOL, row_rel_err

    bh, sq, sk, d, causal = shape
    rng = onp.random.RandomState(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.randn(bh, n, d).astype("float32"))
               .to(torch.bfloat16).float() for n in (sq, sk, sk))
    scale = 1.0 / math.sqrt(d)
    got = _emulate_kernel(q, k, v, causal, scale, "bf16").to(torch.bfloat16)
    want = jfa._naive_attention(
        *(jnp.asarray(t.numpy(), jnp.bfloat16)[None] for t in (q, k, v)),
        causal, scale)
    want = torch.from_numpy(onp.asarray(want[0], onp.float32)).to(
        torch.bfloat16)
    rel = row_rel_err(got, want)
    err = float((got.float() - want.float()).abs().max())
    assert rel <= BF16_ROW_TOL and err <= TOL["bfloat16"], (rel, err)
    assert rel > 0  # the two round differently: the allowance is used


# ------------------------------------------------ paged decode attention
def _paged_fixture():
    rng = onp.random.RandomState(11)
    S, P, T, H, D = 3, 9, 4, 2, 8
    q = rng.randn(S, H, D).astype("float32") * 0.5
    k = rng.randn(P, T, H, D).astype("float32") * 0.5
    v = rng.randn(P, T, H, D).astype("float32") * 0.5
    k[0] = 1e9  # the null page holds garbage nobody may read
    v[0] = 1e9
    pt = onp.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], "int32")
    sl = onp.array([10, 6, 0], "int32")
    return q, k, v, pt, sl


@pytest.mark.parametrize("variant", ["gather", "paged"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_decode_attention_matches_jax(variant, kv):
    q, k, v, pt, sl = _paged_fixture()
    k[0] = v[0] = 0.0 if kv == "int8" else 1e9
    scales = {}
    if kv == "int8":
        kq, ks = j_kv_quantize(jnp.asarray(k))
        vq, vs = j_kv_quantize(jnp.asarray(v))
        k, v = onp.array(kq), onp.array(vq)
        scales = {"k_scale": onp.array(ks), "v_scale": onp.array(vs)}
    want = onp.asarray(jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(sl), variant=variant,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    got = tfa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pt), torch.from_numpy(sl), variant=variant,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert onp.isfinite(got.numpy()).all()
    assert (got.numpy()[2] == 0.0).all(), "inactive slot row must be 0"
