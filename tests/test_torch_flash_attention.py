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
                                 "shape", "empty"])
def test_kernel_operand_checks_raise(bad):
    """What the wrapper refuses before a launch (checked on host
    tensors: the checks are plain Python)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 8, 8, 0))
    if bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 12) for _ in range(3))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguity":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        k = k[:, :1].contiguous()
    else:
        q = q[:, :, :0].contiguous()
    with pytest.raises(MXNetError):
        tfa._check_kernel_operands(q, k, v)


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
