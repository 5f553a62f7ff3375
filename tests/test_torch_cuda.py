"""The port on a CUDA card: every test here is marked ``cuda`` and
skips on a host without one.  The file imports neither JAX nor the JAX
package, so on the card's host it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The kernel is held against its plain version on the same inputs (fp32
1e-4: another exp/sum order; bf16 2e-2: one bf16 rounding of the
output); fully masked rows must be exactly 0.
"""
import numpy as onp
import pytest
import torch

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
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())


def test_naive_variant_launches_nothing(card):
    q, k, v = _qkv(1, 2, 8, 8, 8, "float32", card)
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v, causal=True, variant="naive")
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "contiguity"])
def test_kernel_refuses_what_it_does_not_take(card, bad):
    q, k, v = _qkv(1, 2, 8, 8, 8, "float32", card)
    if bad == "head_dim":
        q, k, v = _qkv(1, 2, 8, 8, 12, "float32", card)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = tfa.flash_attention.launches
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, causal=True, variant="pallas_pad")
    assert tfa.flash_attention.launches == before


def test_server_tokens_equal_on_card_and_host(card):
    from mxnet_tpu_torch.serving import GenerativeServer, toy_decoder_params

    params = toy_decoder_params(seed=0, device="cpu")
    outs = {}
    for device in (card, "cpu"):
        srv = GenerativeServer(params=params, device=device,
                               prompt_buckets=(4, 8), max_new=6, slots=4,
                               page_tokens=4, pool_budget=1 << 16,
                               kv_dtype="float32")
        srv.start(warm=True)
        try:
            outs[str(device)] = [
                srv.submit(p, max_new=6).result(timeout=60)
                for p in ([1, 2, 3], [5], [7, 3, 9, 2, 11])]
        finally:
            srv.close()
    assert outs[str(card)] == outs["cpu"]
