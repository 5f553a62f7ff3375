"""The port's int8 KV quantizer and paged KV pool held against the JAX
reference on the CPU: int8 values and scales equal bit for bit, page
sizes and pool accounting equal on the same call sequence, and the
pool's page contents after a prompt write equal."""
import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.quantization import kv as jkv  # noqa: E402
from mxnet_tpu.serving.kvcache import PagedKVPool as JPool  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.quantization import kv as tkv  # noqa: E402
from mxnet_tpu_torch.serving.kvcache import PagedKVPool as TPool  # noqa: E402


def _kv_data(seed):
    rng = onp.random.RandomState(seed)
    x = rng.randn(3, 5, 2, 8).astype("float32") * 3.0
    x[0, 0, 0] = 0.0                       # all-zero vector: scale 0
    x[0, 1, 0] = onp.linspace(-1, 1, 8)    # exact .5 steps after scaling
    x[0, 2, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]
    x[1, 0, 0, 0] = 1e-30                  # a tiny amax
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quantize_bit_exact(seed):
    x = _kv_data(seed)
    jq, js = jkv.kv_quantize(jnp.asarray(x))
    tq, ts = tkv.kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    onp.testing.assert_array_equal(tq.numpy(), onp.asarray(jq))
    assert tq.numpy().tobytes() == onp.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == onp.asarray(js).tobytes()
    back_j = onp.asarray(jkv.kv_dequantize(jq, js))
    back_t = tkv.kv_dequantize(tq, ts).numpy()
    assert back_t.tobytes() == back_j.tobytes()


def test_kv_quantize_zero_vector_roundtrips():
    q, s = tkv.kv_quantize(torch.zeros(3, 2, 8))
    assert float(s.abs().max()) == 0.0
    assert float(tkv.kv_dequantize(q, s).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("dims", [(2, 4, 2, 8), (4, 16, 16, 128),
                                  (1, 1, 1, 1)])
def test_kv_page_bytes_equal(dtype, dims):
    assert tkv.kv_page_bytes(*dims, dtype) == \
        jkv.kv_page_bytes(*dims, dtype)


def test_kv_page_bytes_rejects_unknown_dtype():
    with pytest.raises(ValueError):
        tkv.kv_page_bytes(2, 4, 2, 8, "float16")


def _pool_state(pool, ids, max_pages):
    return {
        "num_pages": pool.num_pages, "page_bytes": pool.page_bytes,
        "pages_in_use": pool.pages_in_use, "free": pool.free_pages,
        "capacity_tokens": pool.capacity_tokens,
        "rows": [list(map(int, pool.page_table_row(i, max_pages)))
                 for i in ids],
    }


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_accounting_equal_on_same_calls(dtype):
    """The same alloc/free/reset sequence on both pools gives the same
    page lists, counts and page-table rows (page 0 never handed out)."""
    kw = dict(page_tokens=4, budget_bytes=1 << 14, dtype=dtype)
    jp, tp = JPool(2, 2, 8, **kw), TPool(2, 2, 8, device="cpu", **kw)
    assert tp.k_pages.shape == tuple(jp.k_pages.shape)
    calls = [("alloc", "a", 10), ("alloc", "b", 3), ("free", "a"),
             ("alloc", "c", 17), ("free", "a"), ("alloc", "a", 1),
             ("free", "b"), ("alloc", "d", 8)]
    ids = ["a", "b", "c", "d"]
    for call in calls:
        if call[0] == "alloc":
            got_j = jp.alloc(call[1], call[2])
            got_t = tp.alloc(call[1], call[2])
            assert got_t == got_j and 0 not in got_t
        else:
            assert tp.free(call[1]) == jp.free(call[1])
        assert _pool_state(tp, ids, 6) == _pool_state(jp, ids, 6)
    for tokens in (1, 4, 5, 40, tp.capacity_tokens):
        assert tp.can_admit(tokens) == jp.can_admit(tokens)
        assert tp.pages_needed(tokens) == jp.pages_needed(tokens)
        assert tp.capacity_sequences(tokens) == \
            jp.capacity_sequences(tokens)
    with pytest.raises(MXNetError):
        tp.alloc("c", 1)
    with pytest.raises(MXNetError):
        tp.alloc("huge", tp.capacity_tokens + 1)
    with pytest.raises(MXNetError):
        tp.page_table_row("c", 1)
    assert tp.reset() == jp.reset()
    assert tp.free_pages == tp.num_pages == jp.free_pages


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("tokens", [3, 4, 9])
def test_write_prompt_pages_equal(dtype, tokens):
    """A prompt written into the same pages lands identically: pages
    bit for bit, the tail of the last page zero.  The reference writes
    through a jitted quantizer, where XLA turns ``amax / 127`` into a
    multiply by the reciprocal; the port keeps the eager division
    (bit-exact with the eager reference above), so int8 scales may
    differ from the jitted ones by one ulp (rtol 2**-23)."""
    kw = dict(page_tokens=4, budget_bytes=1 << 14, dtype=dtype)
    jp, tp = JPool(2, 2, 8, **kw), TPool(2, 2, 8, device="cpu", **kw)
    assert jp.alloc("s", 12) == tp.alloc("s", 12)
    rng = onp.random.RandomState(tokens)
    k = rng.randn(2, tokens, 2, 8).astype("float32")
    v = rng.randn(2, tokens, 2, 8).astype("float32")
    jp.write_prompt("s", jnp.asarray(k), jnp.asarray(v))
    tp.write_prompt("s", torch.from_numpy(k), torch.from_numpy(v))
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = getattr(jp, name), getattr(tp, name)
        if a is None:
            assert b is None
            continue
        if name.endswith("scale"):
            onp.testing.assert_allclose(b.numpy(), onp.asarray(a),
                                        rtol=2.0 ** -23, atol=0)
        else:
            assert b.numpy().tobytes() == onp.asarray(a).tobytes(), name


def test_pool_rejects_bad_dtype_and_budget():
    with pytest.raises(MXNetError):
        TPool(2, 2, 8, page_tokens=4, budget_bytes=1 << 14,
              dtype="float16", device="cpu")
    with pytest.raises(MXNetError):
        TPool(2, 2, 8, page_tokens=4, budget_bytes=16, dtype="float32",
              device="cpu")
