"""The port's generative decode server (mxnet_tpu_torch.serving) held
against the JAX reference on the CPU, as a whole slice.

Both servers get the same weights: the reference's
``toy_decoder_params(seed=0)`` as numpy, carried across by
``params_from_numpy``.  Both run at ``MXNET_AUTOTUNE=0`` with the
settings of ``tests/test_generate.py``'s ``_server``.  Tolerances:
prefill logits and K/V 1e-5 (fp32, another summation order); fp32-KV
greedy tokens identical; int8-KV tokens agree at >= 0.99, the
reference's own adoption floor.  The rest mirrors the reference's
contract tests on the port: exact eviction/resume, breaker trip with
every page reclaimed, the int8 gate both ways.
"""
import time

import numpy as onp
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.serving import GenerativeServer as JServer  # noqa: E402
from mxnet_tpu.serving import toy_decoder_params as j_toy  # noqa: E402
from mxnet_tpu_torch import autotune as t_autotune  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.resilience import faultsim as t_faultsim  # noqa: E402
from mxnet_tpu_torch.serving import (  # noqa: E402
    GenerativeServer,
    ServeRejected,
    params_from_numpy,
    toy_decoder_params,
)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "0")
    t_faultsim.reset("")
    yield
    t_faultsim.reset("")


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(onp.asarray, j_toy(seed=0))


def _kw(**kw):
    kw.setdefault("prompt_buckets", (4, 8))
    kw.setdefault("max_new", 6)
    kw.setdefault("slots", 4)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("pool_budget", 1 << 16)
    kw.setdefault("kv_dtype", "float32")
    return kw


def _server(params=None, **kw):
    if params is not None:
        params = params_from_numpy(params, device="cpu")
    return GenerativeServer(params=params, device="cpu", **_kw(**kw))


def _jserver(params, **kw):
    return JServer(params=jax.tree.map(jnp.asarray, params), **_kw(**kw))


def _prompts(n, seed=0, longest=8, vocab=32):
    rng = onp.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab,
                                          int(rng.integers(1, longest + 1)))]
            for _ in range(n)]


def _serve(srv, prompts, max_new):
    srv.start(warm=True)
    try:
        return [srv.submit(p, max_new=max_new).result(timeout=60)
                for p in prompts]
    finally:
        srv.close()


# ------------------------------------------------------------ weights
def test_params_layout_matches_reference(ref_params):
    ported = params_from_numpy(ref_params, device="cpu")
    fresh = toy_decoder_params(seed=0, device="cpu")
    for tree in (ported, fresh):
        assert sorted(tree) == sorted(ref_params)
        assert len(tree["layers"]) == len(ref_params["layers"])
        for name in ("embed", "head", "lnf"):
            assert tuple(tree[name].shape) == ref_params[name].shape
            assert tree[name].dtype == torch.float32
        for got, want in zip(tree["layers"], ref_params["layers"]):
            assert sorted(got) == sorted(want)
            for name in want:
                assert tuple(got[name].shape) == want[name].shape
    onp.testing.assert_array_equal(ported["layers"][1]["w1"].numpy(),
                                   ref_params["layers"][1]["w1"])
    again = toy_decoder_params(seed=0, device="cpu")
    assert torch.equal(again["embed"], fresh["embed"])


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("bucket,n", [(4, 1), (4, 4), (8, 5), (16, 11)])
def test_prefill_logits_and_kv_match(ref_params, bucket, n):
    jsrv = _jserver(ref_params, prompt_buckets=(4, 8, 16))
    tsrv = _server(ref_params, prompt_buckets=(4, 8, 16))
    toks = onp.zeros((1, bucket), "int64")
    toks[0, :n] = onp.arange(3, 3 + n) % 32
    jl, jk, jv = jsrv._prefill_fn(jsrv.params,
                                  jnp.asarray(toks, jnp.int32))
    tl, tk, tv = tsrv._prefill_fn(tsrv.params, torch.from_numpy(toks))
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert tuple(got.shape) == tuple(want.shape)
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- whole server
def test_fp32_greedy_tokens_identical(ref_params):
    prompts = _prompts(6, seed=3)
    want = _serve(_jserver(ref_params), prompts, max_new=6)
    got = _serve(_server(ref_params), prompts, max_new=6)
    assert got == want


def test_int8_tokens_agree_with_reference(ref_params):
    prompts = _prompts(6, seed=5)
    jsrv = _jserver(ref_params, kv_dtype="int8")
    tsrv = _server(ref_params, kv_dtype="int8")
    want = _serve(jsrv, prompts, max_new=6)
    got = _serve(tsrv, prompts, max_new=6)
    assert tsrv.stats["kv_dtype_effective"] == "int8"
    assert jsrv.stats["kv_dtype_effective"] == "int8"
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
    agreement = sum(a == b for a, b in pairs) / len(pairs)
    assert agreement >= 0.99, (agreement, got, want)


def test_decode_matches_autoregressive_reference(ref_params):
    """Decode tokens equal greedy argmax of the full forward re-run at
    every step (fp32 cache), and equal the reference server's."""
    srv = _server(ref_params, prompt_buckets=(4, 8, 16), max_new=8)
    srv.start(warm=True)
    try:
        for prompt in ([5], [1, 2, 3], [7, 3, 9, 2, 11]):
            got = srv.submit(prompt, max_new=8).result(timeout=60)
            toks, want = list(prompt), []
            for _ in range(8):
                n = len(toks)
                bucket = next(b for b in srv.prompt_buckets if n <= b)
                arr = torch.zeros((1, bucket), dtype=torch.long)
                arr[0, :n] = torch.tensor(toks)
                logits, _, _ = srv._prefill_fn(srv.params, arr)
                t = int(torch.argmax(logits[0, n - 1]))
                want.append(t)
                toks.append(t)
            assert got == want, (prompt, got, want)
    finally:
        srv.close()
    assert srv.stats["compiles"] == 0


def test_eviction_preempts_and_resumes_exactly(ref_params):
    """A pool that fits two concurrent sequences serves four; the
    preempted ones re-prefill and finish with the uncontended tokens,
    which equal the reference's."""
    want = _serve(_jserver(ref_params, prompt_buckets=(4,), max_new=5),
                  [[1, 2, 3]], max_new=5)[0]
    srv = _server(ref_params, prompt_buckets=(4,), max_new=5, slots=4,
                  pool_budget=4 * 1024, evict_after_ms=2.0)
    srv.start(warm=True)
    assert srv.pool.num_pages == 4
    try:
        hs = [srv.submit([1, 2, 3], max_new=5) for _ in range(4)]
        outs = [h.result(timeout=60) for h in hs]
    finally:
        srv.close()
    assert all(out == want for out in outs), (outs, want)
    assert srv.stats["evictions"] >= 1
    assert srv.pool.pages_in_use == 0


def test_token_budget_rejections_are_structured():
    srv = _server()
    srv.start(warm=True)
    try:
        with pytest.raises(ServeRejected) as e:
            srv.submit(list(range(9)))  # > largest bucket (8)
        assert e.value.reason == "token_budget"
        with pytest.raises(ServeRejected) as e:
            srv.submit([1], max_new=10 ** 6)  # > whole pool
        assert e.value.reason == "token_budget"
        assert len(srv.submit([1, 2]).result(timeout=60)) == 6
    finally:
        srv.close()
    with pytest.raises(ServeRejected) as e:
        srv.submit([1])
    assert e.value.reason == "shutdown"


def test_int8_gate_adopts_on_measured_agreement():
    srv = _server(kv_dtype="int8", max_new=8)
    srv.start(warm=True)
    try:
        assert srv.kv_agreement is not None
        assert srv.kv_agreement >= 0.99, srv.kv_agreement
        assert srv.stats["kv_dtype_effective"] == "int8"
        assert srv.pool.k_pages.dtype == torch.int8
        assert len(srv.submit([1, 2, 3], max_new=6).result(60)) == 6
    finally:
        srv.close()


def test_int8_gate_falls_back_below_floor():
    srv = _server(kv_dtype="int8", agreement_floor=1.01)
    srv.start(warm=True)
    try:
        assert srv.stats["kv_dtype_effective"] == "float32"
        assert srv.pool.dtype == "float32"
        assert len(srv.submit([1, 2, 3], max_new=6).result(60)) == 6
    finally:
        srv.close()


def test_decode_fault_trips_breaker_reclaims_pages_and_recovers():
    srv = _server(breaker_limit=2)
    srv.start(warm=True)
    try:
        t_faultsim.reset("serve.decode:raise@1-2")
        hs = [srv.submit([1, 2, 3], max_new=6) for _ in range(3)]
        reasons = []
        for h in hs:
            with pytest.raises(ServeRejected) as e:
                h.result(timeout=15)
            reasons.append(e.value.reason)
        assert "model_error" in reasons, reasons
        assert srv.stats["breaker_trips"] == 1
        assert srv.pool.pages_in_use == 0, "page leak through the trip"
        with pytest.raises(ServeRejected) as e:
            srv.submit([1], max_new=2)
        assert e.value.reason == "breaker_open"
        t_faultsim.reset("")
        deadline = time.monotonic() + 10
        out = None
        while time.monotonic() < deadline:
            try:
                out = srv.submit([1, 2, 3], max_new=6).result(timeout=15)
                break
            except ServeRejected:
                time.sleep(0.05)
        assert out is not None and len(out) == 6
        assert srv.pool.pages_in_use == 0
    finally:
        t_faultsim.reset("")
        srv.close()


def test_report_keys_match_reference(ref_params):
    jsrv = _jserver(ref_params)
    tsrv = _server(ref_params)
    for srv in (jsrv, tsrv):
        srv.start(warm=True)
        try:
            srv.submit([1, 2, 3], max_new=4).result(timeout=60)
            rep = srv.report()
        finally:
            srv.close()
        if srv is jsrv:
            want = rep
    assert sorted(rep) == sorted(want)
    assert rep["tokens"] == want["tokens"] == 4
    assert rep["tokens_s"] > 0 and rep["ttft_p50_ms"] > 0


def test_paged_race_runs_and_caches(tmp_path, monkeypatch):
    """The warmup race of the paged decode walks records its winner in
    autotune.json keyed by platform 'cpu'; a second server answers
    from the cache."""
    monkeypatch.setenv("MXNET_AUTOTUNE", "1")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE_DIR", str(tmp_path))
    t_autotune.cache_clear()
    try:
        srv = _server(prompt_buckets=(4,), max_new=4)
        srv.start(warm=True)
        srv.close()
        rep = srv._autotune_report["paged_decode_attention"]
        assert rep["winner"] in ("gather", "paged")
        assert rep["cached"] is False
        assert set(rep["timings"]) == {"gather", "paged"}
        keys = list(t_autotune._load(t_autotune.cache_path()))
        assert len(keys) == 1 and keys[0].split("|")[3] == "cpu"
        srv2 = _server(prompt_buckets=(4,), max_new=4)
        srv2.start(warm=True)
        srv2.close()
        rep2 = srv2._autotune_report["paged_decode_attention"]
        assert rep2["cached"] is True
        assert srv2._paged_variant == rep["winner"]
    finally:
        t_autotune.cache_clear()


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(MXNetError):
        GenerativeServer(device="cuda")
    with pytest.raises(MXNetError):
        GenerativeServer()  # the default device is cuda:0
