"""Generative decode serving: paged-KV continuous batching (counterpart
of ``mxnet_tpu/serving/generate.py``).

An autoregressive decoder where every sequence carries per-request
device state (its KV cache) across many steps, served by a scheduler
thread with two levers:

**Paged KV cache** (serving.kvcache.PagedKVPool): per-sequence KV
pages from a fixed pool under a byte budget, admitted by token budget
(``prompt + max_new`` reserved up front).  ``kv_dtype="int8"`` stores
pages int8 with per-(token, head) scales, adopted only when a warmup
probe measures per-token greedy agreement with an fp32-cache sibling
at or above ``agreement_floor``.

**Prefill/decode disaggregation** with token-level continuous
batching: prompts prefill one at a time on bucketed lengths, every
layer through :func:`~mxnet_tpu_torch.ops.flash_attention.flash_attention`
— on the card the hand-written kernel — and the decode step runs over
a fixed slot tensor (``MXNET_DECODE_SLOTS``); sequences are admitted
and evicted between tokens by in-place slot updates.  Decode attention
walks the page table via ``paged_decode_attention``, whose gather and
paged walks race at warmup (``autotune.tune``).

Failure story: a ``serve.decode`` fault point fires inside every decode
step; consecutive failures trip the breaker — in-flight sequences
finish with ``ServeRejected(reason="model_error")``, queued requests
shed ``breaker_open``, every pool page is reclaimed — then probe steps
re-warm and close it.

Numerics held to the reference: fp32 matmuls with TF32 off on the
card, tanh-approximated GELU (``jax.nn.gelu``'s default), argmax on
fp32 logits (first index on ties in both frameworks).
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve_device
from ..gluon._graph import device_lock
from ..ops.flash_attention import flash_attention, paged_decode_attention
from ..quantization.kv import kv_quantize
from ..resilience import faultsim
from .kvcache import PagedKVPool
from .server import ServeRejected

__all__ = ["GenerativeServer", "GenerateHandle", "toy_decoder_params",
           "params_from_numpy"]

faultsim.register_point(
    "serve.decode",
    "inside every generative decode step (delay=slow token, "
    "raise=transient step failure, nan=poisoned logits, crash=hard "
    "death)")
faultsim.register_point(
    "serve.prefill", "before each bucketed prefill dispatch")

#: the flash_attention variant prefill asks for: on a CUDA tensor the
#: hand-written kernel, on a CPU tensor the plain version
_PREFILL_VARIANT = "pallas_pad"


def toy_decoder_params(seed=0, vocab=32, layers=2, heads=2, head_dim=8,
                       mlp_mult=2, device=None, generator=None):
    """Deterministic decoder-only transformer params (pre-norm rmsnorm
    blocks) in the reference's layout: ``embed`` (vocab, E), ``head``
    (E, vocab), ``lnf`` and per layer ``wq wk wv wo w1 w2 ln1 ln2``,
    every projection applied as ``h @ W``.  The attention output
    projection is scaled down so greedy argmax margins stay wide
    relative to int8 KV-cache noise.

    Draws from ``generator`` (default: a ``torch.Generator`` on
    ``device`` seeded with ``seed``); the numbers differ from the
    reference's ``jax.random`` stream — carry the reference's weights
    across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(int(seed))
    embed = heads * head_dim

    def init(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * scale).to(dev)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=dev)

    params = {
        "embed": init((vocab, embed), 1.0),
        "head": init((embed, vocab), 3.0 / embed ** 0.5),
        "lnf": ones(embed),
        "layers": [],
    }
    for _ in range(layers):
        params["layers"].append({
            "wq": init((embed, embed), embed ** -0.5),
            "wk": init((embed, embed), embed ** -0.5),
            "wv": init((embed, embed), embed ** -0.5),
            "wo": init((embed, embed), 0.25 * embed ** -0.5),
            "w1": init((embed, mlp_mult * embed), embed ** -0.5),
            "w2": init((mlp_mult * embed, embed),
                       (mlp_mult * embed) ** -0.5),
            "ln1": ones(embed),
            "ln2": ones(embed),
        })
    return params


def _tree_map(fn, tree):
    """``fn`` over the leaves of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device=None):
    """The reference's parameter tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, mxnet_tpu.serving.toy_decoder_params())``)
    -> the port's tree of tensors on ``device``, copied."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.tensor(onp.asarray(a), device=dev),
                     tree)


def _rmsnorm(x, g):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True)
                           + 1e-6) * g


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class GenerateHandle:
    """Future for one generation request: resolves to the generated
    token list or raises the ServeRejected the scheduler assigned."""

    def __init__(self, seq_id):
        self.seq_id = seq_id
        self._done = threading.Event()
        self._tokens = None
        self._err = None
        self.ttft_ms = None
        self.latency_ms = None
        self.evicted = 0

    def _finish(self, tokens=None, err=None):
        if self._done.is_set():
            return
        self._tokens = tokens
        self._err = err
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"generation {self.seq_id} still running")
        if self._err is not None:
            raise self._err
        return self._tokens


class _Seq:
    __slots__ = ("id", "handle", "prompt", "max_new", "generated",
                 "slot", "t_submit", "t_first", "deadline", "evictions",
                 "counted_admit")

    def __init__(self, seq_id, handle, prompt, max_new, deadline):
        self.id = seq_id
        self.handle = handle
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.generated = []
        self.slot = None
        self.t_submit = time.monotonic()
        self.t_first = None
        self.deadline = deadline
        self.evictions = 0
        self.counted_admit = False

    @property
    def context(self):
        """Tokens to (re)prefill: the prompt plus everything already
        generated — an evicted sequence resumes exactly where the
        preemption cut it."""
        return self.prompt + self.generated

    @property
    def budget_tokens(self):
        """Pages are reserved for this many tokens at admission."""
        return len(self.prompt) + self.max_new


class GenerativeServer:
    """Token-level continuous-batching server over a paged KV cache.

    ``submit(prompt_tokens, max_new=...)`` returns a
    :class:`GenerateHandle`; a scheduler thread prefills queued
    prompts into free decode slots (token-budget admission against the
    page pool) and steps all active slots one token at a time,
    admitting and evicting between tokens.  Runs on ``device``
    (default ``cuda:0``; ``"cpu"`` runs the plain versions)."""

    def __init__(self, params=None, seed=0, vocab=32, layers=2, heads=2,
                 head_dim=8, prompt_buckets=(4, 8, 16), max_new=16,
                 slots=None, page_tokens=None, pool_budget=None,
                 kv_dtype=None, agreement_floor=0.99, slo_ms=5000.0,
                 queue_depth=64, breaker_limit=3, evict_after_ms=100.0,
                 eos_id=None, name="generate", kv_gate=True,
                 device=None):
        from ..config import get_env

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # a TF32 prefill would flip greedy tokens against the host
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.name = name
        self.vocab = int(vocab)
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.params = _tree_map(lambda t: t.to(self.device), params) \
            if params is not None else \
            toy_decoder_params(seed=seed, vocab=vocab, layers=layers,
                               heads=heads, head_dim=head_dim,
                               device=self.device)
        self.prompt_buckets = tuple(sorted(set(int(b)
                                               for b in prompt_buckets)))
        self.max_new = int(max_new)
        self.slots = int(slots if slots is not None
                         else get_env("MXNET_DECODE_SLOTS"))
        self.slo_ms = float(slo_ms)
        self.queue_depth = int(queue_depth)
        self.breaker_limit = int(breaker_limit)
        self.evict_after_ms = float(evict_after_ms)
        self.eos_id = eos_id
        self.agreement_floor = float(agreement_floor)
        self._kv_gate = bool(kv_gate)
        self._page_tokens = page_tokens
        self._pool_budget = pool_budget
        self._kv_dtype_requested = str(
            kv_dtype if kv_dtype is not None
            else get_env("MXNET_KV_DTYPE"))
        self.kv_agreement = None

        self.max_seq_tokens = self.prompt_buckets[-1] + self.max_new
        self.pool = None
        self.stats = {
            "requests": 0, "admitted": 0, "completed": 0, "shed": 0,
            "rejected": {}, "tokens": 0, "prefills": 0, "evictions": 0,
            "decode_failures": 0, "breaker_trips": 0, "compiles": 0,
            "warm_traces": 0, "max_in_flight": 0,
            "kv_dtype_effective": None,
        }
        self._ttft_ms = []
        self._latency_ms = []
        self._lock = threading.RLock()
        self._queue = collections.deque()
        self._seq_counter = 0
        self._stop = False
        self._draining = False
        self._started = False
        self._breaker_open = False
        self._fail_count = 0
        self._rewarm_at = 0.0
        self._rewarm_backoff = 0.05
        self._thread = None
        self._traced = set()
        self._t_start = time.monotonic()
        self._paged_variant = None
        self._autotune_report = {}

    # ------------------------------------------------------- lifecycle
    def start(self, warm=True):
        if self._started:
            return self
        self._build(self._kv_dtype_requested, warm=warm)
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.name}-sched",
                                        daemon=True)
        self._started = True
        self._thread.start()
        if warm and self.pool.dtype == "int8" and self._kv_gate:
            agreement = self._agreement_probe()
            self.kv_agreement = agreement
            if agreement < self.agreement_floor:
                # below the measured floor int8 never ships: rebuild
                # the pool fp32
                self._build("float32", warm=warm)
        self.stats["kv_dtype_effective"] = self.pool.dtype
        self._reset_campaign_stats()
        return self

    def _build(self, kv_dtype, warm):
        # device work beside other threads' captures: _graph.device_lock
        with device_lock.shared(), self._lock:
            if self.pool is not None:
                self.pool.reset()
            self.pool = PagedKVPool(
                self.layers, self.heads, self.head_dim,
                page_tokens=self._page_tokens,
                budget_bytes=self._pool_budget, dtype=kv_dtype,
                device=self.device)
            self.max_pages = self.pool.pages_needed(self.max_seq_tokens)
            s = self.slots
            self._slot_seq = [None] * s
            self._page_table = onp.zeros((s, self.max_pages), onp.int64)
            self._seq_lens = onp.zeros(s, onp.int64)
            self._last_tokens = onp.zeros(s, onp.int64)
            self._active = onp.zeros(s, bool)
            self._race_variants()
            if warm:
                self._warmup()

    def _race_variants(self):
        """Warmup-time race of the paged decode attention's gather and
        paged walks on the real pool shape (cached winners answer
        without re-measuring).  Prefill always takes the flash kernel
        on the card; its race against other arms is not ported yet."""
        from .. import autotune

        pool_shape = (self.slots, self.pool.num_pages + 1,
                      self.pool.page_tokens, self.heads, self.head_dim)
        winner, info = autotune.tune(
            "paged_decode_attention", pool_shape, self.pool.dtype,
            autotune.VARIANT_OPS["paged_decode_attention"],
            self._measure_paged, platform=self.device.type)
        self._paged_variant = winner
        self._autotune_report = {
            "paged_decode_attention": {"winner": winner, **info}}

    def _measure_paged(self, _value):
        from ..autotune import time_call

        k_pages, v_pages, k_scale, v_scale = self.pool.arrays()
        int8 = self.pool.dtype == "int8"
        dev = self.device
        q = torch.ones((self.slots, self.heads, self.head_dim),
                       dtype=torch.float32, device=dev)
        pt = torch.zeros((self.slots, self.max_pages), dtype=torch.long,
                         device=dev)
        sl = torch.full((self.slots,), self.pool.page_tokens,
                        dtype=torch.long, device=dev)
        return time_call(lambda: paged_decode_attention(
            q, k_pages[0], v_pages[0], pt, sl,
            k_scale=k_scale[0] if int8 else None,
            v_scale=v_scale[0] if int8 else None), dev, iters=4)

    def _warmup(self):
        """Run every program the campaign needs once — one prefill per
        bucket, the decode step over the all-inactive slot state, a
        pool write — so a campaign starts warm (stats['compiles']
        counts programs first seen after warmup)."""
        for bucket in self.prompt_buckets:
            toks = torch.zeros((1, bucket), dtype=torch.long,
                               device=self.device)
            self._prefill_fn(self.params, toks)
            self._note_program(("prefill", bucket), warm=True)
        self._decode_state_step()
        self._note_program(("decode", self.slots), warm=True)
        scratch = "__warm__"
        self.pool.alloc(scratch, self.pool.page_tokens)
        zeros = torch.zeros((self.layers, 1, self.heads, self.head_dim),
                            dtype=torch.float32, device=self.device)
        self.pool.write_prompt(scratch, zeros, zeros)
        self.pool.free(scratch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reset_campaign_stats(self):
        with self._lock:
            for k in ("requests", "admitted", "completed", "shed",
                      "tokens", "prefills", "evictions",
                      "decode_failures", "breaker_trips", "compiles",
                      "max_in_flight"):
                self.stats[k] = 0
            self.stats["rejected"] = {}
            self._ttft_ms = []
            self._latency_ms = []
            self._t_start = time.monotonic()

    def _agreement_probe(self, n_prompts=4, max_new=8):
        """Per-token greedy agreement of this (int8-cache) server
        against a throwaway fp32-cache sibling on deterministic probe
        prompts — the measured gate deciding whether int8 ships."""
        prompts = [[(3 * i + j) % self.vocab
                    for j in range(2 + i % (self.prompt_buckets[0]))]
                   for i in range(n_prompts)]
        ref = GenerativeServer(
            params=self.params, vocab=self.vocab, layers=self.layers,
            heads=self.heads, head_dim=self.head_dim,
            prompt_buckets=self.prompt_buckets, max_new=max_new,
            slots=self.slots, page_tokens=self.pool.page_tokens,
            pool_budget=self._pool_budget, kv_dtype="float32",
            kv_gate=False, name=f"{self.name}-ref", device=self.device)
        ref.start(warm=False)
        try:
            mine = [self.submit(p, max_new=max_new,
                                deadline_ms=60000).result(timeout=60)
                    for p in prompts]
            theirs = [ref.submit(p, max_new=max_new,
                                 deadline_ms=60000).result(timeout=60)
                      for p in prompts]
        finally:
            ref.close()
        agree = total = 0
        for a, b in zip(mine, theirs):
            for x, y in zip(a, b):
                agree += int(x == y)
                total += 1
        return agree / max(total, 1)

    # ------------------------------------------------------- the model
    def _prefill_fn(self, params, tokens, variant=_PREFILL_VARIANT):
        """Bucketed prefill of ``tokens`` (batch, seq): logits
        (batch, seq, vocab) and the stacked K/V (layers, batch, seq,
        heads, head_dim)."""
        b, seq = tokens.shape
        heads, d = self.heads, self.head_dim
        x = params["embed"][tokens]
        k_all, v_all = [], []
        for lyr in params["layers"]:
            h = _rmsnorm(x, lyr["ln1"])
            q = (h @ lyr["wq"]).reshape(b, seq, heads, d)
            k = (h @ lyr["wk"]).reshape(b, seq, heads, d)
            v = (h @ lyr["wv"]).reshape(b, seq, heads, d)
            attn = flash_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=True,
                variant=variant)
            x = x + attn.transpose(1, 2).reshape(b, seq, heads * d) \
                @ lyr["wo"]
            h2 = _rmsnorm(x, lyr["ln2"])
            x = x + _gelu(h2 @ lyr["w1"]) @ lyr["w2"]
            k_all.append(k)
            v_all.append(v)
        x = _rmsnorm(x, params["lnf"])
        logits = x @ params["head"]
        return logits, torch.stack(k_all), torch.stack(v_all)

    def _decode_fn(self, params, page_table, seq_lens, last_tokens,
                   active, variant=None):
        """One decode step over every slot: writes each active slot's
        new K/V into its page (in place) and returns the new
        ``(seq_lens, next_tokens)``."""
        pool = self.pool
        s = last_tokens.shape[0]
        heads, d = self.heads, self.head_dim
        t = pool.page_tokens
        int8 = pool.dtype == "int8"
        x = params["embed"][last_tokens]
        page_idx = page_table[torch.arange(s, device=self.device),
                              seq_lens // t]
        offset = seq_lens % t
        # the just-written token is attended in the same step; an
        # inactive slot masks everything out (exact-zero output row).
        # Inactive slots all write null page 0 at offset 0: duplicate
        # indices land in no fixed order, harmless behind this mask
        eff_len = torch.where(active, seq_lens + 1,
                              torch.zeros_like(seq_lens))
        for li, lyr in enumerate(params["layers"]):
            h = _rmsnorm(x, lyr["ln1"])
            q = (h @ lyr["wq"]).reshape(s, heads, d)
            k_new = (h @ lyr["wk"]).reshape(s, heads, d)
            v_new = (h @ lyr["wv"]).reshape(s, heads, d)
            if int8:
                kq, ksc = kv_quantize(k_new)
                vq, vsc = kv_quantize(v_new)
                pool.k_pages[li, page_idx, offset] = kq
                pool.v_pages[li, page_idx, offset] = vq
                pool.k_scale[li, page_idx, offset] = ksc
                pool.v_scale[li, page_idx, offset] = vsc
                attn = paged_decode_attention(
                    q, pool.k_pages[li], pool.v_pages[li], page_table,
                    eff_len, k_scale=pool.k_scale[li],
                    v_scale=pool.v_scale[li], variant=variant)
            else:
                pool.k_pages[li, page_idx, offset] = k_new
                pool.v_pages[li, page_idx, offset] = v_new
                attn = paged_decode_attention(
                    q, pool.k_pages[li], pool.v_pages[li], page_table,
                    eff_len, variant=variant)
            x = x + attn.reshape(s, heads * d) @ lyr["wo"]
            h2 = _rmsnorm(x, lyr["ln2"])
            x = x + _gelu(h2 @ lyr["w1"]) @ lyr["w2"]
        x = _rmsnorm(x, params["lnf"])
        logits = x @ params["head"]
        next_tok = torch.argmax(logits, dim=-1)
        next_tok = torch.where(active, next_tok, last_tokens)
        seq_lens = torch.where(active, seq_lens + 1, seq_lens)
        return seq_lens, next_tok

    def _decode_state_step(self):
        """One decode step over the current slot state; updates the
        pool and the host mirrors, returns the per-slot next-token row.
        Raises on injected faults (the caller owns breaker
        accounting)."""
        poison = faultsim.inject("serve.decode")
        if poison == "nan":
            raise MXNetError(
                "non-finite decode logits (poisoned by fault "
                "injection)")
        dev = self.device
        seq_lens, next_tok = self._decode_fn(
            self.params, torch.as_tensor(self._page_table, device=dev),
            torch.as_tensor(self._seq_lens, device=dev),
            torch.as_tensor(self._last_tokens, device=dev),
            torch.as_tensor(self._active, device=dev),
            variant=self._paged_variant)
        # host mirrors, read back every step
        self._seq_lens = seq_lens.cpu().numpy().copy()
        next_np = next_tok.cpu().numpy().copy()
        self._last_tokens = next_np
        return next_np

    # ------------------------------------------------------ accounting
    def _note_program(self, key, warm=False):
        if key in self._traced:
            return
        self._traced.add(key)
        with self._lock:
            self.stats["warm_traces" if warm else "compiles"] += 1

    def _reject(self, reason, detail=""):
        with self._lock:
            self.stats["shed"] += 1
            self.stats["rejected"][reason] = \
                self.stats["rejected"].get(reason, 0) + 1
        return ServeRejected(reason, detail)

    # ------------------------------------------------------- admission
    def submit(self, prompt, max_new=None, deadline_ms=None):
        """Queue a prompt (iterable of token ids) for generation.

        Token-budget admission: rejected outright
        (``reason="token_budget"``) when ``prompt + max_new`` exceeds
        what the whole pool could ever hold; queued otherwise."""
        faultsim.inject("serve.admit")
        prompt = [int(x) for x in prompt]
        max_new = self.max_new if max_new is None else int(max_new)
        budget_ms = self.slo_ms if deadline_ms is None \
            else float(deadline_ms)
        with self._lock:
            if not self._started or self._stop:
                raise self._reject("shutdown", "server not running")
            if self._draining:
                raise self._reject("draining", "server is draining")
            if self._breaker_open:
                raise self._reject(
                    "breaker_open",
                    "circuit breaker open after consecutive decode "
                    "failures")
            if len(self._queue) >= self.queue_depth:
                raise self._reject(
                    "queue_full", f"{len(self._queue)} queued")
            if not prompt or len(prompt) > self.prompt_buckets[-1]:
                raise self._reject(
                    "token_budget",
                    f"prompt length {len(prompt)} outside (0, "
                    f"{self.prompt_buckets[-1]}]")
            total = len(prompt) + max_new
            if self.pool.pages_needed(total) > self.pool.num_pages:
                raise self._reject(
                    "token_budget",
                    f"{total} tokens exceed the pool's "
                    f"{self.pool.capacity_tokens}-token budget")
            self._seq_counter += 1
            handle = GenerateHandle(self._seq_counter)
            seq = _Seq(self._seq_counter, handle, prompt, max_new,
                       time.monotonic() + budget_ms / 1e3)
            self._queue.append(seq)
            self.stats["requests"] += 1
        return handle

    def _bucket_for(self, n):
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise MXNetError(f"no prefill bucket holds {n} tokens")

    def _free_slot(self):
        for i, s in enumerate(self._slot_seq):
            if s is None:
                return i
        return None

    def _admit(self):
        """Admit queued sequences into free slots between tokens.
        Under page/slot pressure the head may preempt the most recently
        admitted sequence after ``evict_after_ms``; an evicted sequence
        resumes by re-prefill and is never evicted twice."""
        while True:
            with self._lock:
                if not self._queue or self._stop or self._breaker_open:
                    return
                seq = self._queue[0]
                now = time.monotonic()
                if now > seq.deadline:
                    self._queue.popleft()
                    seq.handle._finish(err=self._reject(
                        "expired", "deadline passed while queued"))
                    continue
                slot = self._free_slot()
                ok = slot is not None and \
                    self.pool.can_admit(seq.budget_tokens)
                if ok:
                    self._queue.popleft()
                else:
                    waited_ms = (now - seq.t_submit) * 1e3
                    if waited_ms >= self.evict_after_ms:
                        victim = self._evict_candidate()
                        if victim is not None:
                            self._evict(victim)
                            continue
                    return
            if ok:
                try:
                    self._install(seq, slot)
                except ServeRejected as err:
                    seq.handle._finish(err=err)
                except Exception as exc:
                    self._model_failure(exc)
                    seq.handle._finish(err=self._reject(
                        "model_error", repr(exc)))
                    return

    def _evict_candidate(self):
        """The most recently admitted active sequence never evicted
        before and still fitting a prefill bucket on resume (caller
        holds the lock); None = nobody evictable."""
        best = None
        for seq in self._slot_seq:
            if seq is None or seq.evictions > 0:
                continue
            if len(seq.context) > self.prompt_buckets[-1]:
                continue
            if best is None or seq.id > best.id:
                best = seq
        return best

    def _evict(self, seq):
        """Preempt a running sequence in place: free its pages, null its
        slot row, requeue it right behind the head."""
        slot = seq.slot
        self.pool.free(seq.id)
        self._clear_slot(slot)
        seq.slot = None
        seq.evictions += 1
        seq.handle.evicted += 1
        self._queue.insert(1 if len(self._queue) >= 1 else 0, seq)
        self.stats["evictions"] += 1

    def _clear_slot(self, slot):
        self._slot_seq[slot] = None
        self._page_table[slot] = 0
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
        self._active[slot] = False

    def _install(self, seq, slot):
        """Bucketed prefill + slot install: the prefill/decode
        disaggregation boundary."""
        faultsim.inject("serve.prefill")
        context = seq.context
        n = len(context)
        bucket = self._bucket_for(n)
        toks = onp.zeros((1, bucket), onp.int64)
        toks[0, :n] = context
        logits, k, v = self._prefill_fn(
            self.params, torch.as_tensor(toks, device=self.device))
        self._note_program(("prefill", bucket))
        with self._lock:
            self.stats["prefills"] += 1
            if not seq.counted_admit:
                seq.counted_admit = True
                self.stats["admitted"] += 1
        first = int(torch.argmax(logits[0, n - 1]))
        self.pool.alloc(seq.id, seq.budget_tokens)
        self.pool.write_prompt(seq.id, k[:, 0, :n], v[:, 0, :n])
        now = time.monotonic()
        if seq.t_first is None:
            seq.t_first = now
            seq.handle.ttft_ms = (now - seq.t_submit) * 1e3
            with self._lock:
                self._ttft_ms.append(seq.handle.ttft_ms)
        seq.generated.append(first)
        with self._lock:
            self.stats["tokens"] += 1
        if self._seq_done(seq):
            self._finish_seq(seq, slot=None)
            return
        seq.slot = slot
        self._slot_seq[slot] = seq
        self._page_table[slot] = self.pool.page_table_row(
            seq.id, self.max_pages)
        self._seq_lens[slot] = n
        self._last_tokens[slot] = first
        self._active[slot] = True
        with self._lock:
            in_flight = int(self._active.sum())
            self.stats["max_in_flight"] = max(
                self.stats["max_in_flight"], in_flight)

    def _seq_done(self, seq):
        if len(seq.generated) >= seq.max_new:
            return True
        return self.eos_id is not None and \
            seq.generated[-1] == self.eos_id

    def _finish_seq(self, seq, slot):
        self.pool.free(seq.id)
        if slot is not None:
            self._clear_slot(slot)
        seq.handle.latency_ms = (time.monotonic() - seq.t_submit) * 1e3
        with self._lock:
            self.stats["completed"] += 1
            self._latency_ms.append(seq.handle.latency_ms)
        seq.handle._finish(tokens=list(seq.generated))

    # ------------------------------------------------------ the loop
    def _loop(self):
        while not self._stop:
            try:
                if self._breaker_open:
                    with device_lock.shared():
                        self._try_rewarm()
                    time.sleep(0.002)
                    continue
                with device_lock.shared():
                    self._admit()
                    if self._active.any():
                        self._step_once()
                        continue
                if not self._queue:
                    time.sleep(0.001)
            except Exception:  # the loop must survive anything
                time.sleep(0.005)

    def _step_once(self):
        try:
            next_np = self._decode_state_step()
        except Exception as exc:
            self._model_failure(exc)
            return
        self._fail_count = 0
        stepped = [(slot, seq)
                   for slot, seq in enumerate(list(self._slot_seq))
                   if seq is not None and self._active[slot]]
        # count before finishing any handle: a caller woken by result()
        # must never read a stats snapshot missing this step
        if stepped:
            with self._lock:
                self.stats["tokens"] += len(stepped)
        for slot, seq in stepped:
            seq.generated.append(int(next_np[slot]))
            if self._seq_done(seq):
                self._finish_seq(seq, slot)

    def _model_failure(self, exc):
        with self._lock:
            self._fail_count += 1
            self.stats["decode_failures"] += 1
            trip = self._fail_count >= self.breaker_limit \
                and not self._breaker_open
            if trip:
                self._breaker_open = True
                self.stats["breaker_trips"] += 1
                self._rewarm_at = time.monotonic() + \
                    self._rewarm_backoff
        if not trip:
            return
        # in-flight sequences fail structured and every page comes back
        for slot, seq in enumerate(list(self._slot_seq)):
            if seq is None:
                continue
            seq.handle._finish(err=self._reject("model_error",
                                                repr(exc)))
            self._clear_slot(slot)
        with self._lock:
            queued, self._queue = list(self._queue), \
                collections.deque()
        for seq in queued:
            seq.handle._finish(err=self._reject(
                "breaker_open", "breaker tripped while queued"))
        self.pool.reset()

    def _try_rewarm(self):
        if time.monotonic() < self._rewarm_at:
            return
        try:
            self._decode_state_step()  # all slots inactive: a probe
        except Exception:
            self._rewarm_backoff = min(self._rewarm_backoff * 2, 2.0)
            self._rewarm_at = time.monotonic() + self._rewarm_backoff
            return
        with self._lock:
            self._breaker_open = False
            self._fail_count = 0
            self._rewarm_backoff = 0.05

    # ------------------------------------------------------- reporting
    def in_flight(self):
        return int(self._active.sum())

    def report(self):
        """Snapshot with the keys of the reference's ``generate``
        record (the run-log record itself is not ported yet)."""
        from ..telemetry.opstats import percentile

        with self._lock:
            st = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in self.stats.items()}
            ttft = sorted(self._ttft_ms)
            wall = max(time.monotonic() - self._t_start, 1e-9)
        return {
            "name": self.name,
            "tokens": st["tokens"],
            "tokens_s": round(st["tokens"] / wall, 2),
            "ttft_p50_ms": round(percentile(ttft, 0.50), 3)
            if ttft else None,
            "ttft_p99_ms": round(percentile(ttft, 0.99), 3)
            if ttft else None,
            "in_flight": self.in_flight(),
            "max_in_flight": st["max_in_flight"],
            "evictions": st["evictions"],
            "shed": st["shed"],
            "pages_in_use": self.pool.pages_in_use,
            "queue_depth": len(self._queue),
            "kv_dtype": self.pool.dtype,
            "compiles": st["compiles"],
        }

    def drain(self, timeout=10.0):
        """Stop admission, let queued + in-flight sequences finish."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._queue and not self._active.any()
            if idle:
                return True
            time.sleep(0.005)
        return False

    def close(self):
        with self._lock:
            self._stop = True
            self._draining = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
            slot_seqs = [s for s in self._slot_seq if s is not None]
        for seq in leftovers + slot_seqs:
            seq.handle._finish(err=ServeRejected(
                "shutdown", "server closed"))
        if self.pool is not None:
            self.pool.reset()
        self._started = False
