#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--profile]

Builds every CUDA kernel from ``mxnet_tpu_torch/csrc`` with nvcc, holds
each kernel against its plain PyTorch version on the card, then serves
the generative decoder end to end through ``GenerativeServer`` at the
width of the repo's generate benchmark and at a wide configuration,
checking the results.  Each phase prints one JSON line on stdout
(progress goes to stderr); ``--out`` also appends them to FILE.  Any
failed check exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.  Exits 2 and prints no result
when torch sees no CUDA card or the port's package is not beside this
script.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

#: the H100 SXM's published peaks (NVIDIA data sheet, dense): fp32 on
#: the CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

_out_file = None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if _out_file is not None:
        with open(_out_file, "a") as f:
            f.write(line + "\n")


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave nothing (exit {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, budget_ms=300.0):
    """Milliseconds per call of ``fn`` on the card: warm-up, then a
    run of launches between two CUDA events sized to ~budget_ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    rough = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(max(budget_ms / rough, 3), 500))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ kernels
def attention_work(bh, sq, sk, d, causal, dtype):
    """(flops, bytes) the function needs on these inputs: 2 FLOPs per
    multiply-add in QK^T and in PV over the visible (query, key) pairs;
    q, k, v read once and the output written once."""
    if causal:
        diag = sk - sq
        pairs = sum(max(0, min(sk, i + diag + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    size = 2 if dtype == "bfloat16" else 4
    return 4.0 * bh * pairs * d, float(size * bh * d * (2 * sq + 2 * sk))


def kernel_case(b, h, sq, sk, d, dtype, causal, path, seed):
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    dev = torch.device("cuda", 0)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(tdt)
    k = torch.randn((b, h, sk, d), generator=gen, device=dev).to(tdt)
    v = torch.randn((b, h, sk, d), generator=gen, device=dev).to(tdt)
    scale = 1.0 / math.sqrt(d)

    def kernel():
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               variant="pallas")

    def plain():
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale)

    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"kernel output {out.dtype} {tuple(out.shape)}")
    err = float((out.float() - ref.float()).abs().max())
    check(math.isfinite(err) and err <= TOL[dtype],
          f"flash kernel vs plain {b, h, sq, sk, d} {dtype} "
          f"causal={causal}: max abs err {err} > {TOL[dtype]}")
    masked_rows = 0
    if causal and sq > sk:
        masked_rows = sq - sk  # rows i with i + (sk - sq) < 0
        check(bool((out[:, :, :masked_rows] == 0).all()),
              "fully masked rows are not exactly 0")
    if causal and sq == sk:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=scale)
    elif causal:
        keep = (torch.arange(sk, device=dev)[None, :] <=
                torch.arange(sq, device=dev)[:, None] + (sk - sq))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=keep, scale=scale)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, scale=scale)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lib)
    flops, nbytes = attention_work(b * h, sq, sk, d, causal, dtype)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"path": path, "shape": [b, h, sq, sk, d], "dtype": dtype,
            "causal": causal, "max_abs_err": err, "tol": TOL[dtype],
            "masked_rows_exact_zero": masked_rows, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def kernel_cases():
    cases = []
    for s in (4, 8, 16):  # the bench-width server's prefill shapes
        cases.append((1, 2, s, s, 8, "float32", True, "serve_bench_width"))
    for s in (128, 512, 2048):  # the wide server's prefill shapes
        cases.append((1, 16, s, s, 128, "float32", True, "serve_wide"))
    for s in (128, 1000, 2048):
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append((2, 16, s, s, 128, dtype, causal, "check"))
    for sq in (1, 7):  # bottom-right alignment against a long cache
        cases.append((2, 16, sq, 2048, 128, "float32", True, "check"))
    cases.append((2, 16, 300, 100, 128, "float32", True, "check"))
    cases.append((1, 2, 20, 5, 8, "float32", True, "check"))
    return cases


# ------------------------------------------------------------ serving
def campaign(srv, rng, n_req, vocab, max_prompt):
    """Two bursts of ragged prompts submitted at once (bench.py's
    generate phase); every completed request must hold max_new token
    ids below vocab.  Returns (submitted, shed)."""
    from mxnet_tpu_torch.serving import ServeRejected

    shed = submitted = 0
    for _burst in range(2):
        handles = []
        for _ in range(n_req // 2):
            submitted += 1
            n = int(rng.integers(1, max_prompt + 1))
            prompt = [int(t) for t in rng.integers(0, vocab, n)]
            try:
                handles.append(srv.submit(prompt))
            except ServeRejected:
                shed += 1
        for hd in handles:
            try:
                toks = hd.result(timeout=300)
            except ServeRejected:
                shed += 1
                continue
            check(len(toks) == srv.max_new and
                  all(0 <= t < vocab for t in toks),
                  f"request {hd.seq_id} returned {toks}")
    return submitted, shed


def device_profile(prof, wall_s, top=12):
    """Kernel time by name from a torch.profiler run over ``wall_s``
    seconds of one stream: the busy share is the kernels' summed self
    device time over the wall time."""
    rows = []
    for evt in prof.key_averages():
        t_us = getattr(evt, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "self_cuda_time_total", 0.0)
        if t_us > 0:
            rows.append((t_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return {"device_time": "not measured"}
    flash_us = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2])
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "flash_share_of_device": flash_us / busy_us,
        "top_kernels": [{"name": k[:96], "ms": t / 1e3, "calls": c,
                         "share": t / busy_us}
                        for t, c, k in rows[:top]],
    }


def serve_phase(name, cfg, device, n_req, params=None, profile=False):
    """Drive one GenerativeServer campaign; the flash launch count is
    set to 0 just before the server is built and read after start()
    and after the campaign.  ``profile`` wraps the campaign in
    torch.profiler (a separate run: its overhead is in its numbers)."""
    import contextlib

    import numpy as np
    import torch

    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.serving import GenerativeServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats() if device != "cpu" else None
    flash_attention.launches = 0
    srv = GenerativeServer(params=params, device=device, **cfg)
    try:
        srv.start(warm=True)
        t_start = time.perf_counter() - t0
        n_start = flash_attention.launches
        rng = np.random.default_rng(42)
        # device activity only: recording every host-side op slowed the
        # host-bound campaigns several times over
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) if profile \
            else contextlib.nullcontext()
        with prof:
            t1 = time.perf_counter()
            submitted, shed = campaign(srv, rng, n_req, cfg["vocab"],
                                       cfg["prompt_buckets"][-1])
            check(srv.drain(timeout=120.0), f"{name}: drain timed out")
            torch.cuda.synchronize() if device != "cpu" else None
            wall = time.perf_counter() - t1
        rep = srv.report()
        st = dict(srv.stats)
        n_end = flash_attention.launches
    finally:
        srv.close()
    res = {
        "phase": name, "requests": submitted, "completed": st["completed"],
        "shed": shed, "rejected_by_reason": st["rejected"],
        "prefills": st["prefills"], "layers": cfg["layers"],
        "flash_launches_start": n_start, "flash_launches": n_end,
        "flash_launches_campaign": n_end - n_start,
        "tokens": rep["tokens"], "tokens_s": rep["tokens_s"],
        "ttft_p50_ms": rep["ttft_p50_ms"],
        "ttft_p99_ms": rep["ttft_p99_ms"],
        "max_in_flight": rep["max_in_flight"],
        "evictions": rep["evictions"], "pages_in_use": rep["pages_in_use"],
        "kv_dtype": st["kv_dtype_effective"],
        "kv_agreement": srv.kv_agreement,
        "paged_variant": srv._paged_variant,
        "start_s": t_start, "campaign_s": wall,
    }
    if device != "cpu":
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        res["profile"] = device_profile(prof, wall)
    check(submitted == n_req, f"{name}: submitted {submitted}")
    check(st["completed"] + shed == submitted,
          f"{name}: completed {st['completed']} + shed {shed} != "
          f"{submitted}")
    check(st["completed"] >= 1, f"{name}: nothing completed")
    check(rep["pages_in_use"] == 0,
          f"{name}: {rep['pages_in_use']} pages in use after drain")
    if device != "cpu":  # the host runs the plain version, no kernel
        check(n_end - n_start == st["prefills"] * cfg["layers"],
              f"{name}: flash launches {n_end - n_start} over the "
              f"campaign != prefills {st['prefills']} x layers "
              f"{cfg['layers']}")
        check(n_end >= 1, f"{name}: flash kernel never launched")
    return res


def prefill_agreement(cfg, params, bucket, seed=7):
    """Prefill one random prompt of ``bucket`` tokens on the card (the
    flash kernel) and on the host (the plain versions), same weights;
    returns the max abs difference of logits and of K/V."""
    import torch

    from mxnet_tpu_torch.serving import GenerativeServer

    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg["vocab"], (1, bucket), generator=gen)
    out = {}
    for device in ("cuda", "cpu"):
        srv = GenerativeServer(params=params, device=device, **cfg)
        logits, k, v = srv._prefill_fn(srv.params, toks.to(srv.device))
        out[device] = [t.cpu() for t in (logits, k, v)]
        del srv
    return [float((a - b).abs().max())
            for a, b in zip(out["cuda"], out["cpu"])]


def fixed_prompt_tokens(cfg, params, device, prompts, max_new):
    """Greedy tokens of fixed prompts through an fp32-KV server."""
    from mxnet_tpu_torch.serving import GenerativeServer

    c = dict(cfg, kv_dtype="float32")
    srv = GenerativeServer(params=params, device=device, **c)
    srv.start(warm=True)
    try:
        return [srv.submit(p, max_new=max_new,
                           deadline_ms=120000).result(timeout=120)
                for p in prompts]
    finally:
        srv.close()


BENCH_CFG = dict(  # bench.py:_measure_generate, full (not smoke)
    vocab=32, layers=2, heads=2, head_dim=8, prompt_buckets=(4, 8, 16),
    max_new=12, slots=8, page_tokens=4, pool_budget=64 * 1024,
    kv_dtype="int8", evict_after_ms=25.0, name="bench-generate")

WIDE_CFG = dict(
    vocab=32000, layers=4, heads=16, head_dim=128,
    prompt_buckets=(128, 512, 2048), max_new=32, slots=8,
    page_tokens=16, pool_budget=512 * 2 ** 20, kv_dtype="int8",
    evict_after_ms=25.0, slo_ms=60000.0, name="wide-generate")

WIDE_PREFILL_TOL = 1e-3

FIXED_PROMPTS = ([1, 2, 3], [5], [7, 3, 9, 2, 11],
                 [4, 15, 26, 9, 30, 1, 2, 8, 19, 0, 31, 12, 6])


def run(profile=False):
    import torch

    dev = "cuda"
    # the plain versions and the servers compute fp32 in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit_dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, **emit_dev,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    build_s = time.perf_counter() - t0
    for name in _kernels.sources():
        for line in (_kernels.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    emit({"phase": "build", "sources": _kernels.sources(),
          "compiled": built, "seconds": build_s})

    cases = []
    for i, case in enumerate(kernel_cases()):
        res = kernel_case(*case, seed=i)
        log(f"[kernels] {res['shape']} {res['dtype']} "
            f"causal={res['causal']} err={res['max_abs_err']:.3g} "
            f"ms={res['ms']:.4f} plain={res['plain_ms']:.4f} "
            f"sdpa={res['library_ms']:.4f} bound={res['bound_ms']:.4f}")
        cases.append(res)
    emit({"phase": "kernels", "kernel": "flash_attention",
          "cases": cases})

    bench = serve_phase("serve_bench_width", BENCH_CFG, dev, n_req=64,
                        profile=profile)
    from mxnet_tpu_torch.serving import toy_decoder_params

    small = toy_decoder_params(seed=0, vocab=32, layers=2, heads=2,
                               head_dim=8, device="cpu")
    fixed_cfg = {k: v for k, v in BENCH_CFG.items() if k != "name"}
    on_card = fixed_prompt_tokens(fixed_cfg, small, dev, FIXED_PROMPTS, 12)
    on_host = fixed_prompt_tokens(fixed_cfg, small, "cpu", FIXED_PROMPTS,
                                  12)
    bench["fixed_prompts_cuda_eq_cpu"] = on_card == on_host
    emit(bench)
    check(on_card == on_host,
          f"fp32-KV tokens differ, cuda {on_card} vs cpu {on_host}")

    wide_params = toy_decoder_params(seed=0, vocab=32000, layers=4,
                                     heads=16, head_dim=128, device=dev)
    wide = serve_phase("serve_wide", WIDE_CFG, dev, n_req=16,
                       params=wide_params, profile=profile)
    # the wide prefill on the card against the host's plain versions:
    # fp32 in both, summed in other orders through 4 layers
    errs = prefill_agreement(WIDE_CFG, wide_params, bucket=128)
    wide["prefill_cuda_vs_cpu_max_abs"] = dict(zip(("logits", "k", "v"),
                                                   errs))
    emit(wide)
    check(max(errs) <= WIDE_PREFILL_TOL,
          f"wide prefill cuda vs cpu max abs {errs} > {WIDE_PREFILL_TOL}")
    del wide_params

    main = [c for c in cases if c["path"] != "check"]
    head = next(c for c in cases if c["path"] == "serve_wide"
                and c["shape"][2] == 2048)
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:87",
        "launches": bench["flash_launches"] + wide["flash_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in main),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": emit_dev}), flush=True)


def main(argv=None):
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    ap.add_argument("--profile", action="store_true",
                    help="profile each serving campaign (kernel time by "
                         "name, device idle share); slows the campaign")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        log(f"chip_smoke: torch is not importable ({e})")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA card; nothing to drive")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        log(f"chip_smoke: no mxnet_tpu_torch package beside {__file__}")
        return 2
    sys.path.insert(0, here)
    if args.out:
        _out_file = os.path.abspath(args.out)
        os.makedirs(os.path.dirname(_out_file), exist_ok=True)
    # the paged-attention race records its winner here, not in $HOME
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["MXNET_AUTOTUNE_CACHE_DIR"] = cache_dir
    try:
        run(profile=args.profile)
    except Exception:  # any failed phase fails the run, loudly
        log(traceback.format_exc())
        return 1
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
