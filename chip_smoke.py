#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--profile] [--old-brc SOURCE]

Builds every CUDA kernel from ``mxnet_tpu_torch/csrc`` with nvcc,
checks that the flash kernel runs on the tensor cores (TF32 HMMA in
the SASS of each fp32 instantiation, bf16 HMMA in each bf16 one, no
register spills at head_dim 128 nor in the slab kernel that runs head
dims above 128) and so do the bf16 product kernels of
the fused backward (bf16 MMAs, no spills), holds each kernel against
its plain PyTorch version on the card (flash up to head_dim 256), serves
the generative decoder end to end through ``GenerativeServer`` at the
width of the repo's generate benchmark, at that width with head_dim 256
and at a wide configuration, drives
the imperative front end (the operator plugin through
``mx.library.load``, ``mx.nd.plugin_scaled_add`` under ``autograd`` on
``mx.gpu(0)`` at ResNet-50's residual shapes, a manual ``mx.nd``
training loop against the same loop on the host, a ``.params`` round
trip), then trains ResNet-50 (full width and depth, bf16) with the
flat-bucket optimizer kernels five ways: v1 in the kernel-arm
configuration (channel-last, bias-free 1x1 convs, the fused
BN-ReLU-1x1-conv backward) with SGD through
``parallel.make_train_step`` (batch 128), LARS through
``parallel.DataParallelTrainer`` (batch 256) and Adam (batch 128), and
``get_model("resnet50_v1")`` and ``get_model("resnet50_v2")`` at the
reference's defaults (channel-first, the zoo's biases) with SGD (batch
128), and checks one fp32 step of each on the card against the host,
checking the results; then runs the imperative Gluon loop
(``autograd.record()`` -> ``backward`` -> ``gluon.Trainer.step``): the
example's LeNet on the reference's synthetic digits, the kernel-arm
ResNet-50 with a deferred stem in bf16 with fp32 masters and an LR
schedule (the fused backward on its path), and one fp32 Gluon step of
it on the card against the host; then the same ResNet-50 loop with the
net hybridized with both static flags, every step replaying the CUDA
graphs of its forward and backward (the fused backward launched from
the captured backward), three such steps equal to eager's, and the
zoo's default ``resnet50_v1()`` trained a few steps in fp32, exported
(``HybridBlock.export``) and read back on the card by
``gluon.SymbolBlock.imports`` and ``mx.mod.Module.load``, each
predicting as the Gluon net; then serves that zoo net: exported by
``deploy.export_model`` at batch 32 and served by
``serving.ModelServer.from_artifact`` (one captured CUDA graph) and by
``ModelServer.from_predictor`` (the micro-batch race's buckets, one graph
each) to closed-loop clients, every row equal to the net's direct
forward, through ``serving.ServeFrontend`` over HTTP on 127.0.0.1, and
in a ``serving.ModelHost`` beside the wide generative decoder (its
prefills through the flash kernel) under a device-memory budget, with a
swap under load, a refused swap and a rolled-back one; then quantizes
it: calibrated (``quantization.calibrate``), rewritten (``quantize_net``:
every Conv2D and the Dense int8 wrappers with an fp8 and an fp32 arm),
its int8 products at their real shapes equal to the host's exact ones
and its fp8 products within a stated bound of the plain product, the
arms raced by ``tune_quantized``, exported as int8, fp8 and (through
``contrib.amp.convert_hybrid_block``) bf16 artifacts and served each by
``ModelServer.from_artifact`` to the same clients, every row equal to
its arm's direct forward, the three beside the fp32 one in a
``ModelHost`` whose residency reports them, the reference's small
quantization drill served at 0.99 agreement or better, and the Gluon
ResNet-50 step under ``contrib.amp`` with the Trainer's loss scaler
skipping a planted overflow; then runs the symbolic half: the
builder's ResNet-50 v1 symbol (``resnet50_v1_symbol``) trained by
``mx.mod.Module`` (batch 128, fp32), one Module step of it on the card
against the host, ``Module.fit`` of an MLP on an ``NDArrayIter`` with a
checkpoint read back on the host and a ``BucketingModule`` step, and
``sym._contrib_BNReluConv`` bound on the card (the fused backward
through the graph executor); then the classification zoo and the random
foundation: ``get_model("vgg16")`` trained through
``parallel.make_train_step`` (224², batch 128, bf16, SGD with the VGG
paper's settings, the bucket kernel forced, Dropout with a fresh key
each step), the bucket SGD kernel at VGG-16's largest bucket (fc6's
weight), three fused steps of one net of each other family at its full
width, one fp32 step of three families on the card against the host
(the Dropout masks fed), the samplers of ``mx.nd.random`` on the card
(moments, KS tests, seeding, ``capture_rng``/``restore_rng``) and
indices out of range on the card; then the recurrent path: the word
language model (``example/word_lm.py``: Embedding, Dropout, a 2 x 650
LSTM through the RNN op's cuDNN arm, a Dense decoder over WikiText-2's
33,278 words, bptt 35, batch 32, SGD with ``clip_gradient``) trained by
the Gluon loop, the RNN op's cuDNN arm and its loop on the card against
the loop on the host (every mode, bidirectional, LSTMP, the state clip;
fp32 and float64) with three word-LM steps card against host, and the
``lstm_bucketing`` example through ``BucketingModule``; then the
detection path: SSD-300 on VGG16-reduced (``example/train_ssd.py``: the
multibox targets, softmax cross-entropy and an L1 location loss, VOC's
20 classes, 300², batch 32, fp32) trained by the Gluon loop with no
host sync inside the targets, its detections (``MultiBoxDetection``,
``nms_topk`` 400) at batch 32, the detection ops at SSD-300's shapes
under torch's sync debug mode, and each detection and sort op, the RoI
ops' gradients and three SSD-300 steps on the card against the host;
and the telemetry: the kernel-arm ResNet-50 step with nothing armed,
with the run log, with a watchdog and the numerics knob, and with the
profiler's device capture (its run logs held to the schema, its program
report's FLOPs to the analytic count, the device trace's top operations
and idle gaps named by the host work open), a watchdog fire drill and
the replicated step's ``tensor_stats`` (``telemetry_resnet50``, after
the training phases), and the served ``resnet50_v1()`` traced request
by request through the HTTP front and through ``submit``
(``serve_traced``, after ``serve_http``); and the data plane: a probe
of what the card's host has for decoding JPEGs (after the device line),
a corpus of 1,536 JPEGs of 500x375 written by nvJPEG, the augment kernel
(``csrc/image_augment.cu``) against its plain version bit for bit,
nvJPEG's pixels against libjpeg's on a committed fixture, a damaged
copy's quarantine manifest and ``mx.kv``'s stores on the card
(``data_plane``), then ``example/train_imagenet.py`` at its defaults fed
by ``ImageRecordIter`` decoding on the card, beside the same step on a
resident batch and the iterator alone (``train_imagenet``).
Each phase
prints one JSON line on stdout
(progress goes to stderr); ``--out`` also appends them to FILE.  Any
failed check exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.  Exits 2 and prints no result
when torch sees no CUDA card or the port's package is not beside this
script.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

#: the H100 SXM's published peaks (NVIDIA data sheet, dense): fp32 on
#: the CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
#: dense TF32 on the tensor cores: fp32-accurate attention takes three
#: TF32 products per product (split TF32), so its bound is 3 x FLOPs
#: over this rate
PEAK_TF32 = 494.7e12
#: bytes a timing loop cycles through so that no call finds its inputs
#: in the H100's 50 MB L2 cache: four times its size
COLD_BYTES = 4 * 50 * 2 ** 20
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: bf16 attention is also held row by row: a row's largest error over
#: its largest |value| of the plain version.  The kernel rounds P to
#: bf16 before P V (the plain version keeps it in fp32) and each rounds
#: its output to bf16 once, so a sound row is off by about one bf16 ulp
#: of its largest value (2^-8 to 2^-7 of it); 2^-6 is two such ulps.  A
#: fault in a long row (a key tile dropped, a missed rescale) moves the
#: row by much more, yet can stay under the absolute limit when the
#: row's values are small
BF16_ROW_TOL = 2.0 ** -6

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


def device_ms(fn, calls=50, attempts=3, by_kernel=False):
    """Device time per call of ``fn``: the summed self device time of
    every kernel it launches over ``calls`` calls under torch.profiler,
    over ``calls`` (``by_kernel``: a dict of it by kernel name).  Unlike
    CUDA events around back-to-back calls it leaves out the host's
    launch cost, which dominates kernels of a few tens of microseconds.
    A profiler session that records no device activity at all (seen
    once in a run of many sessions) is run again, up to ``attempts``
    sessions."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(evt, "self_cuda_time_total", 0.0)
            if t_us > 0:
                per[evt.key] = per.get(evt.key, 0.0) + t_us / 1e3 / calls
        if per:
            return per if by_kernel else sum(per.values())
        log("[device_ms] the profiler recorded no device time; again")
    raise CheckFailed(f"the profiler recorded no device time in "
                      f"{attempts} sessions")


def rotating(tensors, max_sets=256):
    """``next_set()`` over copies of ``tensors`` that together span
    ``COLD_BYTES``, so that each timed call reads its inputs from HBM,
    as in a train step, and not from the 50 MB L2.  At most
    ``max_sets`` copies: a call on so few bytes is timed by its
    launch, cold or not."""
    nbytes = max(1, sum(t.nbytes for t in tensors))
    n_sets = min(max_sets, max(2, math.ceil(COLD_BYTES / nbytes)))
    sets = [tuple(t.clone() for t in tensors) for _ in range(n_sets)]
    turn = [0]

    def next_set():
        turn[0] += 1
        return sets[turn[0] % n_sets]

    next_set.n_sets = n_sets
    next_set.sets = sets
    return next_set


# ------------------------------------------------------------ kernels
def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by): the larger of operations over the peak for
    ``dtype`` and bytes over the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_bound(flops, nbytes, dtype):
    """(bound_ms, bound_by) of attention: bytes over the HBM rate
    against, for fp32, 3 x FLOPs over dense TF32 (the split-TF32
    products that keep fp32 accuracy; the fp32 CUDA-core rate is no
    least time), for bf16 FLOPs over the bf16 tensor-core rate."""
    if dtype == "float32":
        t_ops, label = 3.0 * flops / PEAK_TF32 * 1e3, "operations_3xtf32"
    else:
        t_ops, label = flops / PEAK_FLOPS[dtype] * 1e3, "operations"
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), (label if t_ops >= t_bytes else "bytes")


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


def row_rel_err(out, ref):
    """The largest over rows (the last axis) of a row's max |out - ref|
    over its max |ref|; a row whose reference is all 0 divides by 1."""
    import torch

    o, r = out.float(), ref.float()
    scale = r.abs().amax(-1)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return float(((o - r).abs().amax(-1) / scale).max())


def kernel_case(b, h, sq, sk, d, dtype, causal, path, seed, names=False):
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
    row_err = row_rel_err(out, ref)
    check(dtype != "bfloat16" or row_err <= BF16_ROW_TOL,
          f"flash kernel vs plain {b, h, sq, sk, d} bf16 causal={causal}: "
          f"row-relative err {row_err} > {BF16_ROW_TOL}")
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
    bound_ms, bound_by = attention_bound(flops, nbytes, dtype)
    # what the kernel computes: at a depth above 128 each 128-wide slab
    # of the output sums Q K^T over the whole (padded) depth again
    depth = -(-d // 128) * 128 if d > 128 else d
    slabs = max(1, depth // 128)
    kernel_flops = flops / d * depth * (slabs + 1) / 2
    res = {"path": path, "shape": [b, h, sq, sk, d], "dtype": dtype,
           "causal": causal, "max_abs_err": err, "tol": TOL[dtype],
           "row_rel_err": row_err,
           "row_tol": BF16_ROW_TOL if dtype == "bfloat16" else None,
           "masked_rows_exact_zero": masked_rows, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "flops": flops, "bytes": nbytes, "kernel_flops": kernel_flops,
           "kernel_flops_over_flops": kernel_flops / flops}
    if names:  # which kernels the port's launch and SDPA's call run
        res["kernel_device_ms"] = device_ms(kernel, calls=10,
                                            by_kernel=True)
        res["library_kernels"] = device_ms(lib, calls=10, by_kernel=True)
    return res


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
    for sq in (1, 7, 16):  # bottom-right alignment against a long cache:
        # the key-split arm
        cases.append((2, 16, sq, 2048, 128, "float32", True, "check"))
    cases.append((2, 16, 1, 2048, 128, "bfloat16", True, "check"))
    cases.append((2, 16, 300, 100, 128, "float32", True, "check"))
    cases.append((1, 2, 20, 5, 8, "float32", True, "check"))
    for causal in (True, False):  # bf16 D = 8: the depth padded to 16
        cases.append((1, 2, 70, 70, 8, "bfloat16", causal, "check"))
    # head dims above 128: the slab kernel (160 and 192 padded to 256)
    for d in (160, 192, 256):
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append((2, 8, 1000, 1000, d, dtype, causal, "check"))
    for dtype in ("float32", "bfloat16"):
        # the main shape at head_dim 256, and its key-split arm
        cases.append((1, 16, 2048, 2048, 256, dtype, True, "head_dim_256"))
        cases.append((2, 16, 16, 2048, 256, dtype, True, "check"))
    return cases


#: the shapes whose kernel names are recorded (the port's and SDPA's)
NAMED_CASES = {(1, 16, 2048, 2048, 128, "float32", True),
               (2, 16, 2048, 2048, 128, "bfloat16", True),
               (1, 16, 2048, 2048, 256, "float32", True),
               (1, 16, 2048, 2048, 256, "bfloat16", True)}


def sass_hmma(name):
    """{kernel function: {"hmma": n, "tf32": n, "bf16": n}}: the
    tensor-core MMA instructions (``HMMA`` of mma.sync, ``HGMMA`` of
    wgmma) in each function's SASS in the built library ``name``, all
    and those of TF32 and of bf16 operands, by ``cuobjdump -sass`` from
    the CUDA toolkit."""
    from mxnet_tpu_torch import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", _kernels._lib_path(name)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {name} failed: "
                               f"{out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, {"hmma": 0, "tf32": 0, "bf16": 0})
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            c = counts[fn]
            c["hmma"] += 1
            c["tf32"] += "TF32" in line
            c["bf16"] += "BF16" in line
    return counts


def ptxas_spills(log, fragment):
    """{entry: [spill store bytes, spill load bytes, registers]} from
    nvcc's ``-Xptxas=-v`` log, for the entries whose name holds
    ``fragment``."""
    spills, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif not entry or fragment not in entry:
            continue
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            # "N bytes stack frame, N bytes spill stores, N bytes spill
            # loads"
            spills[entry] = [nums[1], nums[2], None]
        elif "Used" in line and "registers" in line and entry in spills:
            spills[entry][2] = int(line.split("Used")[1].split()[0])
    return spills


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


def device_busy_us(prof):
    """(union, streams): the microseconds in which at least one device
    activity (kernel, copy, set) of a torch.profiler run was running,
    the union of their intervals over every stream, and the number of
    streams they ran on.  None when the run holds no timed device
    event."""
    from torch.autograd import DeviceType

    spans, streams = [], set()
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t0, t1 = evt.time_range.start, evt.time_range.end
        if t1 > t0:
            spans.append((t0, t1))
            streams.add(getattr(evt, "device_resource_id", None))
    if not spans:
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for t0, t1 in spans[1:]:
        if t0 > hi:
            busy += hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    return busy + hi - lo, len(streams)


def device_profile(prof, wall_s, top=12, shares=None):
    """Kernel time by name from a torch.profiler run over ``wall_s``
    seconds.  The busy time is the union of the device activities'
    intervals across streams (``device_busy_us``), and the idle share
    is 1 less it over the wall time, unclipped; the kernels' summed
    self device time is kept beside it (above the union where two
    streams overlap).  ``shares`` ({label: name fragments}) adds each
    label's share of the summed device time."""
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
    shares = shares or {"flash_attention": ("flash_fwd_kernel",
                                            "flash_combine_kernel")}
    union = device_busy_us(prof)
    if union is None:
        return {"device_time": "not measured",
                "device_kernel_sum_ms": busy_us / 1e3}
    union_us, streams = union
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": union_us / 1e3,
        "device_kernel_sum_ms": busy_us / 1e3, "device_streams": streams,
        "device_idle_share": 1.0 - union_us / 1e6 / wall_s,
        "shares_of_device": {
            label: sum(r[0] for r in rows
                       if any(f in r[2] for f in frags)) / busy_us
            for label, frags in shares.items()},
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


def deep_head_phase():
    """The bench-width decoder at head_dim 256 (Gemma's head width),
    fp32 KV: the fixed prompts' greedy tokens on the card, through the
    flash slab kernel, equal the host's.  The flash launch count is set
    to 0 just before the card's server and read after it."""
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.serving import toy_decoder_params

    params = toy_decoder_params(seed=0, vocab=DEEP_CFG["vocab"],
                                layers=DEEP_CFG["layers"],
                                heads=DEEP_CFG["heads"],
                                head_dim=DEEP_CFG["head_dim"], device="cpu")
    flash_attention.launches = 0
    on_card = fixed_prompt_tokens(DEEP_CFG, params, "cuda", FIXED_PROMPTS,
                                  12)
    launches = flash_attention.launches
    on_host = fixed_prompt_tokens(DEEP_CFG, params, "cpu", FIXED_PROMPTS,
                                  12)
    res = {"phase": "serve_head_dim_256",
           "config": {k: v for k, v in DEEP_CFG.items()},
           "flash_launches": launches, "tokens_cuda": on_card,
           "tokens_cuda_eq_cpu": on_card == on_host}
    check(on_card == on_host, f"head_dim 256: fp32-KV tokens differ, cuda "
                              f"{on_card} vs cpu {on_host}")
    # each prompt's prefill runs the kernel once per layer, at least
    check(launches >= len(FIXED_PROMPTS) * DEEP_CFG["layers"],
          f"head_dim 256: {launches} flash launches")
    return res


BENCH_CFG = dict(  # bench.py:_measure_generate, full (not smoke)
    vocab=32, layers=2, heads=2, head_dim=8, prompt_buckets=(4, 8, 16),
    max_new=12, slots=8, page_tokens=4, pool_budget=64 * 1024,
    kv_dtype="int8", evict_after_ms=25.0, name="bench-generate")

WIDE_CFG = dict(
    vocab=32000, layers=4, heads=16, head_dim=128,
    prompt_buckets=(128, 512, 2048), max_new=32, slots=8,
    page_tokens=16, pool_budget=512 * 2 ** 20, kv_dtype="int8",
    evict_after_ms=25.0, slo_ms=60000.0, name="wide-generate")

#: the bench-width decoder at a head width of 256 (Gemma's), fp32 KV;
#: the pool's byte budget scaled with the head, the same pages
DEEP_CFG = dict(BENCH_CFG, head_dim=256, pool_budget=32 * 64 * 1024,
                kv_dtype="float32", name="deep-head-generate")

WIDE_PREFILL_TOL = 1e-3

FIXED_PROMPTS = ([1, 2, 3], [5], [7, 3, 9, 2, 11],
                 [4, 15, 26, 9, 30, 1, 2, 8, 19, 0, 31, 12, 6])


# ------------------------------------------------- ResNet-50 training
#: the fused tail's (M, Ci, Co) at ResNet-50 batch 128, 224x224: one
#: launch per bottleneck, 3/4/6/3 per stage
BRC_STAGES = [(128 * 56 * 56, 64, 256, 3), (128 * 28 * 28, 128, 512, 4),
              (128 * 14 * 14, 256, 1024, 6), (128 * 7 * 7, 512, 2048, 3)]
#: stated tolerances of the fused backward, kernel against plain:
#: d_bn fp32 relative to its largest value, bf16 one ulp of each value
#: plus 1e-5 of the largest (a d_act that cancels to near zero differs
#: between fp32 sums taken in other orders by more than its own bf16
#: ulp); dW/s1/s2 relative to their largest value
BRC_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 1e-3)}


def old_brc_runner(source, workdir):
    """``fn(dy, u, w2, g, b, mu, inv)`` that launches the fused backward
    built from ``source``, an earlier version of
    ``csrc/bnreluconv_bwd.cu`` with the same C interface, under that
    version's own launch plan (64-row tiles, about four CTAs an SM, dW
    splits of 256 rows or more): to time it beside the current kernel
    in one run.  Its launches are not counted."""
    import ctypes

    import torch

    from mxnet_tpu_torch import _kernels

    lib = os.path.join(workdir, "libbnreluconv_bwd_old.so")
    out = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib,
                          source], capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"building {source} failed: "
                               f"{(out.stdout + out.stderr)[-3000:]}")
    fn = ctypes.CDLL(lib).mxt_bnreluconv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]

    def run(dy, u, w2, g, b, mu, inv):
        m, co = dy.shape
        ci = u.shape[1]
        ci_tiles, co_tiles = -(-ci // 64), -(-co // 64)
        groups = max(1, min(-(-m // 64), -(-528 // ci_tiles)))
        splits = max(1, min(-(-m // 256), -(-528 // (ci_tiles * co_tiles))))
        f32 = dict(dtype=torch.float32, device=dy.device)
        d_bn = torch.empty_like(u)
        dw = torch.empty((ci, co), **f32)
        s = torch.empty((2, ci), **f32)
        s_part = torch.empty((2, groups, ci), **f32)
        dw_part = torch.empty((splits, ci, co), **f32)
        rc = fn(dy.data_ptr(), u.data_ptr(), w2.t().data_ptr(),
                g.data_ptr(), b.data_ptr(), mu.data_ptr(), inv.data_ptr(),
                d_bn.data_ptr(), dw.data_ptr(), s.data_ptr(),
                s_part.data_ptr(), dw_part.data_ptr(), m, ci, co, groups,
                splits, 0 if dy.dtype == torch.float32 else 1,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the earlier fused backward did not launch "
                       f"(cudaError_t {rc})")
        return d_bn, dw, s[0:1], s[1:2]

    return run


def brc_case(m, ci, co, dtype, path, seed, old=None):
    """The fused BN-ReLU-1x1-conv backward (pass 1) at one shape: kernel
    against plain on the same inputs, times, and the bound; with
    ``old`` (an :func:`old_brc_runner`), that kernel's time and error
    too."""
    import torch

    from mxnet_tpu_torch.ops import pallas_conv as pc

    dev = torch.device("cuda", 0)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    dy, u = rnd(m, co).to(tdt), rnd(m, ci).to(tdt)
    w2 = rnd(co, ci, scale=0.05).to(tdt).t()
    g, b = rnd(1, ci).abs() + 0.5, rnd(1, ci, scale=0.3)
    mu, inv = rnd(1, ci, scale=0.1), rnd(1, ci).abs() + 0.5
    args = (dy, u, w2, g, b, mu, inv)
    n0 = pc.bnreluconv_bwd.launches
    got = pc.bnreluconv_bwd(*args)
    want = pc._bwd_pass1_reference(*args)
    torch.cuda.synchronize()
    check(pc.bnreluconv_bwd.launches == n0 + 1, "bnreluconv not launched")
    d_tol, s_tol = BRC_TOL[dtype]
    d_bn, d_ref = got[0].float(), want[0].float()
    if dtype == "float32":
        d_ok = float((d_bn - d_ref).abs().max()) <= d_tol * float(
            d_ref.abs().max())
    else:
        d_ok = bool(((d_bn - d_ref).abs() <= d_ref.abs() * d_tol
                     + 1e-5 * d_ref.abs().max()).all())
    rel = [float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
           for a, r in zip(got[1:], want[1:])]
    abs_err = max(float((a.float() - r.float()).abs().max())
                  for a, r in zip(got, want))
    check(d_ok and max(rel) <= s_tol,
          f"bnreluconv {m, ci, co} {dtype}: d_bn ok={d_ok}, dW/s1/s2 rel "
          f"{rel} > {s_tol}")
    again = pc.bnreluconv_bwd(*args)
    check(all(torch.equal(a, r) for a, r in zip(got, again)),
          "bnreluconv kernel is not deterministic")
    relu_act = torch.where(
        (u.float() * g + b).to(tdt).float() > 0, (u.float() * g + b).to(tdt),
        torch.zeros((), dtype=tdt, device=dev))
    ms = time_ms(lambda: pc.bnreluconv_bwd(*args))
    plain_ms = time_ms(lambda: pc._bwd_pass1_reference(*args))
    matmul_ms = time_ms(lambda: (dy @ w2.t(), relu_act.t() @ dy))
    if path == "resnet50_stage":  # device time of each of its kernels
        earlier = {"kernel_device_ms": device_ms(
            lambda: pc.bnreluconv_bwd(*args), calls=10, by_kernel=True)}
    else:
        earlier = {}
    if old is not None:
        prev = old(*args)
        torch.cuda.synchronize()
        earlier.update({
            "earlier_kernel_ms": time_ms(lambda: old(*args)),
            "earlier_kernel_max_abs_err": max(
                float((a.float() - r.float()).abs().max())
                for a, r in zip(prev, want)),
            "ms_again": time_ms(lambda: pc.bnreluconv_bwd(*args))})
    size = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * m * ci * co
    nbytes = float(size * (m * co + 2 * m * ci + ci * co) + 4 * ci * co)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    return {"path": path, "shape": [m, ci, co], "dtype": dtype,
            "rel_err_dw_s1_s2": rel, "max_abs_err": abs_err,
            "tol": BRC_TOL[dtype], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "none: no single PyTorch call computes this "
                       "function",
            "yardstick_two_matmuls_ms": matmul_ms, "flops": flops,
            "bytes": nbytes, **earlier}


def bucket_case(n, dtype, momentum, path, seed):
    """The bucket SGD kernel at one size: bit-identical to the plain
    version on the same inputs, with infs and NaNs planted at known
    positions and their count exact; times and the bound."""
    import torch

    from mxnet_tpu_torch.ops import pallas_opt as po

    dev = torch.device("cuda", 0)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n, generator=gen, device=dev).to(tdt)
    m = torch.randn(n, generator=gen, device=dev).to(tdt)
    g = torch.randn(n, generator=gen, device=dev)
    n_bad = planted_nonfinite(g)
    hyper = dict(lr=0.1, wd=1e-4, rescale=1.0, clip=None)
    wrapper = po.bucket_sgd_mom if momentum else po.bucket_sgd

    def kernel():
        if momentum:
            return po.bucket_sgd_mom(w, g, m, momentum=momentum,
                                     with_finite=True, **hyper)
        return po.bucket_sgd(w, g, with_finite=True, **hyper)

    n0 = wrapper.launches
    got = kernel()
    want = po._sgd_reference(w, g, m if momentum else None, hyper["lr"],
                             hyper["wd"], momentum, 1.0, None, True)
    torch.cuda.synchronize()
    check(wrapper.launches == n0 + 1, "bucket kernel not launched")
    check(all(same_bits(a, r) for a, r in zip(got[:-1], want[:2])),
          f"bucket kernel {n} {dtype} momentum={momentum} is not "
          "bit-identical to the plain version")
    check(int(got[-1]) == int(want[2]) == n_bad,
          f"non-finite count {int(got[-1])}, plain {int(want[2])}, "
          f"planted {n_bad}")
    g.nan_to_num_(0.0, 0.0, 0.0)  # timing on finite data
    next_set = rotating((w, g, m))
    n_sets = next_set.n_sets

    def kernel_cold():
        ws, gs, ms_ = next_set()
        if momentum:
            return po.bucket_sgd_mom(ws, gs, ms_, momentum=momentum,
                                     with_finite=True, **hyper)
        return po.bucket_sgd(ws, gs, with_finite=True, **hyper)

    def plain():
        ws, gs, ms_ = next_set()
        return po._sgd_reference(ws, gs, ms_ if momentum else None,
                                 hyper["lr"], hyper["wd"], momentum, 1.0,
                                 None, True)

    opts = []
    for ws, gs, _ in next_set.sets:
        wl = ws.float().requires_grad_(True)
        wl.grad = gs
        opts.append(torch.optim.SGD([wl], lr=0.1, momentum=momentum,
                                    weight_decay=1e-4, fused=True))
    library = rotating_steps(opts)

    # device time per call: at these sizes the kernel takes tens of
    # microseconds and CUDA events around back-to-back calls would time
    # the host's launch cost (kept below as *_event_ms)
    ms, plain_ms, library_ms = (device_ms(f) for f in (kernel_cold, plain,
                                                       library))
    event_ms = [time_ms(f) for f in (kernel_cold, plain, library)]
    size = 2 if dtype == "bfloat16" else 4
    nbytes = float(n * (size * (4 if momentum else 2) + 4))
    # elementwise fp32 arithmetic on the CUDA cores, whatever the dtype
    bound_ms, bound_by = bound((6.0 if momentum else 4.0) * n, nbytes,
                               "float32")
    return {"path": path, "n": n, "dtype": dtype, "momentum": momentum,
            "bit_identical": True, "nonfinite_planted": n_bad,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "timing": f"device time per call, inputs cold in L2 "
                      f"({n_sets} rotating copies)",
            "event_ms": event_ms[0], "plain_event_ms": event_ms[1],
            "library_event_ms": event_ms[2],
            "library": "yardstick: torch.optim.SGD(fused=True).step() on "
                       "an fp32 tensor of the same size (same update up "
                       "to rounding, no non-finite count; the port never "
                       "calls it)",
            "bytes": nbytes}


def rotating_steps(opts):
    """``step()`` of the next of ``opts`` (one per rotating set)."""
    turn = [0]

    def step():
        turn[0] += 1
        opts[turn[0] % len(opts)].step()

    return step


def planted_nonfinite(g):
    """Plants NaN and ±inf at five known positions of ``g`` (in place);
    returns their count."""
    import torch

    n = g.numel()
    bad = sorted({0, 7, n // 3, n // 2, n - 1})
    g[bad] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                           float("nan"), float("inf")][:len(bad)],
                          device=g.device)
    return len(bad)


def same_bits(a, r):
    """Equal element for element, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(r)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], r[~nan])


#: Adam's hyper-parameters in the kernel checks (bench.py:1840's lr/wd)
ADAM_HYPER = dict(lr=1e-3, wd=1e-4, beta1=0.9, beta2=0.999, eps=1e-8)


def adam_case(n, t, path, seed, planted=False):
    """The bucket Adam kernel at one size and step count: bit-identical
    to the plain version on the same inputs, the non-finite count exact
    (NaN and ±inf planted when ``planted``); device times with inputs
    cold in L2, and the bound."""
    import torch

    from mxnet_tpu_torch.ops import pallas_opt as po
    from mxnet_tpu_torch.optimizer.optimizer import adam_lr_t

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.randn(n, generator=gen, device=dev).abs()
    n_bad = planted_nonfinite(g) if planted else 0
    hp = dict(ADAM_HYPER)
    lr_t = adam_lr_t(hp.pop("lr"), hp["beta1"], hp["beta2"], t)
    kw = dict(hp, lr_t=lr_t, rescale=1.0, clip=None, with_finite=True)

    def plain(ws, gs, ms_, vs):
        return po._adam_reference(ws, gs, ms_, vs, lr_t, hp["wd"],
                                  hp["beta1"], hp["beta2"], hp["eps"], 1.0,
                                  None, True)

    n0 = po.bucket_adam.launches
    got = po.bucket_adam(w, g, m, v, **kw)
    want = plain(w, g, m, v)
    torch.cuda.synchronize()
    check(po.bucket_adam.launches == n0 + 1, "bucket_adam not launched")
    check(all(same_bits(a, r) for a, r in zip(got[:3], want[:3])),
          f"bucket_adam {n} t={t} is not bit-identical to the plain version")
    check(int(got[3]) == int(want[3]) == n_bad,
          f"adam non-finite count {int(got[3])}, plain {int(want[3])}, "
          f"planted {n_bad}")
    g.nan_to_num_(0.0, 0.0, 0.0)  # timing on finite data
    next_set = rotating((w, g, m, v))
    opts = []
    for ws, gs, _, _ in next_set.sets:
        wl = ws.requires_grad_(True)
        wl.grad = gs
        opts.append(torch.optim.Adam([wl], lr=1e-3, weight_decay=1e-4,
                                     fused=True))
    library = rotating_steps(opts)
    with torch.no_grad():
        ms, plain_ms, library_ms = (device_ms(f) for f in (
            lambda: po.bucket_adam(*next_set(), **kw),
            lambda: plain(*next_set()), library))
    nbytes = 28.0 * n  # read w, g, m, v; write w, m, v (fp32)
    bound_ms, bound_by = bound(16.0 * n, nbytes, "float32")
    return {"path": path, "n": n, "t": t, "lr_t": lr_t,
            "bit_identical": True, "nonfinite_planted": n_bad,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "timing": f"device time per call, inputs cold in L2 "
                      f"({next_set.n_sets} rotating copies)",
            "library": "yardstick: torch.optim.Adam(fused=True).step() on "
                       "one fp32 tensor of the same size (same update up "
                       "to rounding and bias correction on the card, no "
                       "non-finite count; the port never calls it)",
            "bytes": nbytes}


#: LARS's hyper-parameters in the kernel checks and the LARS training
#: phase: the MLPerf ResNet-50 recipe's momentum, eta and weight decay;
#: no lr schedule (the fused step evaluates lr once), and an lr at which
#: the loss on the fixed batch falls
LARS_HYPER = dict(lr=5.0, wd=5e-5, eta=0.001, eps=0.0, momentum=0.9)
#: whole LARS update, kernels against plain (the reference's tolerance
#: between its kernel and its jnp rule: the norms are sums in other
#: orders)
LARS_TOL = dict(rtol=1e-6, atol=1e-6)


def lars_case(ids, nseg, path, seed):
    """The LARS kernels on one bucket: phase (c) bit-identical to the
    plain version given the same per-segment lr, the whole update within
    ``LARS_TOL`` of the plain version, two runs bit-identical, the
    non-finite count exact; device time of each phase, inputs cold."""
    import torch

    from mxnet_tpu_torch.ops import pallas_opt as po

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = ids.numel()
    w = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev) * 0.01
    m = torch.randn(n, generator=gen, device=dev) * 0.01
    hp = dict(LARS_HYPER)
    mom = hp.pop("momentum")
    norm_kw = dict(hp, rescale=1.0, clip=None, with_finite=True)
    up_kw = dict(wd=hp["wd"], momentum=mom, rescale=1.0, clip=None)

    def kernels(ws, gs, ms_, ids_):
        slr = po.bucket_lars_norms(ws, gs, ids_, nseg, **norm_kw)
        return slr, po.bucket_lars_update(ws, gs, ms_, ids_, slr[0],
                                          **up_kw)

    def plain(ws, gs, ms_, ids_):
        w_ss, g_ss, nf = po._lars_norms_reference(ws, gs, ids_, nseg, 1.0,
                                                  None, True)
        slr = po._lars_trust_reference(w_ss, g_ss, hp["lr"], hp["wd"],
                                       hp["eta"], hp["eps"])
        return (slr, w_ss, g_ss, nf), po._lars_update_reference(
            ws, gs, ms_, ids_, slr, hp["wd"], mom, 1.0, None)

    counts = lambda: (po.bucket_lars_norms.launches,  # noqa: E731
                      po.bucket_lars_norms.trust_launches,
                      po.bucket_lars_update.launches)
    n0 = counts()
    (slr, w_ss, g_ss, nf), (nw, nm) = kernels(w, g, m, ids)
    (slr2, w_ss2, _, nf2), (nw2, nm2) = kernels(w, g, m, ids)
    (rslr, rw_ss, rg_ss, rnf), (rw, rm) = plain(w, g, m, ids)
    cw, cm = po._lars_update_reference(w, g, m, ids, slr, hp["wd"], mom, 1.0,
                                       None)
    torch.cuda.synchronize()
    check(counts() == tuple(c + 2 for c in n0), f"lars launches {counts()} "
          f"after {n0}")
    check(torch.equal(nw, cw) and torch.equal(nm, cm),
          f"lars phase (c) {n}/{nseg} is not bit-identical to the plain "
          "version given the same slr")
    check(torch.allclose(nw, rw, **LARS_TOL) and
          torch.allclose(nm, rm, **LARS_TOL),
          f"lars update {n}/{nseg} off the plain version: w "
          f"{float((nw - rw).abs().max())}, m {float((nm - rm).abs().max())}")
    check(all(torch.equal(a, b) for a, b in ((slr, slr2), (w_ss, w_ss2),
                                            (nw, nw2), (nm, nm2), (nf, nf2))),
          f"lars kernels {n}/{nseg} differ between two runs")
    check(int(nf) == int(rnf) == 0, f"lars non-finite count {int(nf)}")
    rel = lambda a, r: float(((a - r).abs() / r.abs().clamp_min(  # noqa: E731
        1e-30)).max())
    # why the plain norms sum in float64: an fp32 index_add_ drifts
    fp32_ss = torch.zeros(nseg, device=dev).index_add_(0, ids, w * w)
    next_set = rotating((w, g, m, ids))
    per = device_ms(lambda: kernels(*next_set()), by_kernel=True)
    phase = {k: sum(t for name, t in per.items() if k in name)
             for k in ("lars_norms_kernel", "lars_trust_kernel",
                       "lars_update_kernel")}
    # phase (c) alone, cold: after phase (a) in the same call it finds
    # w, g and the ids of a bucket of up to 50 MB still in L2, as in the
    # step
    update_cold_ms = device_ms(lambda: po.bucket_lars_update(
        *next_set(), slr, **up_kw))
    plain_per = device_ms(lambda: plain(*next_set()), by_kernel=True)
    plain_ms = sum(plain_per.values())
    # the plain update alone: the last six elementwise ops and the gather
    # are not separable by name, so time it on its own
    plain_update_ms = device_ms(lambda: po._lars_update_reference(
        *next_set(), slr, hp["wd"], mom, 1.0, None))
    # phase (a) reads w, g, seg; phase (c) w, g, m, seg and writes w, m:
    # 36 bytes an element over the two passes, 24 if each input were
    # read once
    b_norms = bound(4.0 * n, 12.0 * n, "float32")
    b_update = bound(7.0 * n, 24.0 * n, "float32")
    return {"path": path, "n": n, "nseg": nseg,
            "phase_c_bit_identical": True, "deterministic": True,
            "tol_whole_update": LARS_TOL,
            "max_abs_err": max(float((nw - rw).abs().max()),
                               float((nm - rm).abs().max())),
            "norms_max_rel_err": max(rel(w_ss, rw_ss), rel(g_ss, rg_ss)),
            "fp32_index_add_norms_rel_err": rel(fp32_ss, rw_ss),
            "slr_max_rel_err": rel(slr, rslr),
            "slr_max_abs_err": float((slr - rslr).abs().max()),
            "ms_norms": phase["lars_norms_kernel"],
            "ms_trust": phase["lars_trust_kernel"],
            "ms_update": phase["lars_update_kernel"],
            "ms_update_cold": update_cold_ms,
            "ms": sum(per.values()), "plain_ms": plain_ms,
            "plain_update_ms": plain_update_ms,
            "plain_norms_trust_ms": plain_ms - plain_update_ms,
            "bound_ms": b_norms[0] + b_update[0], "bound_by": "bytes",
            "bound_norms_ms": b_norms[0], "bound_update_ms": b_update[0],
            "library_ms": None,
            "library": "none: no single PyTorch call computes LARS",
            "timing": f"device time per call by kernel name, inputs cold "
                      f"in L2 ({next_set.n_sets} rotating copies)",
            "bytes": 36.0 * n}


# ------------------------------------------- the imperative front end
#: ResNet-50 v1's residual adds at batch 128, channel-last: one shape
#: per stage (the bottleneck's output and its shortcut)
RESIDUAL_SHAPES = [(128, 56, 56, 256), (128, 28, 28, 512),
                   (128, 14, 14, 1024), (128, 7, 7, 2048)]
PLUGIN = os.path.join("mxnet_tpu_torch", "example", "plugin", "cuda_ops.py")


def load_plugin():
    """``(mx, plugin module)``: the port's operator plugin through
    ``mx.library.load``, as a user loads it."""
    import mxnet_tpu_torch as mx

    here = os.path.dirname(os.path.abspath(__file__))
    return mx, mx.library.load(os.path.join(here, PLUGIN), verbose=False)


def scaled_add_case(mod, shape, dtype, path, seed, y_shape=None,
                    transposed=False):
    """The scaled-add kernel at one shape: bit-identical to its plain
    version ``x + y * s`` on the same inputs (y broadcast to x's shape
    first, as the op does; a 2-D shape given ``transposed`` is a
    transposed view); device times with inputs cold in L2 and the
    bound."""
    import torch

    dev = torch.device("cuda", 0)
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shp):
        t = torch.randn(shp, generator=gen, device=dev)
        return t.to(tdt) if tdt.is_floating_point else (t * 1000).to(tdt)

    x, y = rnd(shape), rnd(y_shape or shape)
    if transposed:
        x, y = x.t(), y.t()
    n = x.numel()
    scale = 0.5 if tdt.is_floating_point else 3
    s = mod._scale_tensor(scale, tdt)
    n0 = mod.scaled_add.launches
    got = mod.scaled_add(x, y.broadcast_to(x.shape), scale)
    want = mod._scaled_add_plain(x, y.broadcast_to(x.shape), s)
    torch.cuda.synchronize()
    check(mod.scaled_add.launches == n0 + (1 if n else 0),
          f"scaled_add {shape} {dtype}: launches {mod.scaled_add.launches}"
          f" after {n0}")
    check(got.shape == x.shape and got.dtype == tdt
          and torch.equal(got, want),
          f"scaled_add {shape} {dtype} is not bit-identical to the plain "
          "version")
    size = x.element_size()
    nbytes = float(size * (2 * n + y.numel()))
    bound_ms, bound_by = bound(2.0 * n, nbytes, "float32")
    res = {"path": path, "shape": list(x.shape), "dtype": dtype,
           "y_shape": list(y.shape), "transposed": transposed,
           "bit_identical": True, "max_abs_err": 0.0,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "library": "yardstick: torch.add(x, y, alpha=s), one PyTorch "
                      "call, its rounding not pinned (the port never "
                      "calls it)"}
    if n == 0:
        return dict(res, ms=None, plain_ms=None, library_ms=None,
                    timing="nothing to time: no launch for 0 elements")
    next_set = rotating((x, y))

    def kernel():
        xs, ys = next_set()
        return mod.scaled_add(xs, ys.broadcast_to(xs.shape), scale)

    def plain():
        xs, ys = next_set()
        return mod._scaled_add_plain(xs, ys.broadcast_to(xs.shape), s)

    def library():
        return torch.add(*next_set(), alpha=scale)

    ms, plain_ms, library_ms = (time_ms(f, budget_ms=100.0)
                                for f in (kernel, plain, library))
    dev = [device_ms(f, calls=20) for f in (kernel, plain, library)]
    return dict(res, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=dev[0], plain_device_ms=dev[1],
                library_device_ms=dev[2],
                timing=f"CUDA events around back-to-back calls (a copy "
                       f"of a strided view included), inputs cold in L2 "
                       f"({next_set.n_sets} rotating copies); *device_ms: "
                       f"the profiler's kernel time per call")


def scaled_add_cases(mod):
    """The residual shapes in bf16 and fp32, then the edge cases."""
    big, mid = RESIDUAL_SHAPES[0], RESIDUAL_SHAPES[1]
    todo = [(shape, dtype, "resnet50_residual", 500 + i, {})
            for i, shape in enumerate(RESIDUAL_SHAPES)
            for dtype in ("bfloat16", "float32")]
    todo += [(big, "float16", "check", 510, {}),
             (big, "int32", "check", 511, {}),
             ((1000003,), "bfloat16", "check", 512, {}),
             ((1,), "bfloat16", "check", 513, {}),
             ((0,), "bfloat16", "check", 514, {}),
             ((4096, 3136), "bfloat16", "check", 515,
              {"transposed": True}),
             (mid, "bfloat16", "check", 516, {"y_shape": (mid[-1],)})]
    cases = []
    for shape, dtype, path, seed, kw in todo:
        c = scaled_add_case(mod, shape, dtype, path, seed, **kw)
        log(f"[scaled_add] {c['shape']} {c['dtype']} y={c['y_shape']} "
            f"ms={c['ms']} plain={c['plain_ms']} add={c['library_ms']} "
            f"device={c.get('device_ms')} bound={c['bound_ms']:.4f}")
        cases.append(c)
    return cases


def host_ms(fn, iters):
    """Wall milliseconds per call of ``fn``, the card drained at the
    end: what a caller waits for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def dispatch_us(fn, iters=2000):
    """Host microseconds per call to dispatch ``fn`` (the card drains
    after the clock stops): the dispatch cost of a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


#: the manual loop's settings: 20 steps of plain gradient descent on a
#: 64x64 residual layer fitted to 256 samples, fp32
RESIDUAL_LOOP = dict(n=256, d=64, steps=20, lr=20.0, seed=0)
LOOP_RTOL = 1e-5


def residual_loop(mx, ctx):
    """The verify skill's eager flow on ``ctx``: ``pred = x + 0.5 *
    dot(x, w)`` through ``plugin_scaled_add``, a mean squared error,
    ``autograd.record()`` / ``loss.backward()`` / ``w[:] = w - lr *
    w.grad``.  Returns the losses."""
    import numpy as onp

    c = RESIDUAL_LOOP
    r = onp.random.RandomState(c["seed"])
    xs = r.randn(c["n"], c["d"]).astype("float32")
    w_true = (r.randn(c["d"], c["d"]) * 0.1).astype("float32")
    x = mx.nd.array(xs, ctx=ctx)
    y = mx.nd.array(xs + 0.5 * xs @ w_true, ctx=ctx)
    w = mx.nd.array((r.randn(c["d"], c["d"]) * 0.1).astype("float32"),
                    ctx=ctx)
    w.attach_grad()
    losses = []
    for _ in range(c["steps"]):
        with mx.autograd.record():
            pred = mx.nd.plugin_scaled_add(x, mx.nd.dot(x, w), scale=0.5)
            loss = ((pred - y) ** 2).mean()
        loss.backward()
        w[:] = w - c["lr"] * w.grad
        losses.append(float(loss.asscalar()))
    return losses


def params_roundtrip(mx):
    """``.params`` of fp32, bf16, fp16, int32, int64, uint8 and 0-d
    arrays saved from the card load on the host and re-save
    byte-identical; the host copies save the same bytes."""
    import numpy as onp

    gpu = mx.gpu(0)
    r = onp.random.RandomState(7)
    d = {"f32": mx.nd.array(r.randn(3, 4), ctx=gpu),
         "bf16": mx.nd.array(r.randn(5), ctx=gpu, dtype="bfloat16"),
         "f16": mx.nd.array(r.randn(2, 2), ctx=gpu, dtype="float16"),
         "i32": mx.nd.array(r.randint(-9, 9, (2, 3)), ctx=gpu,
                            dtype="int32"),
         "i64": mx.nd.array(onp.array([2 ** 40, -3]), ctx=gpu,
                            dtype="int64"),
         "u8": mx.nd.array(onp.arange(6), ctx=gpu, dtype="uint8"),
         "scalar": mx.nd.array(onp.float32(2.5), ctx=gpu)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
    try:
        path = os.path.join(tmp, "p.params")
        mx.nd.save(path, d)
        with open(path, "rb") as f:
            card_bytes = f.read()
        host = mx.nd.load(path, ctx=mx.cpu())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(v.context == mx.cpu() for v in host.values()),
          "loaded arrays not on the host")
    check(mx.nd.save_buffer(host) == card_bytes,
          ".params re-saved on the host differ from the card's")
    copies = {k: v.as_in_context(mx.cpu()) for k, v in d.items()}
    check(mx.nd.save_buffer(copies) == card_bytes,
          ".params of the host copies differ from the card's")
    check(str(host["bf16"].dtype) == "float32" and host["scalar"].shape
          == () and str(host["i64"].dtype) == "int64",
          f"loaded dtypes {[(k, str(v.dtype)) for k, v in host.items()]}")
    return {"arrays": {k: [str(v.dtype), list(v.shape)]
                       for k, v in d.items()},
            "bytes": len(card_bytes), "card_eq_host_bytes": True}


def nd_plugin_phase(mx, mod):
    """The front end's path on the card: ``mx.library.load`` ->
    ``mx.nd.plugin_scaled_add`` on ``mx.gpu(0)`` under
    ``autograd.record()`` at the four residual shapes in bf16 (one
    launch per call, exact gradients), the manual training loop on the
    card against the host, then per-call times through ``mx.nd`` and
    the raw wrapper, and the ``.params`` round trip."""
    import numpy as onp
    import torch

    gpu = mx.gpu(0)
    scale = 0.5
    s = mod._scale_tensor(scale, torch.bfloat16)
    n_max = max(1024, *(math.prod(sh) for sh in RESIDUAL_SHAPES))
    base = onp.random.default_rng(600).standard_normal(n_max + 1,
                                                       dtype=onp.float32)
    arrays = []
    mod.scaled_add.launches = 0  # the main path starts here
    for shape in RESIDUAL_SHAPES:
        n = math.prod(shape)
        a = mx.nd.array(base[:n].reshape(shape), ctx=gpu, dtype="bfloat16")
        b = mx.nd.array(base[1:n + 1].reshape(shape), ctx=gpu,
                        dtype="bfloat16")
        a.attach_grad()
        b.attach_grad()
        n0 = mod.scaled_add.launches
        with mx.autograd.record():
            out = mx.nd.plugin_scaled_add(a, b, scale=scale)
        out.backward()
        ad, bd = a._data.detach(), b._data.detach()
        check(torch.equal(out._data, ad + bd * s),
              f"mx.nd.plugin_scaled_add {shape} differs from x + y * s")
        check(bool((a.grad._data == 1).all())
              and bool((b.grad._data == s).all()),
              f"plugin_scaled_add {shape}: gradients not 1 and s")
        with mx.autograd.record():
            out = mx.nd.plugin_scaled_add(a, b, scale=scale)
            loss = (out * out).sum()
        loss.backward()
        two = out._data.detach() * 2  # d loss / d out, exact
        check(torch.equal(a.grad._data, two)
              and torch.equal(b.grad._data, two * s),
              f"plugin_scaled_add {shape}: loss gradients differ")
        torch.cuda.synchronize()
        check(mod.scaled_add.launches == n0 + 2,
              f"{mod.scaled_add.launches - n0} launches for 2 calls")
        arrays.append((shape, a, b))
        log(f"[nd_plugin] {shape} bf16: 2 launches, exact gradients")
    loop_card = residual_loop(mx, gpu)
    launches = mod.scaled_add.launches  # the main path ends here
    loop_host = residual_loop(mx, mx.cpu())
    rel = max(abs(c - h) / abs(h) for c, h in zip(loop_card, loop_host))
    check(launches == 2 * len(RESIDUAL_SHAPES) + RESIDUAL_LOOP["steps"],
          f"main path launched the kernel {launches} times")
    check(all(math.isfinite(v) for v in loop_card)
          and sum(loop_card[-3:]) / 3 < loop_card[0],
          f"the loop's loss does not fall: {loop_card}")
    check(rel <= LOOP_RTOL, f"card vs host loop losses differ by {rel}")
    per_call = []
    for shape, a, b in arrays:
        ad, bd = a._data.detach(), b._data.detach()

        def nd_call():
            return mx.nd.plugin_scaled_add(a, b, scale=scale)

        def raw_call():
            return mod.scaled_add(ad, bd, scale)

        per_call.append({
            "shape": list(shape),
            "nd_host_ms": host_ms(nd_call, 20),
            "wrapper_host_ms": host_ms(raw_call, 20),
            "nd_device_ms": device_ms(nd_call, calls=20),
            "wrapper_device_ms": device_ms(raw_call, calls=20)})
    del arrays
    small = [mx.nd.array(base[i:i + 1024], ctx=gpu, dtype="bfloat16")
             for i in (0, 1)]
    sd = [t._data for t in small]
    dispatch = {
        "nd_dispatch_us": dispatch_us(
            lambda: mx.nd.plugin_scaled_add(*small, scale=scale)),
        "wrapper_dispatch_us": dispatch_us(
            lambda: mod.scaled_add(*sd, scale)),
        "nd_add_dispatch_us": dispatch_us(lambda: small[0] + small[1]),
        "torch_add_dispatch_us": dispatch_us(lambda: sd[0] + sd[1])}
    params = params_roundtrip(mx)
    torch.cuda.empty_cache()
    return {"phase": "nd_plugin", "scaled_add_launches": launches,
            "residual_shapes": [list(sh) for sh in RESIDUAL_SHAPES],
            "loop": dict(RESIDUAL_LOOP, losses_card=loop_card,
                         losses_host=loop_host, max_rel_diff=rel,
                         rtol=LOOP_RTOL),
            "per_call": per_call, **dispatch, "params": params}


#: the ResNet-50 nets the training phases build: the model-zoo name,
#: its arguments and the input layout.  "kernel_arm" is the
#: configuration of bench.py's step (channel-last, bias-free 1x1 convs:
#: the fused BN-ReLU-conv tail applies); "zoo_v1" and "zoo_v2" are what
#: get_model builds at the reference's defaults (channel-first, the
#: zoo's biases; example/image-classification/train_imagenet.py trains
#: them), where the fused tail does not apply
NETS = {
    "kernel_arm": ("resnet50_v1", dict(layout="NHWC", no_bias=True), "NHWC"),
    "zoo_v1": ("resnet50_v1", {}, "NCHW"),
    "zoo_v2": ("resnet50_v2", {}, "NCHW"),
}


def resnet50(device, seed, net="kernel_arm"):
    """A ResNet-50 of ``NETS`` at full width and depth, random Xavier
    weights from ``seed``."""
    import torch

    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    name, kwargs, _ = NETS[net]
    block = get_model(name, classes=1000, **kwargs)
    return block.initialize(initializer.Xavier(), device=device,
                            generator=torch.Generator().manual_seed(seed))


def image_batch(batch, net, generator, device, image=None):
    """(x, y): a random image batch in ``net``'s layout and size
    (``NETS``, or a zoo net of ``ZOO_NETS``; ``image`` sets the side)
    and labels."""
    import torch

    side, channels, classes = ZOO_NETS.get(net, (224, 3, 1000))
    image = image or side
    shape = (batch, image, image, channels) \
        if net in NETS and NETS[net][2] == "NHWC" \
        else (batch, channels, image, image)
    x = torch.randn(shape, generator=generator, device=device)
    y = torch.randint(0, classes, (batch,), generator=generator,
                      device=device).float()
    return x, y


def bucket_counters(optimizer):
    """``{name: (wrapper, attribute)}`` of the launch counts of the bucket
    kernels that a step of ``optimizer`` runs once per bucket."""
    from mxnet_tpu_torch.ops import pallas_opt as po

    return {
        "sgd": {"bucket_sgd_mom": (po.bucket_sgd_mom, "launches")},
        "sgd0": {"bucket_sgd": (po.bucket_sgd, "launches")},
        "lars": {"bucket_lars_norms": (po.bucket_lars_norms, "launches"),
                 "bucket_lars_trust": (po.bucket_lars_norms,
                                       "trust_launches"),
                 "bucket_lars_update": (po.bucket_lars_update, "launches")},
        "adam": {"bucket_adam": (po.bucket_adam, "launches")},
    }[optimizer]


#: the training phases: the net (``NETS``), optimizer, its settings,
#: batch, and whether the step is driven through
#: ``DataParallelTrainer.fit_batch`` (else ``make_train_step``'s step
#: function)
TRAIN_PHASES = {
    "train_resnet50": dict(
        net="kernel_arm", optimizer="sgd", batch=128, trainer=False,
        opt=dict(learning_rate=0.1, momentum=0.9)),
    "train_resnet50_lars": dict(
        net="kernel_arm", optimizer="lars", batch=256, trainer=True,
        opt=dict(learning_rate=LARS_HYPER["lr"],
                 momentum=LARS_HYPER["momentum"],
                 lars_eta=LARS_HYPER["eta"], wd=LARS_HYPER["wd"])),
    "train_resnet50_adam": dict(
        net="kernel_arm", optimizer="adam", batch=128, trainer=False,
        opt=dict(learning_rate=ADAM_HYPER["lr"], wd=ADAM_HYPER["wd"])),
    "train_resnet50_nchw": dict(
        net="zoo_v1", optimizer="sgd", batch=128, trainer=False,
        opt=dict(learning_rate=0.1, momentum=0.9)),
    "train_resnet50_v2": dict(
        net="zoo_v2", optimizer="sgd", batch=128, trainer=False,
        opt=dict(learning_rate=0.1, momentum=0.9)),
}


#: kernel families of a training step's profile, by name fragment
STEP_SHARES = {
    "bnreluconv_bwd": ("dact_mma_kernel", "dw_mma_kernel", "dact_kernel",
                       "dw_kernel", "reduce_dw", "reduce_s"),
    "bucket_update": ("bucket_sgd_kernel", "bucket_adam_kernel",
                      "lars_norms_kernel", "lars_trust_kernel",
                      "lars_update_kernel"),
    "convolution": ("cudnn", "xmma", "convolve", "conv2d", "wgrad", "dgrad",
                    "fprop"),
    "elementwise": ("elementwise", "vectorized", "unrolled"),
    "reduction": ("reduce_kernel", "Reduce")}


def brc_per_step(net):
    """Fused-backward launches a step of ``net`` makes: one per
    bottleneck (16) where the fused tail applies, else 0."""
    return 16 if net == "kernel_arm" else 0


def lars_stats_after(stats, applied, cfg):
    """What LARS makes of the running statistics over the steps
    ``applied`` (a bool per step: the dynamic loss scale skips the
    others).  They have no gradient, so each is its own segment with
    trust 1 and moves by the weight-decay term alone (ROADMAP §C); the
    plain update, which the kernel equals bit for bit, gives the exact
    result."""
    import torch

    from mxnet_tpu_torch.ops import pallas_opt as po

    out = {}
    for name, w in stats.items():
        w = w.reshape(-1).clone()
        mom, zero = torch.zeros_like(w), torch.zeros_like(w)
        seg = torch.zeros(w.numel(), dtype=torch.int32, device=w.device)
        slr = torch.full((1,), po._f32(cfg["learning_rate"]),
                         device=w.device)
        for ok in applied:
            if ok:
                w, mom = po._lars_update_reference(
                    w, zero, mom, seg, slr, cfg["wd"], cfg["momentum"], 1.0,
                    None)
        out[name] = w.view(stats[name].shape)
    return out


def train_phase(name, warmup, steps, seed=0):
    """Drive ResNet-50 training on the card through the port's entry
    points (bf16 compute, dynamic loss scaling, the sharded-bucket arm
    on the one-card mesh, both kernel arms forced) with one of
    ``TRAIN_PHASES``.  Launch counts are set to 0 just before the first
    step and read after the last timed one; three more steps then run
    under torch.profiler (device activity only) for kernel time by
    name.  Running statistics: unchanged without weight decay; under
    LARS exactly what its weight-decay term makes of them."""
    import torch

    from mxnet_tpu_torch import autotune, parallel
    from mxnet_tpu_torch.gluon import loss
    from mxnet_tpu_torch.ops import pallas_conv as pc

    cfg = TRAIN_PHASES[name]
    batch, optimizer = cfg["batch"], cfg["optimizer"]
    counters = bucket_counters(optimizer)
    dev = torch.device("cuda", 0)
    net = resnet50(dev, seed, cfg["net"])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x, y = image_batch(batch, cfg["net"], gen, dev)
    torch.cuda.reset_peak_memory_stats()
    with autotune.force(pallas_bnreluconv="pallas", fused_bucket_opt=True):
        t0 = time.perf_counter()
        kw = dict(cfg["opt"], mesh=parallel.get_mesh(),
                  compute_dtype="bfloat16", loss_scale="dynamic",
                  optimizer_sharding="ps")
        if cfg["trainer"]:
            trainer = parallel.DataParallelTrainer(
                net, loss.SoftmaxCrossEntropyLoss(), optimizer, **kw)
            plan, params = trainer.step_fn.zero_plan, trainer.params

            def step(i):
                return trainer.fit_batch(x, y), trainer.params, \
                    trainer.opt_state
        else:
            step_fn, params, state = parallel.make_train_step(
                net, loss.SoftmaxCrossEntropyLoss(), optimizer, **kw)
            plan, carry = step_fn.zero_plan, [params, state]

            def step(i):
                lv, carry[0], carry[1] = step_fn(*carry, x, y, None,
                                                 float(i + 1))
                return lv, carry[0], carry[1]
        build_s = time.perf_counter() - t0
        stats = {n: v.clone() for n, v in params.items()
                 if n.endswith(("running_mean", "running_var"))}
        pc.bnreluconv_bwd.launches = 0
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        losses, goods = [], []
        for i in range(warmup):
            lv, params, state = step(i)
            losses.append(lv)
            goods.append(state["_loss_scale"][1])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(warmup, warmup + steps):
            lv, params, state = step(i)
            losses.append(lv)
            goods.append(state["_loss_scale"][1])
        end.record()
        end.synchronize()
        n_brc = pc.bnreluconv_bwd.launches
        launches = {k: getattr(fn, attr) for k, (fn, attr) in
                    counters.items()}
        scale, good = (float(v) for v in state["_loss_scale"])
        stats_after = {n: params[n].clone() for n in stats}
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t1 = time.perf_counter()
            for i in range(3):
                step(warmup + steps + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    total = warmup + steps
    losses = [float(v) for v in losses]
    applied = [int(v) > 0 for v in goods]  # the count resets on a skip
    ms_step = start.elapsed_time(end) / steps
    res = {
        "phase": name, "net": cfg["net"],
        "model": {"name": NETS[cfg["net"]][0], **NETS[cfg["net"]][1]},
        "layout": NETS[cfg["net"]][2], "batch": batch, "image": 224,
        "compute_dtype": "bfloat16", "optimizer": optimizer,
        "optimizer_settings": cfg["opt"],
        "driver": "DataParallelTrainer.fit_batch" if cfg["trainer"]
        else "make_train_step",
        "warmup_steps": warmup, "timed_steps": steps,
        "ms_per_step": ms_step, "img_s": batch / ms_step * 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "buckets": len(plan), "params": sum(b.size for b in plan),
        "losses": losses, "loss_scale": scale, "good_steps": good,
        "steps_applied": sum(applied),
        "bnreluconv_launches": n_brc,
        **{f"{k}_launches": v for k, v in launches.items()},
        "build_s": build_s,
        "profile_3_steps": device_profile(prof, wall, top=25,
                                          shares=STEP_SHARES),
    }
    check(all(math.isfinite(v) for v in losses), f"loss not finite: "
          f"{losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"{name}: loss did not fall on the fixed batch: {losses}")
    per_step = brc_per_step(cfg["net"])
    check(n_brc == per_step * total, f"{name}: bnreluconv launches {n_brc}"
          f" != {per_step} x {total} steps")
    for k, v in launches.items():
        check(v == len(plan) * total, f"{name}: {k} launches {v} != "
              f"{len(plan)} buckets x {total} steps")
    check((scale == 2.0 ** 16 and good == total) or
          (scale < 2.0 ** 16 and good < total),
          f"loss scale {scale} after {good} good of {total} steps")
    if optimizer == "lars":
        want = lars_stats_after(stats, applied, cfg["opt"])
        res["running_stats"] = "moved by LARS's weight decay alone, exactly"
    elif not cfg["opt"].get("wd"):
        want = stats
        res["running_stats"] = "unchanged"
    else:
        want = None
        res["running_stats"] = "moved by the rule's weight decay (not " \
                               "checked)"
    for n, v in (want or {}).items():
        check(torch.equal(stats_after[n], v),
              f"{name}: running statistic {n} is not {res['running_stats']}")
    return res


#: one fp32 step, card against host.  ResNet-50's gradient at a random
#: init and batch 4 is ill-conditioned in fp32 (BatchNorm backward
#: cancels): the host's fp32 update of the worst parameter differs from
#: a float64 host update by about 2 % in norm (16 % in the worst
#: element), so the card is held to the host's own fp32 error, not to a
#: fixed bound: each parameter's update may be no farther from its
#: float64 update than twice the host's fp32 update of that parameter
#: is, plus 1e-3.  The forward is well conditioned: losses within 1e-5.
#: Adam is held on its first moment instead (its state after the step:
#: (1 - beta1) * g, linear in the gradient like SGD's update): the
#: step itself is lr * sign(g) wherever |g| is well above eps, so an
#: element whose gradient is within fp32 noise of zero steps either way
#: on card and host alike, and one such element moves a small
#: parameter's update norm by far more than the gradient's error.  The
#: update's readings are reported beside it.
CUDA_CPU_TOL = {"loss": 1e-5,
                "update_vs_f64": "per parameter: 2 x host fp32 + 1e-3",
                "adam": "the same rule on the first moment"}
#: the card's float64 step against the host's, both float64 throughout:
#: per parameter's update (and the loss), relative
CUDA_CPU_F64_TOL = 1e-6


#: the card-vs-host steps: (launch counters, optimizer, settings, net,
#: batches).  The kernel-arm net with SGD without momentum (the
#: momentum-0 bucket kernel), LARS and Adam with the settings of their
#: training phases, one batch each; the zoo's v1 and v2 (channel-first)
#: with SGD momentum, as they train, on three batches, each parameter
#: held by its median error over them.  One batch is a single draw of
#: fp32 noise: at random init a relu mask that flips near zero moves a
#: late BatchNorm gamma's gradient by a whole term, so the host's own
#: fp32 error of one parameter differs several times over between
#: inputs an ulp or two apart, and on one batch its luckiest reading
#: would set the card's limit
CUDA_CPU_STEPS = {
    "sgd0": ("sgd0", "sgd", dict(learning_rate=0.1, momentum=0.0),
             "kernel_arm", 1),
    "lars": ("lars", "lars", TRAIN_PHASES["train_resnet50_lars"]["opt"],
             "kernel_arm", 1),
    "adam": ("adam", "adam", TRAIN_PHASES["train_resnet50_adam"]["opt"],
             "kernel_arm", 1),
    "nchw": ("sgd", "sgd", TRAIN_PHASES["train_resnet50_nchw"]["opt"],
             "zoo_v1", 3),
    "v2": ("sgd", "sgd", TRAIN_PHASES["train_resnet50_v2"]["opt"],
           "zoo_v2", 3),
}
#: a parameter whose float64 update is below this share of the whole
#: update's norm is not held: its gradient is 0 by construction, so its
#: update is summation noise.  The zoo's conv biases, which a BatchNorm
#: follows; the gamma of v2's input BatchNorm, which has no scale; and
#: at init (beta 0) that of v2's stem BatchNorm, whose output the first
#: block's BatchNorm normalizes (relu and max pool scale with it)
INERT_SHARE = 1e-6


def _card_host_steps(host, optimizer, opt_kw, counters, x, y,
                     float64_pair=False):
    """One fp32 step from ``host``'s weights on the card (the kernels),
    on the host (the plain versions) and in float64 on the host (the
    unfused layers and the plain bucket rule: the kernels take fp32/bf16
    only): ``({key: (loss, params after, params before, Adam's first
    moment)}, the card step's launches (fused backward, {bucket kernel:
    n}, buckets))``.  ``float64_pair`` adds the float64 step on the card
    and on the host, each ``float64_throughout`` (keys ``cuda64``,
    ``cpu64t``)."""
    import contextlib
    import copy

    import torch

    from mxnet_tpu_torch import autotune, parallel
    from mxnet_tpu_torch.gluon import loss
    from mxnet_tpu_torch.ops import pallas_conv as pc
    from mxnet_tpu_torch.parallel import zero

    out, launches = {}, None
    runs = [("cuda", "cuda", torch.float32, ("pallas", True)),
            ("cpu", "cpu", torch.float32, ("pallas", True)),
            ("cpu64", "cpu", torch.float64, ("stock", False))]
    if float64_pair:
        runs += [("cuda64", "cuda", torch.float64, ("stock", False)),
                 ("cpu64t", "cpu", torch.float64, ("stock", False))]
    for key, where, dtype, arms in runs:
        net = copy.deepcopy(host).to(where, dtype)
        with autotune.force(pallas_bnreluconv=arms[0],
                            fused_bucket_opt=arms[1]), \
                (float64_throughout() if key in ("cuda64", "cpu64t")
                 else contextlib.nullcontext()):
            step, params, state = parallel.make_train_step(
                net, loss.SoftmaxCrossEntropyLoss(), optimizer,
                mesh=parallel.get_mesh(devices=[where]),
                optimizer_sharding="ps", **opt_kw)
            # a copy: the step updates params in place (donation), and
            # .double() of a float64 tensor is the tensor itself
            before = {n: v.detach().to("cpu", torch.float64, copy=True)
                      for n, v in params.items()}
            if key == "cuda":
                pc.bnreluconv_bwd.launches = 0
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
            lv, params, state = step(params, state, x.to(dtype), y, None,
                                     1.0)
            if key == "cuda":
                torch.cuda.synchronize()
                launches = (pc.bnreluconv_bwd.launches,
                            {k: getattr(fn, attr) for k, (fn, attr)
                             in counters.items()}, len(step.zero_plan))
        moment = {}
        if optimizer == "adam":
            for i, b in enumerate(step.zero_plan):
                moment.update(zero.unflatten_bucket(
                    b, state[f"_bucket{i}"][0]))
        out[key] = (float(lv),
                    {n: v.detach().to("cpu", torch.float64, copy=True)
                     for n, v in params.items()}, before,
                    {n: v.to("cpu", torch.float64, copy=True)
                     for n, v in moment.items()})
        del net, params, state, moment
    return out, launches


def cuda_vs_cpu_phase(which, host, batch=4, seed=3,
                      table=CUDA_CPU_STEPS, phase="train_cuda_vs_cpu",
                      image=None, bound=None, float64_pair=False):
    """fp32 steps of a net (``host``, on the host: ResNet-50, or a zoo
    net of ``ZOO_CUDA_CPU_STEPS``) on the card (the kernels) and on the
    host (the plain versions) from the same weights, TF32 off, with a
    float64 host step as the yardstick, with one of ``table``'s steps,
    on its number of batches; each parameter's error is the median over
    the batches (images of side ``image``, default the net's own).  A
    Dropout layer takes the same mask in the three steps of a batch:
    drawn on the host and fed through ``_rng``'s one draw function.
    ``bound``, where given, is the limit of each parameter's error in
    place of twice the host's + 1e-3; ``float64_pair`` also holds the
    card's float64 step to the host's, both ``float64_throughout``, to
    ``CUDA_CPU_F64_TOL``."""
    import statistics

    import torch

    counter_key, optimizer, opt_kw, net_kind, n_batches = table[which]
    counters = bucket_counters(counter_key)
    runs, trained, inert = [], None, None
    for b in range(n_batches):
        gen = torch.Generator().manual_seed(seed + 1 + b)
        x, y = image_batch(batch, net_kind, gen, "cpu", image)
        with fed_dropout_masks(seed + 100 + b):
            out, launches = _card_host_steps(host, optimizer, opt_kw,
                                             counters, x, y, float64_pair)
        runs.append((out, launches))
        if trained is None:
            f64 = out["cpu64"]
            moved = {n: float((f64[1][n] - f64[2][n]).norm())
                     for n in f64[1]
                     if not n.endswith(("running_mean", "running_var"))}
            whole = math.sqrt(sum(v * v for v in moved.values()))
            trained = [n for n, v in moved.items()
                       if v >= INERT_SHARE * whole]
            inert = sorted(set(moved) - set(trained))

    def update_err(a, ref):
        """{parameter: norm error of a's update against ref's}."""
        return {n: float(((a[1][n] - a[2][n]) - (ref[1][n] - ref[2][n]))
                         .norm() / (ref[1][n] - ref[2][n]).norm()
                         .clamp_min(1e-30)) for n in trained}

    def moment_err(a, ref):
        """{parameter: norm error of a's first moment against ref's}."""
        return {n: float((a[3][n] - ref[3][n]).norm()
                         / ref[3][n].norm().clamp_min(1e-30))
                for n in trained}

    def limit(host, n):
        return 2 * host[n] + 1e-3 if bound is None else bound

    def over_limit(card, host):
        return {n: (card[n], host[n]) for n in trained
                if card[n] > limit(host, n)}

    def median(errs):
        return {n: statistics.median(e[n] for e in errs) for n in trained}

    held = "first moment" if optimizer == "adam" else "update"
    held_err = moment_err if optimizer == "adam" else update_err
    per = {k: [] for k in ("card_upd", "host_upd", "card", "host", "cvc")}
    loss_rels = []
    for out, _ in runs:
        gpu, cpu, f64 = out["cuda"], out["cpu"], out["cpu64"]
        loss_rels.append(abs(gpu[0] - cpu[0]) / abs(cpu[0]))
        per["card_upd"].append(update_err(gpu, f64))
        per["host_upd"].append(update_err(cpu, f64))
        per["card"].append(held_err(gpu, f64))
        per["host"].append(held_err(cpu, f64))
        per["cvc"].append(update_err(gpu, cpu))
    gpu, cpu, f64 = (runs[0][0][k] for k in ("cuda", "cpu", "cpu64"))
    launches = runs[0][1]
    card_upd, host_upd = median(per["card_upd"]), median(per["host_upd"])
    card_err, host_err = median(per["card"]), median(per["host"])
    over = over_limit(card_err, host_err)
    worst = max(trained, key=lambda n: card_err[n] - limit(host_err, n))
    # the card's error over the host's, where the host's is above the
    # 1e-3 floor of the limit
    ratio = max([card_err[n] / host_err[n] for n in trained
                 if host_err[n] > 1e-3], default=None)
    loss_rel = max(loss_rels)
    param_rel = max(float((gpu[1][n] - cpu[1][n]).abs().max()
                          / cpu[1][n].abs().max().clamp_min(1e-30))
                    for n in cpu[1])
    res = {"phase": phase, "step": which, "net": net_kind,
           "optimizer": optimizer,
           "optimizer_settings": opt_kw, "batch": batch, "dtype": "float32",
           "batches": n_batches, "held": held, "not_held_inert": inert,
           "loss_cuda": gpu[0], "loss_cpu": cpu[0], "loss_cpu_f64": f64[0],
           "loss_rel": loss_rel,
           # element-wise, for information: the per-parameter norm
           # errors below are what is checked
           "param_max_rel_cuda_vs_cpu": param_rel,
           "held_err_cuda_vs_f64_max": max(card_err.values()),
           "held_err_cpu_vs_f64_max": max(host_err.values()),
           "update_err_cuda_vs_f64_max": max(card_upd.values()),
           "update_err_cpu_vs_f64_max": max(host_upd.values()),
           "update_err_cuda_vs_cpu_max": max(median(per["cvc"]).values()),
           "update_params_over_limit": len(over_limit(card_upd, host_upd)),
           "closest_to_limit": {"param": worst, "cuda_vs_f64":
                                card_err[worst], "cpu_vs_f64":
                                host_err[worst]},
           "max_ratio_cuda_over_cpu_error": ratio,
           "params_checked": len(trained), "params_over_limit": len(over),
           "tol": CUDA_CPU_TOL if bound is None else {
               **CUDA_CPU_TOL, "update_vs_f64": f"per parameter: {bound}"},
           "bnreluconv_launches": launches[0],
           **{f"{k}_launches": v for k, v in launches[1].items()},
           "buckets": launches[2],
           "over_limit": {n: list(v) for n, v in list(over.items())[:8]}}
    if n_batches > 1:  # each batch on its own, for information
        res["per_batch"] = [
            {"loss_rel": lr, "over_limit": {
                n: [c[n], h[n]] for n in trained if c[n] > limit(h, n)}}
            for lr, c, h in zip(loss_rels, per["card"], per["host"])]
    if float64_pair:
        gaps = [update_err(o["cuda64"], o["cpu64t"]) for o, _ in runs]
        f64_gap = max(max(g.values()) for g in gaps)
        res["float64_update_err_cuda_vs_cpu_max"] = f64_gap
        res["float64_loss_rel"] = max(
            abs(o["cuda64"][0] - o["cpu64t"][0]) / abs(o["cpu64t"][0])
            for o, _ in runs)
        res["float64_tol"] = CUDA_CPU_F64_TOL
    emit(res)
    check(loss_rel <= CUDA_CPU_TOL["loss"] and not over,
          f"cuda vs cpu ({which}): loss rel {loss_rel}; parameters whose "
          f"{held} error against float64 exceeds "
          f"{res['tol']['update_vs_f64']} (card, host): "
          f"{dict(list(over.items())[:8])}")
    if float64_pair:
        check(f64_gap <= CUDA_CPU_F64_TOL
              and res["float64_loss_rel"] <= CUDA_CPU_F64_TOL,
              f"cuda vs cpu ({which}): float64 update {f64_gap}, loss "
              f"{res['float64_loss_rel']} apart (limit {CUDA_CPU_F64_TOL})")
    for _, launches in runs:
        check(launches[0] == brc_per_step(net_kind) and
              all(v == launches[2] for v in launches[1].values()),
              f"cuda step launches ({which}) {launches}")
    return res


# ------------------------------------------------ the imperative Gluon loop
#: the reference's LeNet/MNIST baseline
#: (example/image-classification/train_mnist.py): its synthetic digits,
#: batch 64, 2 epochs, SGD lr 0.02 momentum 0.9; the accuracy on the
#: synthetic validation digits it must reach (the reference's own host
#: run reads 1.0000)
LENET = dict(batch_size=64, epochs=2, lr=0.02, min_val_acc=0.95)
#: the Gluon ResNet-50: bench.py's kernel-arm net (channel-last,
#: bias-free 1x1 convs) with the reference's deferred stem, bf16 with
#: fp32 masters, and the Trainer's settings
GLUON_RESNET = dict(batch=128, image=224, warmup=2, steps=10, profiled=3,
                    opt=dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                             multi_precision=True),
                    scheduler=dict(step=5, factor=0.9))


def gluon_lenet_phase(seed=0):
    """The port's train_mnist loop on ``mx.gpu(0)``: per-epoch loss and
    accuracy, validation accuracy, ms/step."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example import train_mnist

    onp.random.seed(seed)  # the sampler's shuffle
    torch.manual_seed(seed)  # the initializer's draws
    res = train_mnist.train("lenet", LENET["batch_size"], LENET["epochs"],
                            LENET["lr"], ctx=mx.gpu(0), log=log)
    out = {"phase": "gluon_lenet", "network": "lenet",
           "data": "synthetic digits, synth(4096, 1) / synth(512, 2)",
           **{k: v for k, v in LENET.items() if k != "min_val_acc"},
           "epochs_loss_acc": res["epochs"], "val_acc": res["val_acc"],
           "ms_per_step": res["ms_per_step"],
           "ms_per_step_by_epoch": res["ms_per_step_by_epoch"],
           "steps": res["steps"],
           "reference_host_run": {"train_acc": [0.5876, 0.9888],
                                  "val_acc": 1.0}}
    emit(out)
    losses = [e["loss"] for e in res["epochs"]]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"gluon_lenet: the loss did not fall: {losses}")
    check(res["val_acc"] >= LENET["min_val_acc"],
          f"gluon_lenet: validation accuracy {res['val_acc']} < "
          f"{LENET['min_val_acc']}")
    return out


def gluon_resnet50(ctx, seed, generator=None):
    """ResNet-50 v1 (``GLUON_RESNET``'s net) with Xavier weights from
    ``seed``; its stem's shape is deferred until the first forward."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = resnet50_v1(classes=1000, layout="NHWC", no_bias=True,
                      in_channels=0)
    return net.initialize(mx.init.Xavier(), ctx=ctx,
                          generator=generator or
                          torch.Generator().manual_seed(seed))


def _gluon_loss_step(net, trainer, x, y, host_ms=None):
    """One step of the Gluon loop: forward and loss under
    ``autograd.record()``, ``backward``, ``Trainer.step`` (its host time
    appended to ``host_ms``).  Returns the per-sample loss."""
    from mxnet_tpu_torch import autograd, gluon

    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    t0 = time.perf_counter()
    trainer.step(x.shape[0])
    if host_ms is not None:
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return loss


def gluon_resnet50_phase(seed=0):
    """ResNet-50 trained by the imperative Gluon loop on the card (bf16,
    multi_precision, a FactorScheduler, the fused tail's kernel arm
    forced): ms/step by CUDA events, the host time of ``trainer.step``,
    the idle share and kernel time by name over profiled steps.  The
    fused-backward count is set to 0 just before the first step and
    read after the last timed one."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, autotune, gluon, lr_scheduler
    from mxnet_tpu_torch.ops import pallas_conv as pc

    cfg = GLUON_RESNET
    batch, warmup, steps = cfg["batch"], cfg["warmup"], cfg["steps"]
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    net = gluon_resnet50(ctx, seed)
    net.cast("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = mx.nd.NDArray(torch.randn((batch, cfg["image"], cfg["image"], 3),
                                  generator=gen, device=dev)
                      .to(torch.bfloat16))
    y = mx.nd.NDArray(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev, dtype=torch.int32))
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
        cfg["opt"], lr_scheduler=lr_scheduler.FactorScheduler(
            **cfg["scheduler"])))
    torch.cuda.reset_peak_memory_stats()
    losses, lrs, host_ms = [], [], []
    with autotune.force(pallas_bnreluconv="pallas"):
        pc.bnreluconv_bwd.launches = 0
        for _ in range(warmup):
            losses.append(_gluon_loss_step(net, trainer, x, y)._data
                          .float().mean())
            lrs.append(trainer.learning_rate)
        params = net.collect_params()
        stats = {n: p.data()._data.clone() for n, p in params.items()
                 if n.endswith(("running_mean", "running_var"))}
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        marks[0].record()
        for i in range(steps):
            losses.append(_gluon_loss_step(net, trainer, x, y, host_ms)
                          ._data.float().mean())
            lrs.append(trainer.learning_rate)
            marks[i + 1].record()
        marks[-1].synchronize()
        mem1 = torch.cuda.memory_stats()
        n_brc = pc.bnreluconv_bwd.launches
        moved = sum(not torch.equal(params[n].data()._data, v)
                    for n, v in stats.items())
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t1 = time.perf_counter()
            for _ in range(cfg["profiled"]):
                _gluon_loss_step(net, trainer, x, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        # trainer.step alone, the device idle before it: its host time
        # without the launch queue's back-pressure, and its device time
        alone_host, alone_dev = [], []
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        for _ in range(cfg["profiled"]):
            with autograd.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
            loss.backward()
            torch.cuda.synchronize()
            t_start.record()
            t1 = time.perf_counter()
            trainer.step(batch)
            alone_host.append((time.perf_counter() - t1) * 1e3)
            t_end.record()
            t_end.synchronize()
            alone_dev.append(t_start.elapsed_time(t_end))
    total = warmup + steps
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms_step = marks[0].elapsed_time(marks[-1]) / steps
    sched = lr_scheduler.FactorScheduler(**cfg["scheduler"])
    sched.base_lr = cfg["opt"]["learning_rate"]
    want_lrs = [sched(n) for n in range(1, total + 1)]
    states = trainer._updaters[0].states
    res = {
        "phase": "gluon_resnet50", "loop": "gluon.Trainer (imperative)",
        "model": {"name": "resnet50_v1", "layout": "NHWC", "no_bias": True,
                  "in_channels": "deferred"},
        "batch": batch, "image": cfg["image"], "dtype": "bfloat16",
        "optimizer": "sgd", "optimizer_settings": cfg["opt"],
        "lr_scheduler": {"FactorScheduler": cfg["scheduler"]},
        "warmup_steps": warmup, "timed_steps": steps,
        "ms_per_step": ms_step, "img_s": batch / ms_step * 1e3,
        "step_ms": step_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        # cudaMalloc calls and cache-flushing retries (each syncs the
        # device) during the timed steps
        "timed_cuda_mallocs": mem1.get("num_device_alloc", 0)
        - mem0.get("num_device_alloc", 0),
        "timed_alloc_retries": mem1.get("num_alloc_retries", 0)
        - mem0.get("num_alloc_retries", 0),
        "trainer_step_host_ms": sum(host_ms) / len(host_ms),
        "trainer_step_host_ms_each": host_ms,
        "trainer_step_alone_host_ms": sum(alone_host) / len(alone_host),
        "trainer_step_alone_ms": sum(alone_dev) / len(alone_dev),
        "trained_tensors": len(states),
        "trained_elements": sum(p.data().size for p in params.values()
                                if p.grad_req != "null"),
        "losses": losses, "learning_rates": lrs,
        "bnreluconv_launches": n_brc,
        "running_stats_moved": f"{moved} of {len(stats)}",
        "profile_3_steps": device_profile(prof, wall, top=25,
                                          shares=STEP_SHARES),
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses), f"gluon_resnet50: loss "
          f"not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"gluon_resnet50: the loss did not fall: {losses}")
    check(n_brc == 16 * total, f"gluon_resnet50: bnreluconv launches "
          f"{n_brc} != 16 x {total} steps")
    check(moved == len(stats), f"gluon_resnet50: {len(stats) - moved} "
          "running statistics did not move")
    check(all(math.isclose(a, b, rel_tol=1e-12)
              for a, b in zip(lrs, want_lrs)),
          f"gluon_resnet50: learning rates {lrs} are not the "
          f"scheduler's {want_lrs}")
    # bf16 weights carry (fp32 master, (momentum,)); BatchNorm's, kept
    # fp32 by cast, (momentum,)
    flat = [t for st in states.values() for t in
            ((st[0], *st[1]) if len(st) == 2 else st)]
    check(len(flat) == len(states) + sum(len(st) == 2
                                         for st in states.values())
          and all(t._data.dtype == torch.float32 and t._data.is_cuda
                  for t in flat),
          "gluon_resnet50: masters and momenta are not fp32 on the card")
    return res


def _gluon_card_host_steps(host, x, y):
    """One fp32 Gluon step from ``host``'s weights on the card (the
    kernel arm of the fused tail), on the host (its plain version) and
    in float64 on the host (unfused): ``{key: (loss, params after,
    params before, momenta, running statistics before and after)}`` and
    the card step's fused-backward launches."""
    import copy

    import torch

    from mxnet_tpu_torch import autotune, gluon, lr_scheduler
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import pallas_conv as pc

    out, launches = {}, None
    for key, where, dtype, arm in (
            ("cuda", "cuda", torch.float32, "pallas"),
            ("cpu", "cpu", torch.float32, "pallas"),
            ("cpu64", "cpu", torch.float64, "stock")):
        net = copy.deepcopy(host).to(where)
        net.cast(str(dtype).replace("torch.", ""))
        params = net.collect_params()

        def snap(stats):
            return {n: p.data()._data.detach().to("cpu", torch.float64,
                                                   copy=True)
                    for n, p in params.items()
                    if stats == n.endswith(("running_mean", "running_var"))}

        before, stats0 = snap(False), snap(True)
        trainer = gluon.Trainer(params, "sgd", dict(
            GLUON_RESNET["opt"], lr_scheduler=lr_scheduler.FactorScheduler(
                **GLUON_RESNET["scheduler"])))
        with autotune.force(pallas_bnreluconv=arm):
            if key == "cuda":
                pc.bnreluconv_bwd.launches = 0
            loss = _gluon_loss_step(net, trainer,
                                    NDArray(x.to(where, dtype)),
                                    NDArray(y.to(where)))
            if key == "cuda":
                torch.cuda.synchronize()
                launches = pc.bnreluconv_bwd.launches
        names = list(params)
        moms = {names[i]: s._data.to("cpu", torch.float64, copy=True)
                for i, (s,) in trainer._updaters[0].states.items()}
        out[key] = (float(loss._data.double().mean()), snap(False), before,
                    moms, stats0, snap(True))
        del net, trainer, params
    return out, launches


def gluon_cuda_vs_cpu_phase(batch=4, seed=3, n_batches=3):
    """One fp32 Gluon step of ``GLUON_RESNET``'s net on the card and on
    the host from the same weights, TF32 off, held as the fused steps
    are (``CUDA_CPU_TOL``): the loss to 1e-5; each parameter's update,
    each momentum and each running statistic's change no farther from
    the float64 step's than twice the host's fp32 one is, plus 1e-3,
    each by its median over ``n_batches`` batches."""
    import statistics

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx

    with mx.cpu():
        host = gluon_resnet50(mx.cpu(), seed)
        host(mx.nd.zeros((1, 224, 224, 3)))  # resolves the stem
    runs = []
    for b in range(n_batches):
        gen = torch.Generator().manual_seed(seed + 1 + b)
        x = torch.randn((batch, 224, 224, 3), generator=gen)
        y = torch.from_numpy(onp.random.RandomState(seed + b).randint(
            0, 1000, batch).astype("int32"))
        runs.append(_gluon_card_host_steps(host, x, y))
    f64 = runs[0][0]["cpu64"]
    moved = {n: float((f64[1][n] - f64[2][n]).norm()) for n in f64[1]}
    whole = math.sqrt(sum(v * v for v in moved.values()))
    trained = [n for n, v in moved.items() if v >= INERT_SHARE * whole]

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-30))

    def errs(r, key):
        """{quantity/name: error against float64} of one run's ``key``."""
        run, ref = r[key], r["cpu64"]
        e = {f"update/{n}": rel(run[1][n] - run[2][n],
                                ref[1][n] - ref[2][n]) for n in trained}
        e.update({f"momentum/{n}": rel(run[3][n], ref[3][n])
                  for n in trained})
        e.update({f"running/{n}": rel(run[5][n] - run[4][n],
                                      ref[5][n] - ref[4][n])
                  for n in ref[5]})
        return e

    card = [errs(r, "cuda") for r, _ in runs]
    hosts = [errs(r, "cpu") for r, _ in runs]
    card_m = {k: statistics.median(e[k] for e in card) for k in card[0]}
    host_m = {k: statistics.median(e[k] for e in hosts) for k in hosts[0]}
    over = {k: (card_m[k], host_m[k]) for k in card_m
            if card_m[k] > 2 * host_m[k] + 1e-3}
    loss_rel = max(abs(r["cuda"][0] - r["cpu"][0]) / abs(r["cpu"][0])
                   for r, _ in runs)
    worst = max(card_m, key=lambda k: card_m[k] - 2 * host_m[k])
    res = {"phase": "gluon_cuda_vs_cpu", "net": "resnet50_v1 NHWC no_bias",
           "loop": "gluon.Trainer", "optimizer_settings":
           GLUON_RESNET["opt"], "batch": batch, "dtype": "float32",
           "batches": n_batches, "loss_cuda": runs[0][0]["cuda"][0],
           "loss_cpu": runs[0][0]["cpu"][0],
           "loss_cpu_f64": runs[0][0]["cpu64"][0], "loss_rel": loss_rel,
           "held": {"update": len(trained), "momentum": len(trained),
                    "running_stat": len(runs[0][0]["cpu64"][5])},
           "not_held_inert": sorted(set(moved) - set(trained)),
           "err_cuda_vs_f64_max": max(card_m.values()),
           "err_cpu_vs_f64_max": max(host_m.values()),
           "closest_to_limit": {"quantity": worst,
                                "cuda_vs_f64": card_m[worst],
                                "cpu_vs_f64": host_m[worst]},
           "over_limit": {k: list(v) for k, v in list(over.items())[:8]},
           "tol": CUDA_CPU_TOL,
           "bnreluconv_launches": [n for _, n in runs]}
    emit(res)
    check(loss_rel <= CUDA_CPU_TOL["loss"] and not over,
          f"gluon cuda vs cpu: loss rel {loss_rel}; over the limit "
          f"(card, host): {dict(list(over.items())[:8])}")
    check(all(n == 16 for _, n in runs),
          f"gluon cuda step launches {[n for _, n in runs]} != 16")
    return res


# ------------------------------------ Gluon's compiled and symbolic half
#: the graphed Gluon ResNet-50 runs GLUON_RESNET; its three-step
#: comparison with the eager loop runs cuDNN deterministic, from one init
HYBRID_EQUAL_STEPS = 3
#: the zoo's default ResNet-50 v1 (NCHW, the zoo's biases, fp32, TF32
#: off) trained a few Gluon steps, exported and read back
GLUON_EXPORT = dict(batch=32, image=224, steps=3, predict_reps=5,
                    opt=dict(learning_rate=0.01, momentum=0.9, wd=1e-4))
#: the exported graph read back predicts as the Gluon net: bit for bit,
#: else within this share of the output's largest magnitude
EXPORT_PREDICT_TOL = 1e-5


def _count_kernels(prof, fragment):
    """Launches of the kernels whose name holds ``fragment`` in a
    profile."""
    return sum(e.count for e in prof.key_averages() if fragment in e.key)


def _hybrid_equal_run(seed, hybrid, steps):
    """``steps`` Gluon steps of ``GLUON_RESNET``'s net from one init
    (``seed``), eager or graphed: the losses and every parameter and
    running statistic after them."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, lr_scheduler

    cfg = GLUON_RESNET
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    net = gluon_resnet50(ctx, seed)
    net.cast("bfloat16")
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = mx.nd.NDArray(torch.randn((cfg["batch"], cfg["image"], cfg["image"],
                                   3), generator=gen, device=dev)
                      .to(torch.bfloat16))
    y = mx.nd.NDArray(torch.randint(0, 1000, (cfg["batch"],), generator=gen,
                                    device=dev, dtype=torch.int32))
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
        cfg["opt"], lr_scheduler=lr_scheduler.FactorScheduler(
            **cfg["scheduler"])))
    losses = [_gluon_loss_step(net, trainer, x, y)._data.detach().clone()
              for _ in range(steps)]
    torch.cuda.synchronize()
    return losses, {n: p.data()._data.detach().clone()
                    for n, p in net.collect_params().items()}


def _max_diff(a, b):
    """Largest |a - b| over matching tensors (two runs' losses and
    parameters), and the count of tensors that differ at all."""
    # the nets' prefixes differ: their parameters pair up in order
    pairs = list(zip(a[0], b[0])) + list(zip(a[1].values(),
                                             b[1].values()))
    diffs = [float((p.float() - q.float()).abs().max()) for p, q in pairs]
    return max(diffs), sum(d > 0 for d in diffs)


def gluon_hybrid_resnet50_phase(eager, seed=0):
    """``gluon_resnet50``'s loop with the net hybridized with both
    static flags: every step replays the captured forward and backward
    graphs.  ms/step by CUDA events, peak GiB, ``trainer.step``'s host
    ms, the idle share and the fused backward's launches by kernel name
    in 3 profiled steps, graph entries and captures, beside the eager
    phase ``eager`` of this run; then three steps from one init equal
    eager's (cuDNN deterministic)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, gluon, lr_scheduler
    from mxnet_tpu_torch.gluon import _graph
    from mxnet_tpu_torch.ops import pallas_conv as pc

    cfg = GLUON_RESNET
    batch, warmup, steps = cfg["batch"], cfg["warmup"], cfg["steps"]
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = gluon_resnet50(ctx, seed)
    net.cast("bfloat16")
    net.hybridize(static_alloc=True, static_shape=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = mx.nd.NDArray(torch.randn((batch, cfg["image"], cfg["image"], 3),
                                  generator=gen, device=dev)
                      .to(torch.bfloat16))
    y = mx.nd.NDArray(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev, dtype=torch.int32))
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
        cfg["opt"], lr_scheduler=lr_scheduler.FactorScheduler(
            **cfg["scheduler"])))
    captures0 = _graph.captures
    losses, host_ms = [], []
    with autotune.force(pallas_bnreluconv="pallas"):
        pc.bnreluconv_bwd.launches = 0
        t0 = time.perf_counter()
        losses.append(_gluon_loss_step(net, trainer, x, y)._data.float()
                      .mean())
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        wrapper_calls = pc.bnreluconv_bwd.launches
        for _ in range(warmup - 1):
            losses.append(_gluon_loss_step(net, trainer, x, y)._data
                          .float().mean())
        params = net.collect_params()
        stats = {n: p.data()._data.clone() for n, p in params.items()
                 if n.endswith(("running_mean", "running_var"))}
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        marks[0].record()
        for i in range(steps):
            losses.append(_gluon_loss_step(net, trainer, x, y, host_ms)
                          ._data.float().mean())
            marks[i + 1].record()
        marks[-1].synchronize()
        moved = sum(not torch.equal(params[n].data()._data, v)
                    for n, v in stats.items())
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t1 = time.perf_counter()
            for _ in range(cfg["profiled"]):
                _gluon_loss_step(net, trainer, x, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        replay_wrapper_calls = pc.bnreluconv_bwd.launches - wrapper_calls
        alone_host = []
        for _ in range(cfg["profiled"]):
            with mx.autograd.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.step(batch)
            alone_host.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    captures = _graph.captures - captures0
    dact = _count_kernels(prof, "dact_mma_kernel")
    entries = list(net._cached_op.values())
    losses = [float(v) for v in losses]
    ms_step = marks[0].elapsed_time(marks[-1]) / steps
    profile = device_profile(prof, wall, top=25, shares=STEP_SHARES)
    n_stats = len(stats)
    del net, trainer, x, y, params, stats, prof
    torch.cuda.empty_cache()

    # three steps from one init, graphed and eager, cuDNN deterministic
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with autotune.force(pallas_bnreluconv="pallas"):
            runs = {}
            for key, hybrid in (("eager", False), ("graphed", True),
                                ("eager_again", False)):
                runs[key] = _hybrid_equal_run(seed + 7, hybrid,
                                              HYBRID_EQUAL_STEPS)
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
    graphed_vs_eager, n_diff = _max_diff(runs["graphed"], runs["eager"])
    eager_vs_eager, _ = _max_diff(runs["eager_again"], runs["eager"])
    del runs
    torch.cuda.empty_cache()
    res = {
        "phase": "gluon_hybrid_resnet50",
        "loop": "gluon.Trainer, net.hybridize(static_alloc=True, "
                "static_shape=True): CUDA-graph replays",
        "model": {"name": "resnet50_v1", "layout": "NHWC", "no_bias": True,
                  "in_channels": "deferred"},
        "batch": batch, "image": cfg["image"], "dtype": "bfloat16",
        "optimizer": "sgd", "optimizer_settings": cfg["opt"],
        "lr_scheduler": {"FactorScheduler": cfg["scheduler"]},
        "warmup_steps": warmup, "timed_steps": steps,
        "ms_per_step": ms_step, "img_s": batch / ms_step * 1e3,
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "first_step_with_capture_s": capture_s,
        "peak_mem_gib": peak,
        "trainer_step_host_ms": sum(host_ms) / len(host_ms),
        "trainer_step_alone_host_ms": sum(alone_host) / len(alone_host),
        "losses": losses,
        "graph_entries": len(entries),
        "graph_entries_graphed": sum(e.graphed for e in entries),
        "graph_captures": captures,
        "graph_programs": sum(len(e.programs) for e in entries
                              if e.graphed),
        "bnreluconv_wrapper_calls_warmup_and_capture": wrapper_calls,
        "bnreluconv_wrapper_calls_in_replays": replay_wrapper_calls,
        "bnreluconv_dact_kernels_3_profiled_steps": dact,
        "running_stats_moved": f"{moved} of {n_stats}",
        "equal_steps": HYBRID_EQUAL_STEPS,
        "graphed_vs_eager_max_abs": graphed_vs_eager,
        "graphed_vs_eager_tensors_differing": n_diff,
        "eager_vs_eager_max_abs": eager_vs_eager,
        "eager": {k: eager[k] for k in (
            "ms_per_step", "img_s", "peak_mem_gib", "trainer_step_host_ms",
            "trainer_step_alone_host_ms") if k in eager} | {
            "device_idle_share": eager.get("profile_3_steps", {}).get(
                "device_idle_share")},
        "profile_3_steps": profile,
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"gluon_hybrid_resnet50: loss not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"gluon_hybrid_resnet50: the loss did not fall: {losses}")
    check(len(entries) == 1 and entries[0].graphed and captures == 1
          and len(entries[0].programs) == 1,
          f"gluon_hybrid_resnet50: {len(entries)} entries, {captures} "
          "captures (1 and 1 expected)")
    check(replay_wrapper_calls == 0 and dact == 16 * cfg["profiled"],
          f"gluon_hybrid_resnet50: the fused backward ran {dact} times in "
          f"{cfg['profiled']} replayed steps (16 a step expected), its "
          f"wrapper {replay_wrapper_calls} times")
    check(moved == n_stats, f"gluon_hybrid_resnet50: "
          f"{n_stats - moved} running statistics did not move")
    check(graphed_vs_eager <= 2 * eager_vs_eager,
          f"gluon_hybrid_resnet50: graphed steps {graphed_vs_eager} from "
          f"eager's, two eager runs {eager_vs_eager} apart")
    return res


def gluon_export_resnet50_phase(workdir, seed=0):
    """The zoo's default ``resnet50_v1()`` (NCHW, fp32, TF32 off) trained
    ``GLUON_EXPORT["steps"]`` Gluon steps on the card, exported, and
    read back on the card by ``gluon.SymbolBlock.imports`` and by
    ``mx.mod.Module.load``: each predicts a batch as the Gluon net does.
    The files equal a host export of the same weights byte for byte
    (both exports start the graph's auto-names afresh)."""
    import copy

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.symbol import symbol as sym_mod

    cfg = GLUON_EXPORT
    batch = cfg["batch"]
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = mx.nd.NDArray(torch.randn((batch, 3, cfg["image"], cfg["image"]),
                                  generator=gen, device=dev))
    y = mx.nd.NDArray(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev, dtype=torch.int32))
    trainer = gluon.Trainer(net.collect_params(), "sgd", cfg["opt"])
    losses = [float(_gluon_loss_step(net, trainer, x, y)._data.mean())
              for _ in range(cfg["steps"])]
    want = net(x)._data
    prefix = os.path.join(workdir, "gluon_export", "resnet50_v1")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    files = {}
    for where, block in (("card", net), ("host", None)):
        if block is None:
            block = copy.deepcopy(net)
            block.collect_params().reset_ctx(mx.cpu())
        sym_mod._UNNAMED_COUNT.clear()
        t0 = time.perf_counter()
        block.export(f"{prefix}_{where}")
        files[where] = {"export_s": time.perf_counter() - t0, "bytes": [
            open(f"{prefix}_{where}{sfx}", "rb").read()
            for sfx in ("-symbol.json", "-0000.params")]}
    card = f"{prefix}_card"

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(cfg["predict_reps"]):
            fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b) / cfg["predict_reps"]

    sb = gluon.SymbolBlock.imports(card + "-symbol.json", ["data"],
                                   card + "-0000.params", ctx=ctx)
    got_sb, sb_ms = timed(lambda: sb(x)._data)
    mod = mx.mod.Module.load(card, 0, label_names=None, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, cfg["image"], cfg["image"]))],
             for_training=False)

    def module_predict():
        mod.forward(mx.io.DataBatch([x]), is_train=False)
        return mod.get_outputs()[0]._data

    got_mod, mod_ms = timed(module_predict)
    _, gluon_ms = timed(lambda: net(x)._data)
    scale = float(want.abs().max())
    agree = {}
    for name, got in (("symbolblock", got_sb), ("module", got_mod)):
        err = float((got - want).abs().max())
        agree[name] = {"bit_for_bit": bool(torch.equal(got, want)),
                       "max_abs": err, "max_rel_of_largest": err / scale,
                       "device": str(got.device)}
    res = {"phase": "gluon_export_resnet50",
           "model": {"name": "resnet50_v1", "layout": "NCHW",
                     "classes": 1000}, "batch": batch,
           "image": cfg["image"], "dtype": "float32 (TF32 off)",
           "optimizer_settings": cfg["opt"], "losses": losses,
           "symbol_json_bytes": len(files["card"]["bytes"][0]),
           "params_bytes": len(files["card"]["bytes"][1]),
           "export_s": files["card"]["export_s"],
           "files_equal_host_export": files["card"]["bytes"]
           == files["host"]["bytes"],
           "predict_ms": {"gluon": gluon_ms, "symbolblock": sb_ms,
                          "module": mod_ms},
           "agreement": agree, "tolerance_rel": EXPORT_PREDICT_TOL,
           "parameters": len(sb.collect_params())}
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"gluon_export_resnet50: loss not finite: {losses}")
    check(res["files_equal_host_export"],
          "gluon_export_resnet50: the card's files differ from a host "
          "export of the same weights")
    for name, a in agree.items():
        check(a["device"].startswith("cuda") and (
            a["bit_for_bit"] or a["max_rel_of_largest"] <= EXPORT_PREDICT_TOL),
              f"gluon_export_resnet50: {name} predicts {a} from the Gluon "
              "net")
    return res



# ------------------------------------------- serving trained models
#: the zoo's default ResNet-50 v1 served (NCHW, 1000 classes, 224²,
#: fp32, TF32 off, random weights from a seed): an artifact of batch 32
#: (one bucket) and the functionalized net through the micro-batch race's
#: winner (buckets up to 32); closed-loop clients at each level, single
#: images from a pool, deadline = the SLO
SERVE = dict(batch=32, image=224, images=64, levels=(1, 8, 32, 64),
             requests=256, slo_ms=1000.0, coalesce_ms=2.0,
             candidates=(1, 2, 4), tune_iters=6)
#: a row served in a padded batch of one size against the same image's
#: row in a batch of another size (cuDNN may pick other algorithms per
#: shape): largest |difference| over the largest |logit|.  Read 1.42e-6
#: on an H100 (PERF.md); held at 1e-5
SERVE_ACROSS_BUCKETS_TOL = 1e-5
#: the fleet phase: swap clients; the budget over the two residents'
#: reserved bytes; the generative prompts (lengths) and tokens
FLEET = dict(swap_clients=8, headroom=0.05, prompt_lens=(5, 17, 64, 128),
             max_new=8, gen_seed=11)


def _serve_net(ctx, seed):
    """The zoo's default ``resnet50_v1()`` on ``ctx``, Xavier weights
    drawn from ``seed``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(seed))
    return net


def _serve_images(n, image, seed):
    import numpy as np

    return np.random.RandomState(seed).randn(n, 3, image, image).astype(
        "float32")


def _direct_rows(net, images, buckets):
    """``{bucket: (n, classes) numpy}``: each image's row of the net's
    direct (eager) forward, the images run in batches of each bucket."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    dev = torch.device("cuda", 0)
    out = {}
    with torch.no_grad():
        for b in buckets:
            rows = []
            for i in range(0, len(images), b):
                x = torch.from_numpy(images[i:i + b]).to(dev)
                rows.append(net(mx.nd.NDArray(x))._data.cpu().numpy())
            out[b] = np.concatenate(rows)
    return out


def _closed_loop(submit, images, threads, n_requests, slo_ms,
                 on_result=None):
    """``threads`` clients, each submitting one image and waiting for
    its answer before the next, until ``n_requests`` were submitted:
    ``(outcomes, wall_s)``; an outcome is ``(image, row or None, reason
    or None, latency_ms, t_submit)``."""
    import threading as _th

    from mxnet_tpu_torch.serving import ServeRejected

    lock = _th.Lock()
    count = [0]
    outcomes = []

    def client():
        while True:
            with lock:
                i = count[0]
                if i >= n_requests:
                    return
                count[0] += 1
            idx = i % len(images)
            t_sub = time.perf_counter()
            try:
                h = submit(images[idx], slo_ms)
                row = h.result(timeout=120)
                rec = (idx, row, None, h.latency_ms, t_sub)
            except ServeRejected as e:
                rec = (idx, None, e.reason, None, t_sub)
            with lock:
                outcomes.append(rec)

    t0 = time.perf_counter()
    ts = [_th.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return outcomes, time.perf_counter() - t0


def _rows_match(outcomes, refs):
    """Completed rows that equal no direct forward bit for bit, and the
    buckets whose forward each matched."""
    import numpy as np

    bad, hits = 0, {}
    for idx, row, _, _, _ in outcomes:
        if row is None:
            continue
        b = next((b for b, r in refs.items()
                  if np.array_equal(row, r[idx])), None)
        if b is None:
            bad += 1
        else:
            hits[b] = hits.get(b, 0) + 1
    return bad, hits


def _serve_levels(name, srv, images, refs, profile_busiest=True):
    """Drive ``srv`` at each client level; print and check each."""
    import torch

    from mxnet_tpu_torch.telemetry.opstats import percentile

    cfg = SERVE
    levels = []
    for threads in cfg["levels"]:
        st0 = dict(srv.stats)
        busiest = threads == max(cfg["levels"])
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) \
            if busiest and profile_busiest else contextlib.nullcontext()
        with prof:
            outs, wall = _closed_loop(
                lambda x, slo: srv.submit(x, deadline_ms=slo), images,
                threads, cfg["requests"], cfg["slo_ms"])
            torch.cuda.synchronize()
        st = srv.stats
        done = [o for o in outs if o[1] is not None]
        lat = sorted(o[3] for o in done)
        batches = st["batches"] - st0["batches"]
        bad, hits = _rows_match(outs, refs)
        lv = {"clients": threads, "submitted": len(outs),
              "completed": len(done),
              "shed": len(outs) - len(done),
              "shed_by_reason": {r: sum(o[2] == r for o in outs)
                                 for r in {o[2] for o in outs} - {None}},
              "requests_s": len(done) / wall, "wall_s": wall,
              "p50_ms": percentile(lat, 0.50), "p99_ms": percentile(lat, 0.99),
              "batches": batches,
              "mean_batch": len(done) / batches if batches else 0.0,
              "padded_rows": st["padded_rows"] - st0["padded_rows"],
              "rows_not_equal_direct": bad, "rows_by_bucket_matched": hits,
              "retraces": st["retraces"]}
        if busiest and profile_busiest:
            lv["profile"] = device_profile(prof, wall, top=6, shares={})
        levels.append(lv)
        log(f"[{name}] {threads} clients: {lv['requests_s']:.1f} req/s, "
            f"p50 {lv['p50_ms']:.2f} p99 {lv['p99_ms']:.2f} ms, "
            f"{batches} batches (mean {lv['mean_batch']:.2f}), padded "
            f"{lv['padded_rows']}, shed {lv['shed']}, not equal {bad}")
        check(lv["completed"] + lv["shed"] == lv["submitted"]
              == cfg["requests"],
              f"{name}: {threads} clients: completed {lv['completed']} + "
              f"shed {lv['shed']} != submitted {lv['submitted']}")
        check(lv["completed"] >= 1, f"{name}: nothing completed")
        check(bad == 0, f"{name}: {bad} served rows equal no direct "
                        f"forward of their image bit for bit")
        check(st["retraces"] == 0, f"{name}: {st['retraces']} retraces "
                                   "after warm-up")
    return levels


def serve_resnet50_phase(workdir, seed=0):
    """The zoo's default ResNet-50 v1 served on the card two ways: a
    ``deploy.export_model`` artifact through
    ``ModelServer.from_artifact`` (one bucket, the artifact's batch of
    32) and the functionalized net through
    ``ModelServer.from_predictor`` (the micro-batch race's winner seeds
    the buckets).  Closed-loop clients at each level submit single
    images with the SLO as deadline: requests/s, p50/p99 (host clock,
    nearest rank), batches, the mean batch, padded rows, captures per
    bucket at warm-up (one each, none after), the device's idle share at
    the busiest level (kernel ms over wall ms), peak GiB.  Every request
    is accounted (completed + shed == submitted), every completed row
    equals the net's direct forward of a batch of its bucket's size bit
    for bit, and the first request after ``ready()`` captures nothing.
    Returns the phase's record and what the next phases reuse."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import deploy
    from mxnet_tpu_torch.gluon import _graph
    from mxnet_tpu_torch.parallel import functionalize
    from mxnet_tpu_torch.serving import ModelServer

    cfg = SERVE
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    net = _serve_net(ctx, seed)
    images = _serve_images(cfg["images"], cfg["image"], seed + 100)
    buckets = (1, 2, 4, 8, 16, 32)
    refs = _direct_rows(net, images, buckets)
    scale = float(np.abs(refs[32]).max())
    across = max(float(np.abs(refs[b] - refs[32]).max()) for b in buckets)
    path = os.path.join(workdir, "serve", "resnet50_v1.mxje")
    x32 = torch.zeros((cfg["batch"], 3, cfg["image"], cfg["image"]),
                      device=dev)
    t0 = time.perf_counter()
    deploy.export_model(net, x32, path)
    export_s = time.perf_counter() - t0

    res = {"phase": "serve_resnet50",
           "model": {"name": "resnet50_v1", "layout": "NCHW",
                     "classes": 1000, "weights": f"Xavier, seed {seed}"},
           "image": cfg["image"], "dtype": "float32 (TF32 off)",
           "slo_ms": cfg["slo_ms"], "requests_per_level": cfg["requests"],
           "artifact_bytes": os.path.getsize(path), "export_s": export_s,
           "across_buckets_max_abs": across,
           "across_buckets_rel_of_largest": across / scale,
           "across_buckets_tol": SERVE_ACROSS_BUCKETS_TOL}
    servers = {}
    # the artifact: one bucket, the artifact's batch
    c0 = _graph.captures
    t0 = time.perf_counter()
    srv = ModelServer.from_artifact(path, slo_ms=cfg["slo_ms"],
                                    coalesce_ms=cfg["coalesce_ms"],
                                    name="resnet50_artifact")
    srv.start(warm=True)
    warm_s = time.perf_counter() - t0
    c1 = _graph.captures
    check(srv.ready(), "serve_resnet50: artifact server not ready")
    first = srv.submit(images[0], deadline_ms=cfg["slo_ms"]).result(120)
    c2 = _graph.captures
    check(np.array_equal(first, refs[32][0]),
          "serve_resnet50: the first artifact row differs from the direct "
          "forward")
    art_refs = {32: refs[32]}
    servers["from_artifact"] = {
        "buckets": list(srv.buckets), "warm_start_s": warm_s,
        "captures_at_warmup": c1 - c0, "captures_first_request": c2 - c1,
        "warm_traces": srv.stats["warm_traces"],
        "levels": _serve_levels("serve_resnet50 artifact", srv, images,
                                art_refs)}
    servers["from_artifact"]["captures_after_warmup"] = _graph.captures - c1
    srv.close()
    check(c1 - c0 == 1 and _graph.captures == c1,
          f"serve_resnet50: artifact captures {c1 - c0} at warm-up, "
          f"{_graph.captures - c1} after (1 and 0 expected)")

    # the functionalized net through the micro-batch race's winner
    params, apply_fn = functionalize(net)
    ex = images[:cfg["batch"]]
    c0 = _graph.captures
    t0 = time.perf_counter()
    srv = ModelServer.from_predictor(
        apply_fn, params, ex, candidates=cfg["candidates"],
        tune_iters=cfg["tune_iters"], slo_ms=cfg["slo_ms"],
        coalesce_ms=cfg["coalesce_ms"], name="resnet50_predictor")
    race_s = time.perf_counter() - t0
    c_race = _graph.captures
    srv.start(warm=True)
    warm_s = time.perf_counter() - t0 - race_s
    c1 = _graph.captures
    first = srv.submit(images[0], deadline_ms=cfg["slo_ms"]).result(120)
    c2 = _graph.captures
    pred_refs = {b: refs[b] for b in srv.buckets}
    check(any(np.array_equal(first, r[0]) for r in pred_refs.values()),
          "serve_resnet50: the first predictor row differs from the direct "
          "forward")
    servers["from_predictor"] = {
        "winner": {"microbatch": srv.microbatch[0],
                   "unroll": srv.microbatch[1]},
        "buckets": list(srv.buckets), "race_s": race_s,
        "race_captures": c_race - c0, "warm_start_s": warm_s,
        "captures_at_warmup": c1 - c_race,
        "captures_first_request": c2 - c1,
        "warm_traces": srv.stats["warm_traces"],
        "levels": _serve_levels("serve_resnet50 predictor", srv, images,
                                pred_refs)}
    servers["from_predictor"]["captures_after_warmup"] = \
        _graph.captures - c1
    srv.close()
    # one program per bucket (the map form's chunk shapes differ too)
    check(c1 - c_race == len(srv.buckets) and _graph.captures == c1,
          f"serve_resnet50: predictor captures {c1 - c_race} at warm-up "
          f"for buckets {srv.buckets}, {_graph.captures - c1} after")
    res["servers"] = servers
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    check(across / scale <= SERVE_ACROSS_BUCKETS_TOL,
          f"serve_resnet50: rows across batch sizes {across / scale:.3g} "
          f"of the largest logit apart (> {SERVE_ACROSS_BUCKETS_TOL})")
    return res, {"net": net, "images": images, "refs": refs, "path": path}


def serve_http_phase(served):
    """``ServeFrontend`` over a ``from_artifact`` server on 127.0.0.1:
    ``/healthz`` 503 before ``start`` and 200 after; a handful of
    ``POST /v1/predict`` answered as ``submit`` answers (the direct
    forward's rows, bit for bit through JSON); ``/metrics`` with the
    ``serve_*`` rows; a request of the wrong shape answered 400
    ``bad_request`` and an impossible deadline 429 ``deadline``."""
    import numpy as np

    from mxnet_tpu_torch.serving import ModelServer, ServeFrontend
    from mxnet_tpu_torch.serving.frontend import http_call

    images, refs = served["images"], served["refs"]
    t_phase = time.perf_counter()
    srv = ModelServer.from_artifact(served["path"], slo_ms=SERVE["slo_ms"],
                                    coalesce_ms=SERVE["coalesce_ms"],
                                    name="resnet50")
    fe = ServeFrontend(srv, port=0).start()
    try:
        st_cold, h_cold = http_call("127.0.0.1", fe.port, "GET", "/healthz")
        srv.start(warm=True)
        st_warm, h_warm = http_call("127.0.0.1", fe.port, "GET", "/healthz")
        answers, lat = [], []
        for idx in (1, 2, 3, (4, 5)):
            rows = [idx] if isinstance(idx, int) else list(idx)
            t0 = time.perf_counter()
            st, body = http_call("127.0.0.1", fe.port, "POST",
                                 "/v1/predict",
                                 {"inputs": images[rows].tolist(),
                                  "deadline_ms": SERVE["slo_ms"]},
                                 timeout=120.0)
            lat.append((time.perf_counter() - t0) * 1e3)
            via_submit = [srv.submit(images[i]).result(120) for i in rows]
            out = np.asarray(body.get("outputs"), dtype="float32") \
                if st == 200 else None
            answers.append({
                "rows": rows, "status": st,
                "equal_submit": out is not None and all(
                    np.array_equal(o, s) for o, s in zip(out, via_submit)),
                "equal_direct": out is not None and all(
                    np.array_equal(o, refs[32][i])
                    for o, i in zip(out, rows))})
        st_m, metrics = http_call("127.0.0.1", fe.port, "GET", "/metrics")
        st_bad, bad = http_call("127.0.0.1", fe.port, "POST", "/v1/predict",
                                {"inputs": [[0.0, 1.0, 2.0]]})
        st_dl, dl = http_call("127.0.0.1", fe.port, "POST", "/v1/predict",
                              {"inputs": images[:1].tolist(),
                               "deadline_ms": 0.001}, timeout=60.0)
    finally:
        fe.close()
        srv.close()
    rows_m = [ln for ln in metrics.splitlines()
              if ln.startswith("mxnet_tpu_serve_")]
    res = {"phase": "serve_http", "healthz_before_start": st_cold,
           "healthz_after_start": st_warm, "predict": answers,
           "predict_ms_host": lat, "metrics_status": st_m,
           "metrics_rows": rows_m, "wrong_shape": [st_bad, bad],
           "impossible_deadline": [st_dl, dl],
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    check(st_cold == 503 and not h_cold["ready"],
          f"serve_http: /healthz before start {st_cold} {h_cold}")
    check(st_warm == 200 and h_warm["ready"],
          f"serve_http: /healthz after start {st_warm} {h_warm}")
    check(all(a["status"] == 200 and a["equal_submit"] and a["equal_direct"]
              for a in answers), f"serve_http: predict answers {answers}")
    check(st_m == 200 and any(r.startswith("mxnet_tpu_serve_requests ")
                              for r in rows_m)
          and "mxnet_tpu_serve_ready 1" in rows_m,
          f"serve_http: /metrics {st_m} {rows_m}")
    check(st_bad == 400 and bad.get("error") == "bad_request",
          f"serve_http: wrong shape answered {st_bad} {bad}")
    check(st_dl == 429 and dl.get("error") == "deadline",
          f"serve_http: impossible deadline answered {st_dl} {dl}")
    return res


def fleet_host_phase(workdir, served, seed=0):
    """One ``ModelHost`` on the card with a budget of its two residents'
    reserved bytes plus ``FLEET["headroom"]``: the ResNet-50 artifact and
    the wide generative decoder's (``deploy.export_generative``, served
    by ``GenerativeHostServer``, its prefills through the flash kernel);
    a third load past the budget raises ``ServeRejected("hbm_budget")``;
    the generative tokens equal a direct ``GenerativeServer``'s for the
    same prompts; ``swap`` replaces the ResNet-50 with an artifact of
    other weights under ``FLEET["swap_clients"]`` closed-loop clients
    (0 failed requests, every answer the old net's or the new net's
    direct row, the new one's once the swap returned); an armed
    ``fleet.swap`` fault refuses a swap before it loads anything, and a
    swap to an artifact whose probe fails (non-finite weights) rolls
    back, the model in place serving on.  Reserved bytes beside each
    model's measured peak while it loaded (and, for the ResNet-50, the
    bytes its captured graph's pool holds)."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import deploy
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.resilience import faultsim
    from mxnet_tpu_torch.serving import (GenerativeServer, ModelHost,
                                         ServeRejected, SwapRolledBack,
                                         artifact_reserved_bytes,
                                         toy_decoder_params)

    cfg = FLEET
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    t_phase = time.perf_counter()
    images, refs, old_path = served["images"], served["refs"], served["path"]
    x32 = torch.zeros((SERVE["batch"], 3, SERVE["image"], SERVE["image"]),
                      device=dev)
    new_net = _serve_net(ctx, seed + 1)
    new_path = os.path.join(workdir, "serve", "resnet50_v1_b.mxje")
    deploy.export_model(new_net, x32, new_path)
    new_refs = _direct_rows(new_net, images, (32,))[32]
    bad_net = _serve_net(ctx, seed + 2)
    w = next(iter(bad_net.collect_params().values()))
    w.set_data(mx.nd.full(w.shape, float("nan"), ctx=ctx))
    bad_path = os.path.join(workdir, "serve", "resnet50_v1_nan.mxje")
    deploy.export_model(bad_net, x32, bad_path)
    del new_net, bad_net
    wide = {k: v for k, v in WIDE_CFG.items()
            if k in ("vocab", "layers", "heads", "head_dim")}
    gen_params = toy_decoder_params(seed=0, device=dev, **wide)
    gen_path = os.path.join(workdir, "serve", "wide_decoder.mxje")
    t0 = time.perf_counter()
    deploy.export_generative(gen_params, gen_path,
                             prompt_buckets=WIDE_CFG["prompt_buckets"],
                             max_new=cfg["max_new"], **wide)
    gen_export_s = time.perf_counter() - t0
    gen_kw = dict(kv_dtype="float32", slots=WIDE_CFG["slots"],
                  page_tokens=WIDE_CFG["page_tokens"],
                  pool_budget=WIDE_CFG["pool_budget"],
                  slo_ms=WIDE_CFG["slo_ms"])
    r_resnet, _ = artifact_reserved_bytes(old_path)
    r_gen = sum(t.numel() * t.element_size() for t in
                [gen_params["embed"], gen_params["head"], gen_params["lnf"]]
                + [v for lyr in gen_params["layers"] for v in lyr.values()])
    budget = (r_resnet + r_gen) * (1 + cfg["headroom"])
    host = ModelHost(hbm_budget_mb=budget / 2 ** 20,
                     server_kw={"slo_ms": SERVE["slo_ms"],
                                "coalesce_ms": SERVE["coalesce_ms"]})
    res = {"phase": "fleet_host", "budget_bytes": host.budget_bytes,
           "generative_export_s": gen_export_s,
           "generative_artifact_bytes": os.path.getsize(gen_path)}
    try:
        measured = {}
        for name, path, kw in (("resnet50", old_path, {}),
                               ("decoder", gen_path, gen_kw)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if name == "decoder":
                flash_attention.launches = 0
            t0 = time.perf_counter()
            host.load(name, path, **kw)
            measured[name] = {
                "load_s": time.perf_counter() - t0,
                "peak_above_base_bytes":
                    torch.cuda.max_memory_allocated() - base,
                "resident_after_load_bytes":
                    torch.cuda.memory_allocated() - base}
            exp = getattr(host.get(name), "exported", None)
            if exp is not None:  # the captured graph's pool, in bytes
                measured[name]["graph_pool_bytes"] = sum(
                    prog.pool_bytes() or 0
                    for entry in exp.block._cached_op.values()
                    for prog in entry.programs)
        third = None
        try:
            host.load("third", new_path)
        except ServeRejected as e:
            third = e
        # the decoder's answers through the host, then a direct server's
        rng = np.random.RandomState(cfg["gen_seed"])
        prompts = [[int(t) for t in rng.randint(0, WIDE_CFG["vocab"], n)]
                   for n in cfg["prompt_lens"]]
        via_host = [host.submit(np.asarray(p), model="decoder")
                    .result(timeout=300) for p in prompts]
        flash = flash_attention.launches
        gen_st = host.get("decoder").stats
        direct = GenerativeServer(
            params=gen_params, prompt_buckets=WIDE_CFG["prompt_buckets"],
            max_new=cfg["max_new"], device=dev, **wide, **gen_kw)
        direct.start(warm=True)
        try:
            via_direct = [direct.submit(p).result(timeout=300)
                          for p in prompts]
        finally:
            direct.close()
        del direct
        # the swap under load
        stop = threading.Event()
        lock = threading.Lock()
        outcomes = []
        swap_done = [None]

        def client(k):
            i = k
            while not stop.is_set():
                idx = i % len(images)
                i += cfg["swap_clients"]
                t_sub = time.perf_counter()
                try:
                    row = host.submit(images[idx], model="resnet50").result(
                        timeout=120)
                    rec = (idx, row, None, t_sub)
                except Exception as e:  # every failure is counted
                    rec = (idx, None, repr(e), t_sub)
                with lock:
                    outcomes.append(rec)

        ts = [threading.Thread(target=client, args=(k,))
              for k in range(cfg["swap_clients"])]
        for t in ts:
            t.start()
        time.sleep(1.0)
        swap_ms = host.swap("resnet50", new_path)
        swap_done[0] = time.perf_counter()
        time.sleep(1.0)
        stop.set()
        for t in ts:
            t.join()
        failed = [o for o in outcomes if o[1] is None]
        old_rows = sum(np.array_equal(o[1], refs[32][o[0]])
                       for o in outcomes if o[1] is not None)
        new_rows = sum(np.array_equal(o[1], new_refs[o[0]])
                       for o in outcomes if o[1] is not None)
        after = [o for o in outcomes if o[1] is not None
                 and o[3] > swap_done[0]]
        after_new = sum(np.array_equal(o[1], new_refs[o[0]]) for o in after)
        # an armed fleet.swap fault refuses the swap before it loads;
        # a swap whose probe fails rolls back
        faultsim.reset("fleet.swap:raise@1")
        refused = None
        try:
            host.swap("resnet50", bad_path)
        except faultsim.FaultInjected as e:
            refused = repr(e)
        finally:
            faultsim.reset("")
        rolled = None
        try:
            host.swap("resnet50", bad_path)
        except SwapRolledBack as e:
            rolled = str(e)
        kept = host.submit(images[7], model="resnet50").result(timeout=120)
        residency = host.residency()
        host_stats = dict(host.stats)
    finally:
        host.close_all()
    res.update({
        "reserved_bytes": {n: m["reserved_bytes"]
                           for n, m in residency["models"].items()},
        "reserved_at_admission": {"resnet50": r_resnet, "decoder": r_gen},
        "measured": measured, "third_load": repr(third),
        "generative": {"prompts": [len(p) for p in prompts],
                       "tokens_host": via_host,
                       "tokens_equal_direct": via_host == via_direct,
                       "flash_launches": flash,
                       "prefills": gen_st.get("prefills")},
        "flash_launches": flash,
        "swap": {"ms": swap_ms, "clients": cfg["swap_clients"],
                 "requests": len(outcomes), "failed": len(failed),
                 "failures": [o[2] for o in failed[:3]],
                 "old_rows": int(old_rows), "new_rows": int(new_rows),
                 "after_swap": len(after), "after_swap_new": int(after_new)},
        "fault_refused": refused, "rolled_back": rolled,
        "kept_serving_equal_new": bool(np.array_equal(kept, new_refs[7])),
        "host_stats": host_stats,
        "seconds": time.perf_counter() - t_phase})
    emit(res)
    log(f"[fleet_host] budget {host.budget_bytes} bytes, reserved "
        f"{res['reserved_bytes']}, measured {measured}, swap "
        f"{swap_ms:.1f} ms under {cfg['swap_clients']} clients, "
        f"{len(outcomes)} requests, {len(failed)} failed, flash {flash}")
    check(third is not None and third.reason == "hbm_budget",
          f"fleet_host: a third load past the budget gave {third!r}")
    check(via_host == via_direct,
          f"fleet_host: decoder tokens {via_host} != direct {via_direct}")
    check(flash >= len(prompts) * WIDE_CFG["layers"],
          f"fleet_host: {flash} flash launches")
    check(not failed, f"fleet_host: {len(failed)} failed requests in the "
                      f"swap: {res['swap']['failures']}")
    check(old_rows + new_rows == len(outcomes),
          f"fleet_host: {len(outcomes) - old_rows - new_rows} answers equal "
          "neither net's direct row")
    check(after and after_new == len(after),
          f"fleet_host: {len(after) - after_new} of {len(after)} answers "
          "after the swap are not the new net's")
    check(refused is not None and rolled is not None
          and host_stats["rollbacks"] == 1 and host_stats["swaps"] == 1
          and res["kept_serving_equal_new"],
          f"fleet_host: refusal {refused}, rollback {rolled}, stats "
          f"{host_stats}, kept serving {res['kept_serving_equal_new']}")
    return res


# --------------------------------------- quantized and mixed precision
#: the quantized ResNet-50: 4 seeded calibration batches of 32
#: (``naive``), the race's iterations per arm, the fp8 products' bound
#: (largest |difference| from the plain dequantized fp32 product of the
#: same e4m3 values, over its largest |value|); the AMP step's settings
QUANT = dict(calib_batches=4, calib_batch=32, calib_seed=300,
             tune_iters=4, fp8_product_tol=1e-3)
#: the reference drill's small net and corpus
#: (``tests/test_quantization.py:612``): 4 classes of 3x16x16
#: prototypes, 60 steps at batch 32, 4 calibration batches, entropy
QUANT_DRILL = dict(classes=4, item=(3, 16, 16), steps=60, batch=32,
                   corpus=4, lr=0.2, seed=42, min_agreement=0.99)
AMP_RESNET = dict(batch=128, image=224, warmup=2, steps=5, fp32_steps=3,
                  opt=dict(learning_rate=0.1, momentum=0.9, wd=1e-4))


def _by_kind(net):
    """The quantized wrappers of ``net`` the product checks take: the
    7x7 stem, the first 3x3 conv (56²), the first 1x1 conv to 256
    channels (56²) and the final Dense."""
    from mxnet_tpu_torch.quantization import (QuantizedConv,
                                              QuantizedDense,
                                              quantized_layers)

    ws = quantized_layers(net)
    convs = [w for w in ws if isinstance(w, QuantizedConv)]
    return {
        "conv1_7x7": next(w for w in convs
                          if w._conv_kw["kernel"] == (7, 7)),
        "conv_3x3_56": next(w for w in convs
                            if w._conv_kw["kernel"] == (3, 3)),
        "conv_1x1_56": next(w for w in convs
                            if w._conv_kw["kernel"] == (1, 1)
                            and w._conv_kw["num_filter"] == 256),
        "dense": next(w for w in ws if isinstance(w, QuantizedDense)),
    }


def _product_checks(net, batch, seed):
    """At the real shapes (``batch``): the card's int32 accumulators of
    each layer of :func:`_by_kind` against the host's exact result (a
    float64 product of the same int8 codes, exact below 2^53), bit for
    bit; the whole quantized op (bias and range included) on the card
    against the host's at batch 2; the fp8 products against the plain
    dequantized-fp32 product of the same e4m3 values (TF32 off)."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import quantization_ops as Q

    g = torch.Generator(device="cuda").manual_seed(seed)
    inputs = {"conv1_7x7": (3, 224), "conv_3x3_56": (64, 56),
              "conv_1x1_56": (64, 56), "dense": (2048, None)}
    out = {}
    for name, w in _by_kind(net).items():
        ch, side = inputs[name]
        shape = (batch, ch, side, side) if side else (batch, ch)
        x = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
        xf = torch.randn(shape, generator=g, device="cuda") * 100
        x8 = xf.clamp(-448, 448).to(torch.float8_e4m3fn)
        scale = torch.full((), 3.5e-5, device="cuda")
        if side:
            kw = {k: w._conv_kw[k] for k in ("kernel", "stride", "pad",
                                              "dilate", "num_group")}
            acc = Q._conv_product(x, w._wq, Q._int8_gemm, **kw)
            exact = F.conv2d(x.cpu().double(), w._wq.cpu().double(),
                             stride=kw["stride"], padding=kw["pad"],
                             dilation=kw["dilate"], groups=kw["num_group"])
            f8 = Q._conv_product(x8, w._w8,
                                 lambda a, b: Q._fp8_gemm(a, b, scale), **kw)
            plain = F.conv2d(x8.float(), w._w8.float(), stride=kw["stride"],
                             padding=kw["pad"], dilation=kw["dilate"],
                             groups=kw["num_group"]) * scale
            op, op_kw = Q.quantized_conv, dict(no_bias=w._no_bias,
                                               **w._conv_kw)
        else:
            acc = Q._int8_gemm(x, w._wq)
            exact = x.cpu().double() @ w._wq.cpu().double().t()
            f8 = Q._fp8_gemm(x8, w._w8, scale)
            plain = (x8.float() @ w._w8.float().t()) * scale
            op, op_kw = Q.quantized_fully_connected, dict(
                num_hidden=w._units, no_bias=w._no_bias, flatten=True)
        ranges = [torch.tensor([v], device="cuda") for v in
                  (-2.5, 3.0)] + [w._wmin, w._wmax, w._bmin, w._bmax]
        card_op = op(x[:2], w._wq, w._bq, *ranges, **op_kw)
        host_op = op(x[:2].cpu(), w._wq.cpu(), w._bq.cpu(),
                     *[r.cpu() for r in ranges], **op_kw)
        torch.cuda.synchronize()
        exact_int = torch.equal(acc.cpu().to(torch.int64),
                                exact.round().to(torch.int64))
        op_equal = all(torch.equal(a.cpu(), b)
                       for a, b in zip(card_op, host_op))
        f8_rel = float((f8 - plain).abs().max()
                       / plain.abs().max().clamp_min(1e-30))
        out[name] = {"input": list(shape),
                     "weight": list(w._wq.shape),
                     "int32_equal_host_exact": exact_int,
                     "op_at_batch_2_equal_host": op_equal,
                     "acc_abs_max": int(acc.abs().max()),
                     "fp8_rel_to_plain": f8_rel}
        log(f"[quantize_resnet50] {name} {list(shape)}: int32 = host "
            f"exact {exact_int}, op = host {op_equal}, fp8 rel "
            f"{f8_rel:.3e}")
    return out


def _direct_rows_f32(net, images, batch):
    """Each image's row of the net's direct forward in batches of
    ``batch``, as float32 numpy (a bf16 net's logits widened)."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    rows = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(images[i:i + batch]).to("cuda")
            rows.append(net(mx.nd.NDArray(x))._data.float().cpu().numpy())
    return np.concatenate(rows)


def _agreement(rows, ref):
    import numpy as np

    return {"top1_agreement": float((rows.argmax(1)
                                     == ref.argmax(1)).mean()),
            "max_rel_logit_err": float(np.abs(rows - ref).max()
                                       / np.abs(ref).max())}


def quantize_resnet50_phase(workdir, served, seed=0):
    """The zoo's ``resnet50_v1()`` (``serve_resnet50``'s fp32 weights)
    calibrated (``naive``, 4 seeded batches of 32), rewritten by
    ``quantize_net`` (every Conv2D and the Dense int8 wrappers,
    BatchNorm fp32), its int8 and fp8 products checked at their real
    shapes (:func:`_product_checks`), the arms raced by
    ``tune_quantized`` on the card (timings and winners printed,
    whatever they are), then exported three ways: int8 and fp8 under
    ``autotune.force`` (the reference's drill), and the fp32 net
    converted by ``contrib.amp.convert_hybrid_block(net, "bfloat16")``
    under ``amp.init``.  Each arm's direct rows at batch 32 (the
    served bucket), top-1 agreement with the fp32 net and the largest
    relative logit error are recorded."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune, deploy, quantization
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import quantization_ops as Q

    cfg = QUANT
    ctx = mx.gpu(0)
    t_phase = time.perf_counter()
    images, refs32 = served["images"], served["refs"][32]
    net = _serve_net(ctx, seed)
    rs = np.random.RandomState(cfg["calib_seed"])
    calib = [rs.randn(cfg["calib_batch"], 3, SERVE["image"],
                      SERVE["image"]).astype("float32")
             for _ in range(cfg["calib_batches"])]
    t0 = time.perf_counter()
    cal = quantization.calibrate(net, calib, mode="naive",
                                 num_batches=cfg["calib_batches"])
    calib_s = time.perf_counter() - t0
    quantization.quantize_net(net, cal)
    wrappers = quantization.quantized_layers(net)
    kinds = {}
    for w in wrappers:
        kinds[type(w).__name__] = kinds.get(type(w).__name__, 0) + 1
    norms = sum(type(m).__name__ == "BatchNorm" for m in net.modules())
    t0 = time.perf_counter()
    products = _product_checks(net, SERVE["batch"], seed + 7)
    products_s = time.perf_counter() - t0
    x32 = torch.from_numpy(images[:SERVE["batch"]]).to("cuda")
    t0 = time.perf_counter()
    race = quantization.tune_quantized(net, mx.nd.NDArray(x32),
                                       iters=cfg["tune_iters"])
    race_s = time.perf_counter() - t0
    for op, r in race.items():
        log(f"[quantize_resnet50] race {op}: winner {r['winner']}, "
            f"ms {({k: round(v * 1e3, 3) for k, v in r['timings'].items()})}")
    # where one eager batch-32 forward of each arm spends the device
    forward = {}
    for arm, value in (("fp32", False), ("int8", True), ("fp8", "fp8")):
        with autotune.force(quantized_conv=value, quantized_fc=value), \
                torch.no_grad():
            net(mx.nd.NDArray(x32))
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                t0 = time.perf_counter()
                net(mx.nd.NDArray(x32))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        forward[arm] = device_profile(prof, wall, top=8, shares={
            "gemm": ("gemm", "Gemm", "xmma", "cutlass", "sm90"),
            "elementwise": ("elementwise", "vectorized", "unrolled")})
        log(f"[quantize_resnet50] eager forward {arm}: wall "
            f"{wall * 1e3:.2f} ms, device busy "
            f"{forward[arm].get('device_busy_ms')} ms")
    arms, paths = {}, {}
    for arm, value in (("int8", True), ("fp8", "fp8")):
        with autotune.force(quantized_conv=value, quantized_fc=value):
            Q.reset_counts()
            rows = _direct_rows_f32(net, images, SERVE["batch"])
            gemms = Q.counts()
            path = os.path.join(workdir, "serve", f"resnet50_v1_{arm}.mxje")
            t0 = time.perf_counter()
            deploy.export_model(net, x32, path)
            arms[arm] = {"export_s": time.perf_counter() - t0,
                         "direct_forward_gemms": gemms}
        paths[arm] = path
        arms[arm].update(rows=rows, **_agreement(rows, refs32))
    bf = _serve_net(ctx, seed)
    amp.convert_hybrid_block(bf, "bfloat16")
    amp.init("bfloat16")
    try:
        rows = _direct_rows_f32(bf, images, SERVE["batch"])
        path = os.path.join(workdir, "serve", "resnet50_v1_bf16.mxje")
        t0 = time.perf_counter()
        deploy.export_model(bf, x32, path)
        arms["bf16"] = {"export_s": time.perf_counter() - t0}
    finally:
        amp._off()
    paths["bf16"] = path
    arms["bf16"].update(rows=rows, **_agreement(rows, refs32))
    del bf
    headers = {a: deploy.read_artifact_meta(p) for a, p in paths.items()}
    for a in arms:
        arms[a]["artifact_bytes"] = os.path.getsize(paths[a])
        arms[a]["header"] = {k: headers[a].get(k) for k in (
            "quantized", "quantized_layers", "param_dtypes")}
        log(f"[quantize_resnet50] {a}: header {arms[a]['header']}, "
            f"agreement {arms[a]['top1_agreement']:.4f}, rel logit err "
            f"{arms[a]['max_rel_logit_err']:.3e}, "
            f"{arms[a]['artifact_bytes']} bytes")
    res = {"phase": "quantize_resnet50",
           "model": {"name": "resnet50_v1", "layout": "NCHW",
                     "classes": 1000, "weights": f"Xavier, seed {seed}"},
           "calibration": {"mode": "naive", "batches": cfg["calib_batches"],
                           "batch": cfg["calib_batch"], "layers": len(cal),
                           "seconds": calib_s},
           "wrappers": kinds, "batchnorm_fp32": norms,
           "products": products, "products_s": products_s,
           "fp8_product_tol": cfg["fp8_product_tol"],
           "race": race, "race_s": race_s, "eager_forward_32": forward,
           "arms": {a: {k: v for k, v in r.items() if k != "rows"}
                    for a, r in arms.items()},
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    check(kinds.get("QuantizedConv") == 53 and kinds.get("QuantizedDense")
          == 1, f"quantize_resnet50: wrappers {kinds}")
    check(all(p["int32_equal_host_exact"] and p["op_at_batch_2_equal_host"]
              for p in products.values()),
          f"quantize_resnet50: int8 products differ from the host's: "
          f"{products}")
    check(all(p["fp8_rel_to_plain"] <= cfg["fp8_product_tol"]
              for p in products.values()),
          f"quantize_resnet50: fp8 products beyond "
          f"{cfg['fp8_product_tol']} of the plain product")
    check(set(race) == {"quantized_conv", "quantized_fc"},
          f"quantize_resnet50: the race reported {sorted(race)}")
    check(arms["int8"]["direct_forward_gemms"]["int_mm"] == 54 * 2
          and arms["fp8"]["direct_forward_gemms"]["scaled_mm"] == 54 * 2,
          f"quantize_resnet50: GEMM launches int8 "
          f"{arms['int8']['direct_forward_gemms']}, fp8 "
          f"{arms['fp8']['direct_forward_gemms']} (54 layers x 2 batches)")
    for a, want in (("int8", "int8"), ("fp8", "float8_e4m3fn")):
        h = arms[a]["header"]
        check(h["quantized"] is True and h["quantized_layers"] == 54
              and h["param_dtypes"].get(want, 0) >= 54,
              f"quantize_resnet50: {a} header {h}")
    check(arms["bf16"]["header"]["param_dtypes"].get("bfloat16", 0) > 0
          and arms["bf16"]["header"]["quantized"] is False,
          f"quantize_resnet50: bf16 header {arms['bf16']['header']}")
    return res, {"net": net, "paths": paths, "images": images,
                 "refs": {a: r["rows"] for a, r in arms.items()},
                 "refs32": refs32, "fp32_path": served["path"]}


def _drill_on_card(workdir):
    """The reference's drill (``tests/test_quantization.py:612``) on the
    card: a small net trained by the Gluon loop, calibrated
    (``entropy``), rewritten, exported under the int8 force scope and
    served from the artifact; top-1 agreement with the fp32 net over
    the calibration corpus."""
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, autotune, deploy, gluon
    from mxnet_tpu_torch import quantization
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import ModelServer

    cfg = QUANT_DRILL
    rng = np.random.RandomState(cfg["seed"])
    protos = rng.rand(cfg["classes"], *cfg["item"]).astype("float32")

    def make_batch(n):
        y = rng.randint(0, cfg["classes"], n)
        return ((protos[y] + 0.15 * rng.rand(n, *cfg["item"]))
                .astype("float32"), y.astype("float32"))

    ctx = mx.gpu(0)
    np.random.seed(cfg["seed"])
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
                nn.Dense(cfg["classes"], in_units=8 * 8 * 8))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(cfg["steps"]):
        xb, yb = make_batch(cfg["batch"])
        x, y = mx.nd.array(xb, ctx=ctx), mx.nd.array(yb, ctx=ctx)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(cfg["batch"])
    corpus = [make_batch(cfg["batch"])[0] for _ in range(cfg["corpus"])]
    fp32 = np.concatenate([net(mx.nd.array(b, ctx=ctx)).asnumpy()
                           for b in corpus])
    cal = quantization.calibrate(net, corpus, mode="entropy",
                                 num_batches=cfg["corpus"])
    quantization.quantize_net(net, cal)
    path = os.path.join(workdir, "serve", "drill_int8.mxje")
    with autotune.force(quantized_conv=True, quantized_fc=True):
        deploy.export_model(net, corpus[0], path)
    srv = ModelServer.from_artifact(path, slo_ms=30000.0, coalesce_ms=1.0,
                                    name="drill_int8")
    srv.start(warm=True)
    try:
        hs = [srv.submit(x) for x in np.concatenate(corpus)]
        served = np.stack([np.asarray(h.result(timeout=120)) for h in hs])
    finally:
        srv.close()
    torch.cuda.synchronize()
    agreement = float((served.argmax(1) == fp32.argmax(1)).mean())
    return {"agreement": agreement, "rows": int(served.shape[0]),
            "header": {k: deploy.read_artifact_meta(path).get(k) for k in
                       ("quantized", "quantized_layers", "param_dtypes")}}


def serve_resnet50_int8_phase(workdir, quant):
    """The int8, fp8 and bf16 artifacts of ``quantize_resnet50`` served
    by ``ModelServer.from_artifact`` (one captured graph, the bucket of
    32, as ``serve_resnet50`` serves the fp32 net), each driven by
    ``_serve_levels``'s closed loop at 1, 8, 32 and 64 clients
    (req/s, p50, p99, the idle share at 64; every row equal to the
    direct forward of its arm at batch 32, bit for bit); then a
    ``ModelHost`` holding the fp32 artifact beside the int8 and fp8
    ones (and the bf16 one), its residency report read; then the
    reference's drill on the card (agreement >= 0.99)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.gluon import _graph
    from mxnet_tpu_torch.ops import quantization_ops as Q
    from mxnet_tpu_torch.serving import ModelHost, ModelServer

    t_phase = time.perf_counter()
    images, paths = quant["images"], quant["paths"]
    servers = {}
    for arm in ("int8", "fp8", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c0 = _graph.captures
        t0 = time.perf_counter()
        Q.reset_counts()
        srv = ModelServer.from_artifact(
            paths[arm], slo_ms=SERVE["slo_ms"],
            coalesce_ms=SERVE["coalesce_ms"], name=f"resnet50_{arm}")
        srv.start(warm=True)
        warm_s = time.perf_counter() - t0
        c1 = _graph.captures
        # the GEMMs the captured program holds (counted where the ops
        # ran: warm-up and capture; a replay runs them again unseen)
        gemms = Q.counts()
        levels = _serve_levels(f"serve_resnet50_{arm}", srv, images,
                               {32: quant["refs"][arm]})
        servers[arm] = {
            "buckets": list(srv.buckets), "warm_start_s": warm_s,
            "captures_at_warmup": c1 - c0,
            "captures_after_warmup": _graph.captures - c1,
            "gemm_calls_warmup_and_capture": gemms,
            "peak_above_base_bytes":
                torch.cuda.max_memory_allocated() - base,
            "levels": levels}
        srv.close()
        check(c1 - c0 == 1 and _graph.captures == c1,
              f"serve_resnet50_{arm}: captures {c1 - c0} at warm-up, "
              f"{_graph.captures - c1} after (1 and 0 expected)")
        torch.cuda.empty_cache()
    host = ModelHost(server_kw={"slo_ms": SERVE["slo_ms"],
                                "coalesce_ms": SERVE["coalesce_ms"]})
    try:
        t0 = time.perf_counter()
        for name, path in (("fp32", quant["fp32_path"]),
                           ("int8", paths["int8"]), ("fp8", paths["fp8"]),
                           ("bf16", paths["bf16"])):
            host.load(name, path)
        load_s = time.perf_counter() - t0
        answers = {name: host.submit(images[3], model=name).result(
            timeout=120) for name in ("fp32", "int8", "fp8", "bf16")}
        residency = host.residency()
    finally:
        host.close_all()
    resident = {n: {"quantized": m["quantized"],
                    "param_dtypes": m["param_dtypes"]}
                for n, m in residency["models"].items()}
    log(f"[serve_resnet50_int8] ModelHost residency {resident}")
    drill = _drill_on_card(workdir)
    log(f"[serve_resnet50_int8] drill agreement {drill['agreement']:.4f} "
        f"over {drill['rows']} rows, header {drill['header']}")
    res = {"phase": "serve_resnet50_int8",
           "slo_ms": SERVE["slo_ms"], "requests_per_level":
               SERVE["requests"], "servers": servers,
           "model_host": {"load_s": load_s, "residency": resident,
                          "answers_equal_direct": {
                              a: bool(np.array_equal(answers[a],
                                                     quant["refs"][a][3]))
                              for a in ("int8", "fp8", "bf16")}},
           "drill": drill, "seconds": time.perf_counter() - t_phase}
    emit(res)
    check(resident["int8"]["quantized"] is True
          and resident["fp8"]["quantized"] is True
          and resident["fp32"]["quantized"] is False,
          f"serve_resnet50_int8: residency {resident}")
    check(all(res["model_host"]["answers_equal_direct"].values()),
          f"serve_resnet50_int8: ModelHost answers "
          f"{res['model_host']['answers_equal_direct']}")
    # 54 layers, each run in the graph's warm-up passes and its capture
    for arm, kind in (("int8", "int_mm"), ("fp8", "scaled_mm")):
        n = servers[arm]["gemm_calls_warmup_and_capture"][kind]
        check(n > 0 and n % 54 == 0,
              f"serve_resnet50_int8: the {arm} program holds {n} {kind} "
              f"calls (a multiple of 54 expected)")
    check(drill["agreement"] >= QUANT_DRILL["min_agreement"],
          f"serve_resnet50_int8: drill agreement {drill['agreement']}")
    return res


def amp_gluon_resnet50_phase(gres, seed=0):
    """``gluon_resnet50``'s net (fp32 weights, the unfused tail) trained
    by the Gluon loop under ``amp.init("bfloat16")`` with the Trainer's
    loss scaler (``init_trainer`` + ``scale_loss``): warm-up, timed
    steps (ms/step by CUDA events), then one step whose gradient is
    planted non-finite, which the Trainer must skip (every parameter
    unchanged) with the scale halved; and the same net's fp32 steps
    without AMP for comparison, beside ``gluon_resnet50``'s bf16-cast
    ms/step."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, autotune, gluon
    from mxnet_tpu_torch.contrib import amp

    cfg = AMP_RESNET
    batch = cfg["batch"]
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    net = gluon_resnet50(ctx, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = mx.nd.NDArray(torch.randn((batch, cfg["image"], cfg["image"], 3),
                                  generator=gen, device=dev))
    y = mx.nd.NDArray(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev, dtype=torch.int32))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(cfg["opt"]))
    amp.init_trainer(trainer)
    params = list(net.collect_params().values())

    def step(plant=False):
        with autograd.record():
            with amp.scale_loss(loss_fn(net(x), y), trainer) as scaled:
                scaled.backward()
        if plant:
            g = params[0]._wrap()._grad
            g._data.view(-1)[0] = float("inf")
        trainer.step(batch)
        return scaled

    def timed(fn, n):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        marks[0].record()
        out = []
        for i in range(n):
            out.append(fn())
            marks[i + 1].record()
        marks[-1].synchronize()
        return marks[0].elapsed_time(marks[-1]) / n, out

    torch.cuda.reset_peak_memory_stats()
    amp.init("bfloat16")
    try:
        with autotune.force(pallas_bnreluconv="stock"):
            for _ in range(cfg["warmup"]):
                step()
            scales = [trainer._amp_loss_scaler.loss_scale]
            ms_amp, outs = timed(step, cfg["steps"])
            losses = [float(o._data.float().mean())
                      / trainer._amp_loss_scaler.loss_scale for o in outs]
            conv_dtype = net(x)._data.dtype
            # the trained parameters (a training forward moves the
            # BatchNorm statistics, skipped update or not)
            trained = [p for p in params if p.grad_req != "null"]
            before = [p.data()._data.clone() for p in trained]
            scale_before = trainer._amp_loss_scaler.loss_scale
            step(plant=True)
            torch.cuda.synchronize()
            unchanged = all(torch.equal(b, p.data()._data)
                            for b, p in zip(before, trained))
            scale_after = trainer._amp_loss_scaler.loss_scale
            step()  # the step after the skip trains again
            torch.cuda.synchronize()
            moved = sum(not torch.equal(b, p.data()._data)
                        for b, p in zip(before, trained))
    finally:
        amp._off()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fp32_trainer = gluon.Trainer(net.collect_params(), "sgd",
                                 dict(cfg["opt"]))

    def fp32_step():
        return _gluon_loss_step(net, fp32_trainer, x, y)

    with autotune.force(pallas_bnreluconv="stock"):
        fp32_step()
        ms_fp32, _ = timed(fp32_step, cfg["fp32_steps"])
    res = {"phase": "amp_gluon_resnet50",
           "model": {"name": "resnet50_v1", "layout": "NHWC",
                     "no_bias": True, "tail": "stock (unfused)"},
           "batch": batch, "image": cfg["image"],
           "amp": {"target_dtype": "bfloat16", "logits_dtype":
                   str(conv_dtype).replace("torch.", "")},
           "ms_per_step": ms_amp, "img_s": batch / ms_amp * 1e3,
           "fp32_ms_per_step_same_net": ms_fp32,
           "gluon_resnet50_bf16_cast_ms_per_step": gres["ms_per_step"],
           "loss_scale_after_warmup": scales[0],
           "losses_unscaled": losses,
           "planted_overflow": {"scale_before": scale_before,
                                "scale_after": scale_after,
                                "trained_parameters_unchanged": unchanged,
                                "trained_parameters_moved_next_step":
                                    f"{moved} of {len(trained)}"},
           "peak_mem_gib": peak}
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"amp_gluon_resnet50: losses {losses}")
    check(unchanged and scale_after == scale_before / 2,
          f"amp_gluon_resnet50: the planted overflow was not skipped "
          f"(unchanged {unchanged}, scale {scale_before} -> {scale_after})")
    check(moved > 0, "amp_gluon_resnet50: the step after the skip moved "
                     "nothing")
    check(conv_dtype == torch.bfloat16,
          f"amp_gluon_resnet50: logits {conv_dtype} under AMP")
    return res


# --------------------------------------------------------- telemetry
#: the observed ResNet-50 step: ``train_resnet50``'s configuration
#: (``TRAIN_PHASES``), four arms of 2 + 10 steps; the watchdog's
#: fire drill (timeout, quiet seconds); the replicated step under the
#: numerics monitor (steps after the warm-up, the sample period)
TELEMETRY = dict(warmup=2, steps=10, watchdog_sec=60.0, drill_timeout=0.5,
                 drill_quiet=1.5, nm_steps=6, nm_sample=2)
#: the telemetry arms: the env knobs each sets, and whether the profiler
#: runs with the device capture
TELEMETRY_ARMS = {
    "off": ({}, False),
    "runlog": ({"MXNET_RUNLOG": "runlog.jsonl"}, False),
    "runlog_sample1_watchdog_numerics": (
        {"MXNET_RUNLOG": "runlog_s1.jsonl", "MXNET_TELEMETRY_SAMPLE": "1",
         "MXNET_NUMERICS": "1"}, False),
    "runlog_sample1_watchdog_numerics_profiler": (
        {"MXNET_RUNLOG": "runlog_prof.jsonl", "MXNET_TELEMETRY_SAMPLE": "1",
         "MXNET_NUMERICS": "1"}, True),
}
#: FLOPs of the program report against the analytic 3 x forward
FLOPS_TOL = 0.10


@contextlib.contextmanager
def telemetry_env(workdir, env):
    """Set the telemetry knobs ``env`` (a run-log file name is put under
    ``workdir``), re-arm the run log from them, and restore both on
    exit."""
    from mxnet_tpu_torch import telemetry

    keys = ("MXNET_RUNLOG", "MXNET_TELEMETRY_SAMPLE", "MXNET_NUMERICS",
            "MXNET_NUMERICS_SAMPLE", "MXNET_WATCHDOG_SEC")
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    for k, v in env.items():
        os.environ[k] = os.path.join(workdir, v) if k == "MXNET_RUNLOG" \
            else v
    try:
        telemetry.reset()  # re-resolved from the knobs on first use
        yield telemetry.current()
    finally:
        telemetry.close()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def read_runlog(path):
    """(records, problems under the port's schema, count by type)."""
    from mxnet_tpu_torch.telemetry import schema

    with open(path) as f:
        recs, problems = schema.validate_lines(f)
    counts = {}
    for r in recs:
        counts[r["type"]] = counts.get(r["type"], 0) + 1
    return recs, problems, counts


def resnet50_forward_macs(net, device, image=224):
    """Multiply-accumulates of one image's forward, from the net's own
    layers: every convolution and dense layer's output elements times
    its weight's fan-in, read by forward hooks on a batch-1 forward of
    the unfused net (the fused tail's 1x1 conv then runs as a layer)."""
    import torch

    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.gluon.nn import Conv2D, Dense

    macs = [0]

    def hook(block, inputs, out):
        o = out._data if hasattr(out, "_data") else out
        w = block.weight
        w = w._tensor() if hasattr(w, "_tensor") else w
        # output elements of one image x the weight's fan-in
        macs[0] += (o.numel() // o.shape[0]) * (w.numel() // w.shape[0])

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (Conv2D, Dense))]
    try:
        x = torch.zeros((1, image, image, 3), device=device)
        with torch.no_grad(), autotune.force(pallas_bnreluconv="stock"):
            net(nd.NDArray(x))
    finally:
        for h in handles:
            h.detach()
    return macs[0]


def trace_top_and_gaps(path, top=10, scope=None):
    """The device operations that took the most time (by kernel name,
    summed) and the longest idle gaps of a ``torch.profiler`` Chrome
    trace, each named by the host work open at the time: a kernel by
    the host op that launched it (the trace's ``External id``) and the
    user scope open at its launch; a gap by the innermost host op and
    user scope open when it began.  ``scope`` keeps only the window from
    the first user scope of that name to the end of the last (the timed
    steps, with the boundaries between them)."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev = [e for e in evs if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in evs if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")]
    ops = {}
    for e in host:
        ext = (e.get("args") or {}).get("External id")
        if ext is not None and e.get("cat") in ("cpu_op",
                                                "user_annotation"):
            ops.setdefault(ext, e["name"])
    launch = {}
    for e in host:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launch[corr] = e["ts"]
    scopes = [e for e in host if e.get("cat") == "user_annotation"]
    if scope is not None:
        mine = [e for e in scopes if e["name"] == scope]
        lo = min(e["ts"] for e in mine)
        hi = max(e["ts"] + e.get("dur", 0) for e in mine)
        dev = [e for e in dev if lo <= e["ts"] and
               e["ts"] + e.get("dur", 0) <= hi]

    def open_at(t, pool):
        inner = None
        for e in pool:
            if e["ts"] <= t < e["ts"] + e.get("dur", 0):
                if inner is None or e.get("dur", 0) < inner.get("dur", 0):
                    inner = e
        return inner["name"] if inner else None

    by_name = {}
    for e in dev:
        row = by_name.setdefault(e["name"], {"ms": 0.0, "calls": 0,
                                             "ops": {}, "ts": []})
        row["ms"] += e.get("dur", 0) / 1e3
        row["calls"] += 1
        op = ops.get((e.get("args") or {}).get("External id"), "?")
        row["ops"][op] = row["ops"].get(op, 0) + 1
        corr = (e.get("args") or {}).get("correlation")
        if corr in launch and len(row["ts"]) < 1:
            row["ts"].append(launch[corr])
    busy_ms = sum(r["ms"] for r in by_name.values())
    top_ops = []
    for name, r in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[
            :top]:
        top_ops.append({
            "name": name[:96], "ms": r["ms"], "calls": r["calls"],
            "share": r["ms"] / busy_ms if busy_ms else None,
            "host_op": max(r["ops"], key=r["ops"].get),
            "host_span": open_at(r["ts"][0], scopes) if r["ts"] else None})
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    window_ms = (merged[-1][1] - merged[0][0]) / 1e3 if merged else 0.0
    idle_ms = sum(merged[i + 1][0] - merged[i][1]
                  for i in range(len(merged) - 1)) / 1e3
    cpu = [e for e in host if e.get("cat") != "user_annotation"]
    return {
        "scope": scope, "device_ops": len(dev), "host_events": len(host),
        "window_ms": window_ms, "device_busy_ms": busy_ms,
        "idle_ms_in_window": idle_ms,
        "top_device_ops": top_ops,
        # no host op open: the host was in Python between ops
        "top_idle_gaps": [{"ms": g / 1e3,
                           "host_op": open_at(t, cpu) or "(python)",
                           "host_span": open_at(t, scopes)}
                          for g, t in gaps]}


def _observed_steps(net, x, y, cfg, warmup, steps, wd=None, scope=None,
                    counters=None):
    """Build the kernel-arm step and drive it as a user loop records
    into the run log (``telemetry.FitSession``: a step record each
    step, the loss read on sampled steps); ``scope`` opens a profiler
    user scope around each step.  Returns (ms/step over the timed
    steps, losses, the build's warnings, the last state)."""
    import warnings

    import torch

    from mxnet_tpu_torch import parallel, profiler, telemetry
    from mxnet_tpu_torch.gluon import loss

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step_fn, params, state = parallel.make_train_step(
            net, loss.SoftmaxCrossEntropyLoss(), "sgd",
            mesh=parallel.get_mesh(), compute_dtype="bfloat16",
            loss_scale="dynamic", optimizer_sharding="ps",
            **TRAIN_PHASES["train_resnet50"]["opt"])
    session = telemetry.FitSession(telemetry.current(),
                                   batch_size=cfg["batch"],
                                   watchdog=wd if wd is not None else False)
    dom = profiler.Domain("train")
    carry = [params, state]
    # the timed steps' scope; the warm-up steps (the first a miss the
    # program report describes) open their own
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            start.record()
        session.step_begin()
        cm = dom.new_task(scope if i >= warmup else "warmup_step") \
            if scope else contextlib.nullcontext()
        with cm:
            lv, carry[0], carry[1] = step_fn(*carry, x, y, None,
                                             float(i + 1))
        synced = session.should_sync()
        session.step_end(0, i, loss=float(lv) if synced else None,
                         synced=synced)
        losses.append(lv)
    end.record()
    end.synchronize()
    session.finish()
    return (start.elapsed_time(end) / steps, [float(v) for v in losses],
            [str(w.message) for w in caught], carry[1])


def telemetry_resnet50_phase(workdir, seed=0):
    """The kernel-arm ResNet-50 step of ``train_resnet50`` (batch 128,
    bf16, channel-last, both kernels forced) driven as a user loop that
    records into the run log, in four arms of 2 + 10 steps: nothing
    armed; ``MXNET_RUNLOG`` at the default sampling; sampling 1 with a
    watchdog beaten every step and ``MXNET_NUMERICS=1`` (which the
    sharded-bucket step must warn about and turn off); that with the
    profiler running and ``profile_device=True``.  Each armed run log
    must validate under the port's schema with the expected records;
    the step's ``program_report`` FLOPs must lie within 10 % of the
    analytic 3 x forward count from the net's own layers; the device
    capture's top operations and longest idle gaps are named by the host
    work open at the time.  Then the watchdog fires on a quiet heartbeat
    (its stack file and record checked), and the same net built as the
    replicated step records ``tensor_stats`` under the numerics monitor
    (no non-finite count), its ms/step with the monitor on and off."""
    import torch

    from mxnet_tpu_torch import autotune, parallel, profiler, telemetry
    from mxnet_tpu_torch.gluon import loss
    from mxnet_tpu_torch.ops import pallas_conv as pc
    from mxnet_tpu_torch.telemetry.watchdog import (Watchdog,
                                                    stack_path_for)

    t_phase = time.perf_counter()
    cfg = TRAIN_PHASES["train_resnet50"]
    tc = TELEMETRY
    counters = bucket_counters("sgd")
    dev = torch.device("cuda", 0)
    net = resnet50(dev, seed, cfg["net"])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x, y = image_batch(cfg["batch"], cfg["net"], gen, dev)
    macs = resnet50_forward_macs(net, dev)
    analytic = 3 * 2 * macs * cfg["batch"]
    tdir = os.path.join(workdir, "telemetry")
    os.makedirs(tdir, exist_ok=True)
    pc.bnreluconv_bwd.launches = 0
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    n_steps = 0
    arms = {}
    with autotune.force(pallas_bnreluconv="pallas", fused_bucket_opt=True):
        for arm, (env, prof_on) in TELEMETRY_ARMS.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with telemetry_env(tdir, env) as rl:
                wd = Watchdog(timeout=tc["watchdog_sec"]) \
                    if "watchdog" in arm else None
                trace = None
                if prof_on:
                    profiler.set_config(
                        profile_device=True, filename=os.path.join(
                            tdir, "host_trace.json"),
                        tensorboard_logdir=os.path.join(tdir, "tb"))
                    profiler.set_state("run")
                try:
                    ms, losses, warns, _ = _observed_steps(
                        net, x, y, cfg, tc["warmup"], tc["steps"], wd=wd,
                        scope="train_step" if prof_on else None)
                finally:
                    if prof_on:
                        profiler.set_state("stop")
                        trace = profiler.device_trace_path()
                        profiler.dump()
                        profiler.set_config(profile_device=False)
                n_steps += tc["warmup"] + tc["steps"]
                peak = torch.cuda.max_memory_allocated()
                path = rl.path if rl is not None else None
            rec = {"ms_per_step": ms, "losses": losses, "warnings": warns,
                   "max_memory_allocated": peak}
            if path is not None:
                recs, problems, counts = read_runlog(path)
                rec.update(runlog_records=counts, schema_problems=problems)
                reps = [r for r in recs if r["type"] == "program_report"]
                check(len(reps) == 1, f"telemetry {arm}: program reports "
                      f"{len(reps)}")
                rep = reps[0]
                rec["program_report"] = {
                    "flops": rep["flops"], "analytic_flops": analytic,
                    "flops_over_analytic": rep["flops"] / analytic,
                    "memory": rep["memory"]}
                check(not problems, f"telemetry {arm}: schema problems "
                      f"{problems[:5]}")
                want_steps = tc["warmup"] + tc["steps"]
                sample = int(env.get("MXNET_TELEMETRY_SAMPLE", "25"))
                synced = sum(1 for i in range(want_steps)
                             if i % sample == 0)
                check(counts.get("step") == want_steps
                      and counts.get("compile") == 1
                      and counts.get("run_start") == 1
                      and counts.get("run_end") == 1
                      and counts.get("span") == synced
                      and counts.get("tensor_stats", 0) == 0
                      and counts.get("watchdog", 0) == 0,
                      f"telemetry {arm}: records {counts} (want "
                      f"{want_steps} steps, {synced} spans)")
                check(abs(rep["flops"] / analytic - 1.0) <= FLOPS_TOL,
                      f"telemetry {arm}: program FLOPs {rep['flops']:.4g}"
                      f" vs analytic {analytic:.4g}")
                check(rep["memory"]["peak_bytes"] <= peak
                      and rep["memory"]["argument_bytes"] > 0,
                      f"telemetry {arm}: memory {rep['memory']} vs "
                      f"max_memory_allocated {peak}")
            if "numerics" in arm:
                check(any("MXNET_NUMERICS under optimizer_sharding='ps'"
                          in w for w in warns),
                      f"telemetry {arm}: no numerics warning: {warns}")
            if trace is not None:
                rec["device_trace"] = trace_top_and_gaps(
                    trace, scope="train_step")
                rec["device_trace_mib"] = os.path.getsize(trace) / 2 ** 20
                check(rec["device_trace"]["device_ops"] > 0
                      and any(g["host_op"] or g["host_span"]
                              for g in rec["device_trace"]["top_idle_gaps"])
                      and any(o["host_span"] == "train_step" for o in
                              rec["device_trace"]["top_device_ops"]),
                      f"telemetry {arm}: device trace {rec['device_trace']}")
            check(all(math.isfinite(v) for v in losses),
                  f"telemetry {arm}: loss not finite {losses}")
            arms[arm] = rec
            log(f"[telemetry_resnet50] {arm}: {ms:.2f} ms/step, records "
                f"{rec.get('runlog_records')}")

        # the watchdog fires on a deliberately quiet heartbeat
        with telemetry_env(tdir, {"MXNET_RUNLOG": "runlog_wd.jsonl"}) as rl:
            step_fn, params, state = parallel.make_train_step(
                net, loss.SoftmaxCrossEntropyLoss(), "sgd",
                mesh=parallel.get_mesh(), compute_dtype="bfloat16",
                loss_scale="dynamic", optimizer_sharding="ps", **cfg["opt"])
            wd = Watchdog(timeout=tc["drill_timeout"]).arm("drill")
            t0 = time.perf_counter()
            i = 0
            while wd.stalls == 0 and time.perf_counter() - t0 < 20.0:
                _, params, state = step_fn(params, state, x, y, None,
                                           float(i + 1))
                torch.cuda.synchronize()
                i += 1
                if i <= 2:
                    wd.beat()  # then quiet
            quiet_s = time.perf_counter() - t0
            wd.close()
            n_steps += i
            runlog_wd, stacks = rl.path, stack_path_for(rl.path)
        recs, problems, counts = read_runlog(runlog_wd)
        wrecs = [r for r in recs if r["type"] == "watchdog"]
        drill = {"timeout_s": tc["drill_timeout"], "steps_run": i,
                 "stalls": wd.stalls, "seconds_to_fire": quiet_s,
                 "stack_file": os.path.basename(stacks),
                 "stack_file_bytes": os.path.getsize(stacks)
                 if os.path.exists(stacks) else 0,
                 "watchdog_records": len(wrecs),
                 "runlog_records": counts, "schema_problems": problems}
        check(wd.stalls >= 1 and drill["stack_file_bytes"] > 0 and wrecs
              and not problems, f"telemetry: the watchdog did not fire: "
              f"{drill}")
        n_brc = pc.bnreluconv_bwd.launches
        launches = {k: getattr(fn, attr) for k, (fn, attr) in
                    counters.items()}
        check(n_brc == brc_per_step(cfg["net"]) * n_steps,
              f"telemetry: bnreluconv launches {n_brc} != 16 x {n_steps}")
        plan = step_fn.zero_plan
        check(launches["bucket_sgd_mom"] == len(plan) * n_steps,
              f"telemetry: bucket launches {launches} != {len(plan)} x "
              f"{n_steps}")

        # the replicated step under the numerics monitor, on and off
        numerics = {}
        for on in (True, False):
            env = {"MXNET_RUNLOG": f"runlog_nm_{int(on)}.jsonl",
                   "MXNET_NUMERICS_SAMPLE": str(tc["nm_sample"])}
            if on:
                env["MXNET_NUMERICS"] = "1"
            torch.cuda.empty_cache()
            with telemetry_env(tdir, env) as rl:
                step_fn, params, state = parallel.make_train_step(
                    net, loss.SoftmaxCrossEntropyLoss(), "sgd",
                    compute_dtype="bfloat16", **cfg["opt"])
                check(("_numerics" in state) == on,
                      f"telemetry: _numerics in the state {on}")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                for i in range(tc["warmup"] + tc["nm_steps"]):
                    if i == tc["warmup"]:
                        torch.cuda.synchronize()
                        start.record()
                    _, params, state = step_fn(params, state, x, y, None,
                                               float(i + 1))
                end.record()
                end.synchronize()
                path = rl.path
            recs, problems, counts = read_runlog(path)
            ts = [r for r in recs if r["type"] == "tensor_stats"]
            row = {"ms_per_step": start.elapsed_time(end) / tc["nm_steps"],
                   "tensor_stats_steps": [r["step"] for r in ts],
                   "schema_problems": problems}
            if ts:
                rows = ts[-1]["tensors"]
                row.update(
                    tensors=len(rows),
                    nonfinite=[r["nonfinite"] for r in ts],
                    nan_inf=sum(v["nan"] + v["inf"] for r in ts
                                for v in r["tensors"].values()),
                    loss=rows["__loss"],
                    largest_grad_l2=max((v["l2"], k) for k, v in
                                        rows.items() if k != "__loss"))
            numerics["on" if on else "off"] = row
        n_total = tc["warmup"] + tc["nm_steps"]
        on = numerics["on"]
        check(on["tensor_stats_steps"] == list(range(0, n_total,
                                                     tc["nm_sample"]))
              and not any(on["nonfinite"]) and on["nan_inf"] == 0
              and not on["schema_problems"]
              and numerics["off"]["tensor_stats_steps"] == [],
              f"telemetry: numerics rows {numerics}")
    res = {"phase": "telemetry_resnet50", "net": cfg["net"],
           "batch": cfg["batch"], "compute_dtype": "bfloat16",
           "forward_macs_per_image": macs, "analytic_step_flops": analytic,
           "arms": arms, "watchdog_drill": drill, "numerics": numerics,
           "bnreluconv_launches": n_brc,
           **{f"{k}_launches": v for k, v in launches.items()},
           "steps_driven": n_steps,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return res


#: the traced serving windows: clients, seconds each window submits
#: (a window then waits for the requests in flight), the requests'
#: deadline.  Through HTTP each request's JSON body (a 224² image) takes
#: seconds under 64 clients, so that window submits for less time
SERVE_TRACED = dict(clients=64, seconds={"http": 1.0, "submit": 3.0},
                    slo_ms=10000.0)


def _traced_window(srv, fe, images, bodies, how):
    """``SERVE_TRACED["clients"]`` closed-loop clients for
    ``SERVE_TRACED["seconds"]``, through the HTTP front (``how`` =
    "http", the request's ``traceparent`` a client-side
    ``fleet_request`` span's context) or ``submit`` under that context
    ("submit"), profiled (CUDA activity): ``(outcomes, wall_s,
    profile)``, an outcome ``(trace id, ok, seconds)``."""
    import http.client
    import threading as _th

    import torch

    from mxnet_tpu_torch.telemetry import tracing

    cfg = SERVE_TRACED
    stop = _th.Event()
    lock = _th.Lock()
    outcomes = []

    def client(k):
        i = k
        while not stop.is_set():
            root = tracing.mint()
            t0 = time.perf_counter()
            ok = False
            if how == "http":
                conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                                  timeout=120)
                conn.request("POST", "/v1/predict",
                             body=bodies[i % len(bodies)],
                             headers={"Content-Type": "application/json",
                                      tracing.TRACEPARENT_HEADER:
                                      root.to_header()})
                resp = conn.getresponse()
                resp.read()
                conn.close()
                ok = resp.status == 200
            else:
                with tracing.use(root):
                    h = srv.submit(images[i % len(images)],
                                   deadline_ms=cfg["slo_ms"])
                h.result(timeout=120)
                ok = h.ok
            t1 = time.perf_counter()
            tracing.emit_span("fleet_request", t0, t1, root, kind="client",
                              via=how)
            with lock:
                outcomes.append((root.trace_id, ok, t1 - t0))
            i += cfg["clients"]

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    ts = [_th.Thread(target=client, args=(k,))
          for k in range(cfg["clients"])]
    with prof:
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(cfg["seconds"][how])
        stop.set()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return outcomes, wall, device_profile(prof, wall, top=6, shares={})


def _decompose(recs, outcomes):
    """Each request's end-to-end span (``fleet_request``) split into the
    server's queue, coalesce and compute spans, the frontend's time
    around them (``replica_request`` less those) and the rest, as
    ``tools/tracemerge.py doctor`` splits a request: ``(shares of the
    summed end-to-end time, requests with every span, mean ms)``."""
    phase_of = {"serve_queue": "queue", "serve_coalesce": "coalesce",
                "serve_model": "compute"}
    by_trace = {}
    for s in recs:
        if s["type"] == "span":
            by_trace.setdefault(s["trace_id"], {}).setdefault(
                s["name"], []).append(s["dur_ms"])
    parts = dict.fromkeys(("queue", "coalesce", "compute", "frontend",
                           "other"), 0.0)
    e2e_total, complete = 0.0, 0
    for trace_id, ok, _ in outcomes:
        got = by_trace.get(trace_id, {})
        if not ok or not all(n in got for n in ("fleet_request",
                                                 *phase_of)):
            continue
        complete += 1
        e2e = got["fleet_request"][0]
        inner = 0.0
        for n, p in phase_of.items():
            parts[p] += sum(got[n])
            inner += sum(got[n])
        served = got["replica_request"][0] if "replica_request" in got \
            else inner
        front = max(0.0, served - inner)
        parts["frontend"] += front
        parts["other"] += e2e - inner - front
        e2e_total += e2e
    shares = {k: v / e2e_total for k, v in parts.items()} \
        if e2e_total else {}
    return shares, complete, (e2e_total / complete if complete else None)


def serve_traced_phase(served):
    """``serve_resnet50``'s ``resnet50_v1()`` (fp32, the artifact's one
    CUDA graph) with ``MXNET_RUNLOG`` on, 64 closed-loop clients for a few
    seconds each way: through ``ServeFrontend`` (every request carrying
    a ``traceparent`` under a client-side ``fleet_request`` span), and
    through ``submit`` under the same kind of context.  Each request's
    end-to-end time is split from the run log into queue, coalesce,
    compute, the frontend and the rest; the device's idle share over
    each window comes from a CUDA-activity profile."""
    from mxnet_tpu_torch.serving import ModelServer, ServeFrontend
    from mxnet_tpu_torch.telemetry.opstats import percentile

    cfg = SERVE_TRACED
    images = served["images"]
    bodies = [json.dumps({"inputs": images[i:i + 1].tolist(),
                          "deadline_ms": cfg["slo_ms"]}).encode()
              for i in range(len(images))]
    t_phase = time.perf_counter()
    tdir = os.path.join(os.path.dirname(served["path"]), "traced")
    os.makedirs(tdir, exist_ok=True)
    windows = {}
    with telemetry_env(tdir, {"MXNET_RUNLOG": "serve.jsonl"}) as rl:
        srv = ModelServer.from_artifact(served["path"],
                                        slo_ms=cfg["slo_ms"],
                                        coalesce_ms=SERVE["coalesce_ms"],
                                        name="resnet50_traced")
        srv.start(warm=True)
        fe = ServeFrontend(srv, port=0).start()
        try:
            for how in ("http", "submit"):
                windows[how] = _traced_window(srv, fe, images, bodies, how)
        finally:
            fe.close()
            srv.close()
        path = rl.path
    recs, problems, counts = read_runlog(path)
    res = {"phase": "serve_traced",
           "model": "resnet50_v1 (fp32, artifact bucket 32)",
           "buckets": list(srv.buckets),
           "compile_programs": sorted({r["program"] for r in recs
                                       if r["type"] == "compile"}),
           "clients": cfg["clients"], "runlog_records": counts,
           "schema_problems": problems, "windows": {}}
    for how, (outcomes, wall, prof) in windows.items():
        ok = [o for o in outcomes if o[1]]
        lat = sorted(o[2] * 1e3 for o in ok)
        shares, complete, mean_ms = _decompose(recs, outcomes)
        res["windows"][how] = {
            "wall_s": wall, "requests": len(outcomes), "ok": len(ok),
            "requests_s": len(ok) / wall, "p50_ms": percentile(lat, 0.5),
            "p99_ms": percentile(lat, 0.99), "traced_complete": complete,
            "shares_of_e2e": shares, "mean_e2e_ms": mean_ms,
            "profile": prof}
        log(f"[serve_traced] {how}: {len(ok) / wall:.1f} req/s, shares "
            f"{ {k: round(v, 4) for k, v in shares.items()} }, idle "
            f"{prof.get('device_idle_share')}")
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    check(not problems, f"serve_traced: schema problems {problems[:5]}")
    for how, w in res["windows"].items():
        check(w["ok"] == w["requests"] and w["traced_complete"] == w["ok"]
              > 0, f"serve_traced {how}: {w['ok']} ok of {w['requests']},"
              f" {w['traced_complete']} with every span")
        check(abs(sum(w["shares_of_e2e"].values()) - 1.0) < 1e-6,
              f"serve_traced {how}: shares {w['shares_of_e2e']}")
    # the artifact cannot retrace; its one capture at warm-up is the
    # CachedOp's one compile record (a capture counts as a trace)
    check(counts.get("serve", 0) >= 1
          and counts.get("compile", 0) == len(res["buckets"]),
          f"serve_traced: records {counts}, buckets {res['buckets']}")
    return res


# ------------------------------------------------------ the data plane
#: the data plane's corpus: 12 batches of 128 landscape JPEGs of
#: 500x375, ImageNet's typical size, written on the card by nvJPEG
DATA_IMAGES = 1536
DATA_HW = (375, 500)
#: train_imagenet.py's ImageRecordIter settings (the example's defaults)
IMAGENET_AUG = dict(data_shape=(3, 224, 224), resize=256,
                    mean=(123.68, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375))
#: the committed JPEGs (4:2:0, 4:4:4, grayscale, odd sizes) and the
#: pixels libjpeg decodes from them (tests/test_torch_image_record_iter.py
#: writes and checks the file)
NVJPEG_FIXTURE = os.path.join("tests", "data", "nvjpeg_fixture.npz")


def data_plane_probe():
    """What the card's host has for decoding JPEGs: nvJPEG's header and
    library in the CUDA toolkit, PIL, libjpeg's header, g++."""
    import glob
    import importlib.util

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return {
        "phase": "data_plane_probe",
        "nvjpeg_h": os.path.exists(os.path.join(home, "include",
                                                "nvjpeg.h")),
        "libnvjpeg": sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(home, "lib64", "libnvjpeg.so*"))),
        "pil": importlib.util.find_spec("PIL") is not None,
        "jpeglib_h": os.path.exists("/usr/include/jpeglib.h"),
        "gxx": shutil.which("g++"),
        "nvidia_smi": nvidia_smi_line(),
    }


def smooth_images(n, hw, seed, device):
    """``n`` (h, w, 3) uint8 images on the card: a low-frequency random
    field with grain, so that they compress as photographs do."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    out = []
    for i in range(0, n, 64):
        k = min(64, n - i)
        small = torch.rand((k, 3, 6, 8), generator=g, device=device)
        img = torch.nn.functional.interpolate(
            small, size=(h, w), mode="bicubic", align_corners=False)
        img = img * 255 + torch.randn((k, 3, h, w), generator=g,
                                      device=device) * 6
        img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        out.extend(img.contiguous().unbind(0))
    return out


def write_corpus(path, n, seed=0, hw=DATA_HW, quality=90):
    """A ``.rec`` of ``n`` JPEGs encoded on the card by nvJPEG (4:2:0)
    and framed by the port's ``recordio``; labels ``i % 1000``.
    Returns each record's byte offset and the JPEG bytes in all."""
    import torch

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.io import nvjpeg

    dev = torch.device("cuda", 0)
    enc = nvjpeg.decoder(dev)
    w = recordio.MXRecordIO(path, "w")
    offsets, jpeg_bytes = [], 0
    try:
        for i0 in range(0, n, 256):
            for j, img in enumerate(smooth_images(min(256, n - i0), hw,
                                                  seed + i0, dev)):
                jpeg = enc.encode(img, quality, 2)
                jpeg_bytes += len(jpeg)
                offsets.append(w.tell())
                w.write(recordio.pack(recordio.IRHeader(
                    0, float((i0 + j) % 1000), i0 + j, 0), jpeg))
    finally:
        w.close()
    return offsets, jpeg_bytes


def damaged_copy(src, dst, offsets, n, torn=(), unpack=(), decode=()):
    """The first ``n`` records of ``src`` with the three damage shapes
    of the reference's ``test_utils.corrupt_rec``: a garbled frame
    magic, a 0xFFFFFFFF header flag, a smeared JPEG payload."""
    with open(src, "rb") as f:
        blob = bytearray(f.read(offsets[n]))
    for i in torn:
        blob[offsets[i]:offsets[i] + 4] = b"\xde\xad\xbe\xef"
    for i in unpack:
        blob[offsets[i] + 8:offsets[i] + 12] = b"\xff\xff\xff\xff"
    for i in decode:
        blob[offsets[i] + 36:offsets[i] + 84] = b"\x55" * 48
    with open(dst, "wb") as f:
        f.write(blob)


def _augment_case(name, buf, offs, hs, ws, out_hw, resize, seed, mirror,
                  ms=None):
    """``image_augment.cu`` against ``image_augment_plain`` on the card,
    on the same decoded pixels and draws: bit for bit."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch.ops import image_augment as ia

    n = len(hs)
    rng = onp.random.RandomState(seed)
    cx = rng.rand(n).astype("float32")
    cy = rng.rand(n).astype("float32")
    mir = {"random": (rng.rand(n) < 0.5), "on": onp.ones(n, bool),
           "off": onp.zeros(n, bool)}[mirror].astype("uint8")
    mean, std = IMAGENET_AUG["mean"], IMAGENET_AUG["std"]
    args = (buf, offs, hs, ws, out_hw[0], out_hw[1], cx, cy, mir, mean,
            std, resize)
    got = ia.image_augment(*args)
    want = ia.image_augment_plain(*args)
    torch.cuda.synchronize()
    g = ia.plan(hs, ws, out_hw[0], out_hw[1], cx, cy, resize)
    res = {"case": name, "images": n, "out": list(out_hw),
           "resize_short": resize, "mirror": mirror,
           "whole_frame_resized": int((g[3] < 0).sum()),
           "bit_equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()) if n else 0.0}
    if ms is not None:
        call = lambda: ia.image_augment(*args)  # noqa: E731
        # the kernel alone on the card, averaged over the launches the
        # profiler recorded (late in a long process it recorded as few
        # as 8 of 20); back-to-back calls between CUDA events (``call_ms``)
        # are timed by the wrapper's host work (plan, pinned metadata,
        # copies, launch; ``host_ms``), which is several times longer
        call()
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        seen = [(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0), e.count)
                for e in prof.key_averages() if "augment_kernel" in e.key]
        check(seen, "no augment kernel in the profile")
        res["profiled_launches"] = sum(c for _, c in seen)
        res["ms"] = sum(t for t, _ in seen) / 1e3 / res["profiled_launches"]
        res["call_ms"] = time_ms(call)
        res["plain_ms"] = time_ms(lambda: ia.image_augment_plain(*args),
                                  budget_ms=600.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        res["host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        read = augment_read_bytes(hs, ws, g, out_hw[0], out_hw[1])
        nbytes = read + n * 3 * out_hw[0] * out_hw[1] * 4 + n * (8 * 4 + 8)
        res["bound_ms"], res["bound_by"] = bound(0.0, nbytes, "float32")
        res["bytes"] = nbytes
        res["bytes_read_of_images"] = read
    return res


def augment_read_bytes(hs, ws, g, out_h, out_w):
    """The decoded bytes ``image_augment`` must read, from ``plan``'s
    geometry ``g``: of a cropped image, the source rows and columns its
    crop window maps to (with the bilinear tap below and right of
    them); of a cropped image with no resize, the window itself; of a
    whole-frame resize, the whole image.  Scales in float32, as the
    kernel computes them."""
    import numpy as onp

    def span(src, dst, first, count):
        if dst <= 1:
            return 1
        s = onp.float32(src - 1) / onp.float32(dst - 1)
        lo = int(onp.float32(first) * s)
        hi = min(int(onp.float32(first + count - 1) * s) + 1, src - 1)
        return hi - lo + 1

    total = 0
    for i, (h, w) in enumerate(zip(hs, ws)):
        nh, nw, rs, x0, y0 = (int(v) for v in g[:, i])
        if x0 < 0:
            total += h * w * 3
        elif not rs:
            total += out_h * out_w * 3
        else:
            total += span(h, nh, y0, out_h) * span(w, nw, x0, out_w) * 3
    return total


def data_plane_phase(workdir, seed=0):
    """The data plane on the card: the corpus written by nvJPEG, the
    augment kernel against its plain version, nvJPEG against libjpeg on
    the committed fixture, a damaged copy's quarantine manifest, the
    ``mx.kv`` stores on ``cuda:0``."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import nvjpeg

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    corpus = os.path.join(workdir, "train.rec")
    offsets, jpeg_bytes = write_corpus(corpus, DATA_IMAGES, seed)
    encode_s = time.perf_counter() - t0
    res = {"phase": "data_plane", "corpus": {
        "images": DATA_IMAGES, "hw": list(DATA_HW), "jpeg_bytes": jpeg_bytes,
        "mean_jpeg_bytes": jpeg_bytes / DATA_IMAGES,
        "file_bytes": os.path.getsize(corpus), "encode_s": encode_s}}

    # the kernel against its plain version: the main path's batch, odd
    # sizes, images smaller than the crop, the mirror on and off
    rec = mx.recordio.MXRecordIO(corpus, "r")
    jpegs = [mx.recordio.unpack(rec.read())[1] for _ in range(128)]
    rec.close()
    buf, offs, hs, ws, bad, _ = nvjpeg.decode_batch(jpegs, dev)
    check(not bad and len(hs) == 128, f"corpus decode failed: {bad}")
    odd = []
    for k, (h, w) in enumerate([(375, 500), (333, 257), (101, 99),
                                (211, 1001), (17, 300), (224, 223),
                                (999, 31), (1, 1)]):
        img = smooth_images(1, (h, w), 50 + k, dev)[0]
        odd += [nvjpeg.decoder(dev).encode(img, 90, ss) for ss in (2, 0)]
    obuf, ooffs, ohs, ows, obad, _ = nvjpeg.decode_batch(odd, dev)
    check(not obad, f"odd-size decode failed: {obad}")
    cases = [
        _augment_case("resnet_batch", buf, offs, hs, ws, (224, 224), 256,
                      1, "random", ms=True),
        _augment_case("odd_sizes_resize", obuf, ooffs, ohs, ows,
                      (224, 224), 256, 2, "random"),
        _augment_case("odd_sizes_no_resize", obuf, ooffs, ohs, ows,
                      (224, 224), -1, 3, "on"),
        _augment_case("odd_sizes_small_crop", obuf, ooffs, ohs, ows,
                      (61, 47), 100, 4, "off"),
        _augment_case("batch_mirror_on", buf, offs, hs, ws, (224, 224), 256,
                      5, "on"),
        _augment_case("batch_no_resize", buf, offs, hs, ws, (224, 224), -1,
                      6, "off"),
    ]
    res["augment_cases"] = cases
    check(all(c["bit_equal"] for c in cases),
          f"image_augment differs from its plain version: "
          f"{[(c['case'], c['max_abs_err']) for c in cases]}")
    check(any(c["whole_frame_resized"] for c in cases),
          "no image smaller than its crop was held")

    # nvJPEG against libjpeg's pixels on the committed fixture
    fx = onp.load(NVJPEG_FIXTURE)
    names = sorted(k[5:] for k in fx.files if k.startswith("jpeg_"))
    fbuf, foffs, fhs, fws, fbad, _ = nvjpeg.decode_batch(
        [fx[f"jpeg_{n}"].tobytes() for n in names], dev)
    check(not fbad, f"fixture decode failed: {fbad}")
    diffs = {}
    for k, n in enumerate(names):
        h, w = fhs[k], fws[k]
        mine = fbuf[int(foffs[k]):int(foffs[k]) + h * w * 3].cpu().numpy() \
            .reshape(h, w, 3).astype(int)
        want = fx[f"pix_{n}"].astype(int)
        check(mine.shape == want.shape, f"fixture {n}: shape {mine.shape}")
        d = onp.abs(mine - want)
        diffs[n] = {"max": int(d.max()), "mean": float(d.mean()),
                    "share_differing": float((d > 0).mean())}
    res["nvjpeg_vs_libjpeg_fixture"] = diffs
    res["nvjpeg_batched_backend"] = nvjpeg.decoder(dev).backend

    # a damaged copy: the manifest names exactly the damaged records
    bad_path = os.path.join(workdir, "damaged.rec")
    damaged_copy(corpus, bad_path, offsets, 256, torn=(10,), unpack=(40,),
                 decode=(100, 200))
    manifest = os.path.join(workdir, "damaged.quarantine.json")
    it = mx.io.ImageRecordIter(
        path_imgrec=bad_path, batch_size=64, shuffle=True, rand_crop=True,
        rand_mirror=True, max_skip_frac=0.5, quarantine_manifest=manifest,
        ctx=mx.gpu(0), **_iter_aug())
    n_batches = sum(1 for _ in it)
    stats = it.data_plane_stats()
    it.close()
    with open(manifest) as f:
        man = json.load(f)
    # the torn frame drops out of the parsed stream: later ordinals
    # shift down by one
    got = sorted((e["stage"], e["record"]) for e in man["entries"])
    want = [("decode", 99), ("decode", 199), ("read", None),
            ("unpack", 39)]
    res["damaged_copy"] = {"records": 256, "batches": n_batches,
                           "entries": got, "stats": stats}
    check(sorted(got, key=str) == sorted(want, key=str),
          f"manifest {got} != {want}")
    check(n_batches == 4 and stats["skipped"] == 4,
          f"damaged copy: {n_batches} batches, stats {stats}")

    res["kv_stores"] = kv_on_card()
    return res, corpus


def _iter_aug():
    a = IMAGENET_AUG
    return dict(data_shape=a["data_shape"], resize=a["resize"],
                mean_r=a["mean"][0], mean_g=a["mean"][1],
                mean_b=a["mean"][2], std_r=a["std"][0], std_g=a["std"][1],
                std_b=a["std"][2])


def kv_on_card():
    """``mx.kv``'s stores with their values on ``cuda:0`` against the
    same pushes on the host: sums, the optimizer on the store, 2-bit
    compression."""
    import numpy as onp

    import mxnet_tpu_torch as mx

    out = {}
    rng = onp.random.RandomState(3)
    grads = [rng.randn(4, 256, 256).astype("float32") for _ in range(6)]
    w0 = rng.randn(256, 256).astype("float32")
    for kind in ("local", "device"):
        got = {}
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                kv = mx.kv.create(kind)
                kv.init("w", mx.nd.array(w0))
                kv.push("w", [mx.nd.array(g[0]) for g in grads[:3]])
                plain = mx.nd.zeros((256, 256))
                kv.pull("w", out=plain)
                kv.set_optimizer(mx.optimizer.create(
                    "sgd", learning_rate=0.1, momentum=0.9))
                for g in grads[3:]:
                    kv.push("w", mx.nd.array(g[0]))
                upd = mx.nd.zeros((256, 256))
                kv.pull("w", out=upd)
                ck = mx.kv.create(kind)
                ck.set_gradient_compression({"type": "2bit",
                                             "threshold": 0.5})
                ck.init("c", mx.nd.zeros((256, 256)))
                for g in grads[:3]:
                    ck.push("c", mx.nd.array(g[1]))
                comp = mx.nd.zeros((256, 256))
                ck.pull("c", out=comp)
                got[str(ctx)] = (plain, upd, comp)
                if ctx == mx.gpu(0):
                    check(all(v._data.is_cuda for v in (plain, upd, comp))
                          and kv._store["w"]._data.is_cuda,
                          "a card store's value left the card")
        card, host = got["gpu(0)"], got["cpu(0)"]
        errs = [float(onp.abs(a.asnumpy() - b.asnumpy()).max())
                for a, b in zip(card, host)]
        out[kind] = dict(zip(("sum", "sgd_on_store", "2bit"), errs))
        check(errs[0] == 0.0 and errs[2] == 0.0 and errs[1] <= 1e-6,
              f"kv {kind} card vs host: {errs}")
    return out


def train_imagenet_phase(corpus, warmup=2, steps=10, seed=0):
    """``example/train_imagenet.py`` on the card at its defaults
    (``resnet50_v1``, 224², batch 128, bf16, SGD lr 0.1 momentum 0.9,
    ``ImageRecordIter`` with resize 256, random crop and mirror, the
    example's mean/std), its batches decoded on the card by nvJPEG and
    the augment kernel ahead of the step; the one-card mesh and
    ``MXNET_OPTIMIZER_SHARDING=ps`` put the update on the bucket kernel,
    as ``train_resnet50_nchw`` forces it.  Launch counts are set to 0
    just before the fed steps and read just after.  Then the same step
    on a resident batch, the iterator alone, and 3 fed steps
    profiled."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.example import train_imagenet as ex
    from mxnet_tpu_torch.ops import image_augment as ia
    from mxnet_tpu_torch.ops import pallas_opt as po

    args = ex.parse_args(["--data-train", corpus, "--data-parallel-mesh"])
    old = os.environ.get("MXNET_OPTIMIZER_SHARDING")
    os.environ["MXNET_OPTIMIZER_SHARDING"] = "ps"
    onp.random.seed(seed)
    torch.cuda.reset_peak_memory_stats()
    batch = args.batch_size
    try:
        with autotune.force(fused_bucket_opt=True):
            t0 = time.perf_counter()
            kv, it, step_fn, params, state = ex.build(args)
            build_s = time.perf_counter() - t0
            carry = [params, state]
            t_step = [0]

            def next_batch():
                try:
                    return it.next()
                except StopIteration:
                    it.reset()
                    return it.next()

            def step(batch):
                t_step[0] += 1
                lv, carry[0], carry[1] = step_fn(
                    carry[0], carry[1], batch.data[0]._data,
                    batch.label[0]._data, 0, float(t_step[0]))
                return lv

            po.bucket_sgd_mom.launches = 0
            ia.image_augment.launches = 0
            it.reset()  # the producer starts with the counts at 0
            losses = []
            on_card = True
            for _ in range(warmup):
                b = next_batch()
                on_card &= b.data[0]._data.is_cuda and \
                    b.label[0]._data.is_cuda
                losses.append(step(b))
            torch.cuda.synchronize()
            s0 = it.stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                b = next_batch()
                on_card &= b.data[0]._data.is_cuda
                losses.append(step(b))
            end.record()
            end.synchronize()
            s1 = it.stats()
            bucket_launches = po.bucket_sgd_mom.launches
            augment_launches = ia.image_augment.launches
            fed_ms = start.elapsed_time(end) / steps
            # the same step on a resident batch
            start.record()
            for _ in range(steps):
                losses.append(step(b))
            end.record()
            end.synchronize()
            resident_ms = start.elapsed_time(end) / steps
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                t1 = time.perf_counter()
                for _ in range(3):
                    step(next_batch())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            plan = step_fn.zero_plan
            # the iterator alone: one epoch, no step
            it.reset()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n_alone = 0
            for bb in it:
                n_alone += bb.data[0].shape[0]
            torch.cuda.synchronize()
            alone_s = time.perf_counter() - t2
            dp = it.data_plane_stats()
            it.close()
            # every batch this iterator made: its bytes to the card are
            # counted where it decodes it, its launch after the augment
            h2d_per_batch = it.stats()["h2d_bytes"] / max(
                1, ia.image_augment.launches)
            # and with a pool of four decode workers
            with_pool = mx.io.ImageRecordIter(
                path_imgrec=corpus, batch_size=batch, shuffle=True,
                rand_crop=True, rand_mirror=True, io_workers=4,
                ctx=mx.gpu(0), **_iter_aug())
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            n_pool = sum(bb.data[0].shape[0] for bb in with_pool)
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t3
            with_pool.close()
    finally:
        if old is None:
            os.environ.pop("MXNET_OPTIMIZER_SHARDING", None)
        else:
            os.environ["MXNET_OPTIMIZER_SHARDING"] = old
    losses = [float(v) for v in losses]
    res = {
        "phase": "train_imagenet", "network": args.network, "batch": batch,
        "image": 224, "compute_dtype": args.dtype, "optimizer": "sgd",
        "lr": args.lr, "kv": kv.type, "io_workers": dp["workers"],
        "warmup_steps": warmup, "timed_steps": steps,
        "fed_ms_per_step": fed_ms, "fed_img_s": batch / fed_ms * 1e3,
        "resident_ms_per_step": resident_ms,
        "resident_img_s": batch / resident_ms * 1e3,
        "iterator_alone_img_s": n_alone / alone_s,
        "iterator_alone_images": n_alone,
        "iterator_alone_img_s_4_workers": n_pool / pool_s,
        "feed_wait_s_per_batch": (s1["consumer_wait_s"]
                                  - s0["consumer_wait_s"]) / steps,
        "h2d_bytes_per_batch": h2d_per_batch,
        "decoded_fp32_batch_bytes": batch * 3 * 224 * 224 * 4,
        "peak_mem_gib": peak, "buckets": len(plan), "build_s": build_s,
        "losses": losses, "bucket_sgd_mom_launches": bucket_launches,
        "image_augment_launches": augment_launches,
        "profile_3_fed_steps": device_profile(prof, wall, top=12,
                                              shares=STEP_SHARES),
    }
    check(on_card, "a fed batch was not on the card")
    check(all(math.isfinite(v) for v in losses),
          f"train_imagenet: loss not finite: {losses}")
    check(bucket_launches == len(plan) * (warmup + steps),
          f"train_imagenet: bucket launches {bucket_launches} != "
          f"{len(plan)} buckets x {warmup + steps} steps")
    check(augment_launches >= warmup + steps,
          f"train_imagenet: {augment_launches} augment launches for "
          f"{warmup + steps} batches")
    return res


def run(profile=False, old_brc=None, workdir=None):
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
    probe = data_plane_probe()
    log(f"[data_plane_probe] {probe}")
    emit(probe)

    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    build_s = time.perf_counter() - t0
    for name in _kernels.sources():
        for line in (_kernels.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    # the flash kernel runs on the tensor cores, and its D = 128
    # instantiations keep everything in registers
    # per instantiation of the forward kernel: the fp32 ones (the main
    # path's) take TF32 MMAs, the bf16 ones bf16 MMAs
    # and so do the two instantiations of the slab kernel (head dims
    # above 128), with no spill either
    sass = sass_hmma("flash_attention")
    fwd = {f: c for f, c in sass.items() if "flash_fwd_kernel" in f}
    f32 = {f: c for f, c in fwd.items() if "bfloat16" not in f}
    b16 = {f: c for f, c in fwd.items() if "bfloat16" in f}
    slab = {f: c for f, c in sass.items() if "flash_fwd_slab_kernel" in f}
    hmma = sum(c["hmma"] for c in sass.values())
    flash_log = _kernels.build_log("flash_attention") or ""
    spills = ptxas_spills(flash_log, "Li128E")
    slab_spills = ptxas_spills(flash_log, "flash_fwd_slab_kernel")
    for f, c in sorted(fwd.items()) + sorted(slab.items()):
        log(f"[sass flash_attention] {f}: {c}")
    log(f"[sass flash_attention] {hmma} HMMA instructions; D = 128 and "
        f"slab (spill store, spill load bytes, registers): "
        f"{sorted(map(tuple, spills.values()))} "
        f"{sorted(map(tuple, slab_spills.values()))}")
    # the bf16 fused backward runs on the tensor cores: each
    # instantiation of its two product kernels (16-byte copies and
    # element loads) holds bf16 MMAs and spills nothing
    brc_sass = {f: c for f, c in sass_hmma("bnreluconv_bwd").items()
                if "mma_kernel" in f}
    brc_spills = ptxas_spills(_kernels.build_log("bnreluconv_bwd") or "",
                              "mma_kernel")
    for f, c in sorted(brc_sass.items()):
        log(f"[sass bnreluconv_bwd] {f}: {c}")
    log(f"[sass bnreluconv_bwd] (spill store, spill load bytes, "
        f"registers): {sorted(map(tuple, brc_spills.values()))}")
    emit({"phase": "build", "sources": _kernels.sources(),
          "compiled": built, "seconds": build_s,
          "flash_sass_hmma": hmma, "flash_sass_by_function": fwd,
          "flash_d128_spills": spills,
          "flash_slab_sass_by_function": slab,
          "flash_slab_spills": slab_spills,
          "bnreluconv_sass_by_function": brc_sass,
          "bnreluconv_mma_spills": brc_spills})
    # one instantiation per head_dim 8, 16, 32, 64, 128 and dtype
    check(len(f32) == 5 and all(c["tf32"] > 0 for c in f32.values()),
          f"an fp32 flash kernel holds no TF32 HMMA: {f32}")
    check(len(b16) == 5 and all(c["bf16"] > 0 for c in b16.values()),
          f"a bf16 flash kernel holds no bf16 HMMA: {b16}")
    check(len(spills) >= 2 and all(v[:2] == [0, 0]
                                   for v in spills.values()),
          f"flash D = 128 instantiations spill: {spills}")
    check(len(slab) == 2 and all(
        (c["bf16"] > 0 and c["tf32"] == 0) if "bfloat16" in f
        else (c["tf32"] > 0 and c["bf16"] == 0) for f, c in slab.items()),
          f"a flash slab kernel holds no tensor-core MMA of its dtype: "
          f"{slab}")
    check(len(slab_spills) == 2 and all(v[:2] == [0, 0]
                                        for v in slab_spills.values()),
          f"flash slab kernels spill: {slab_spills}")
    check(len(brc_sass) == 4 and all(c["bf16"] > 0 and c["tf32"] == 0
                                     for c in brc_sass.values()),
          f"a bf16 fused-backward product kernel holds no bf16 tensor-core "
          f"MMA: {brc_sass}")
    check(len(brc_spills) == 4 and all(v[:2] == [0, 0]
                                       for v in brc_spills.values()),
          f"fused-backward product kernels spill: {brc_spills}")

    cases = []
    for i, case in enumerate(kernel_cases()):
        res = kernel_case(*case, seed=i, names=case[:7] in NAMED_CASES)
        log(f"[kernels] {res['shape']} {res['dtype']} "
            f"causal={res['causal']} err={res['max_abs_err']:.3g} "
            f"row_rel={res['row_rel_err']:.3g} "
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

    deep = deep_head_phase()
    log(f"[serve_head_dim_256] flash launches {deep['flash_launches']}, "
        f"tokens equal: {deep['tokens_cuda_eq_cpu']}")
    emit(deep)

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

    old = None if old_brc is None else old_brc_runner(old_brc, workdir)
    brc = []
    for i, (m, ci, co, _per_step) in enumerate(BRC_STAGES):
        for dtype in ("bfloat16", "float32"):
            brc.append(brc_case(m, ci, co, dtype, "resnet50_stage",
                                seed=100 + i, old=old))
    for j, dtype in enumerate(("bfloat16", "float32")):
        # ragged M, and the smallest Ci/Co the path uses
        brc.append(brc_case(100003, 64, 256, dtype, "check", seed=110 + j))
    # bf16 with Co not a multiple of 8: the element-load arm
    brc.append(brc_case(4133, 64, 250, "bfloat16", "check", seed=112))
    for c in brc:
        log(f"[bnreluconv] {c['shape']} {c['dtype']} err={c['max_abs_err']:.3g}"
            f" ms={c['ms']:.4f} plain={c['plain_ms']:.4f} "
            f"matmuls={c['yardstick_two_matmuls_ms']:.4f} "
            f"bound={c['bound_ms']:.4f}" +
            (f" earlier={c['earlier_kernel_ms']:.4f} "
             f"again={c['ms_again']:.4f}" if "ms_again" in c else ""))
    emit({"phase": "kernels_bnreluconv", "cases": brc})

    plan = resnet50_plan()
    sizes = [b.size for b in plan]
    big, mid = max(sizes), sorted(sizes)[len(sizes) // 2]
    sgd = [bucket_case(big, "float32", 0.9, "resnet50_bucket", 200),
           bucket_case(mid, "float32", 0.9, "resnet50_bucket", 201),
           bucket_case(1000003, "float32", 0.9, "check", 202),
           bucket_case(big, "float32", 0.0, "resnet50_bucket", 203),
           bucket_case(mid, "bfloat16", 0.9, "check", 204)]
    for c in sgd:
        log(f"[bucket_sgd] n={c['n']} {c['dtype']} momentum={c['momentum']}"
            f" ms={c['ms']:.4f} plain={c['plain_ms']:.4f} "
            f"fused_sgd={c['library_ms']:.4f} bound={c['bound_ms']:.4f}")
    emit({"phase": "kernels_bucket_sgd", "bucket_sizes": sizes,
          "cases": sgd})

    adam = [adam_case(big, 1, "resnet50_bucket", 300),
            adam_case(big, 1000, "resnet50_bucket", 301),
            adam_case(mid, 1, "resnet50_bucket", 302),
            adam_case(1000003, 7, "check", 303),
            adam_case(mid, 2, "check", 304, planted=True)]
    for c in adam:
        log(f"[bucket_adam] n={c['n']} t={c['t']} ms={c['ms']:.4f} "
            f"plain={c['plain_ms']:.4f} fused_adam={c['library_ms']:.4f} "
            f"bound={c['bound_ms']:.4f}")
    emit({"phase": "kernels_bucket_adam", "cases": adam})

    dev = torch.device("cuda", 0)
    segs = [zero_segments(b, dev) for b in plan]
    one = next(s for b, s in zip(plan, segs) if b.size == big)
    many = max(segs, key=lambda s: s[1])
    arbitrary = (torch.randint(0, 128, (1000003,), device=dev,
                               dtype=torch.int32,
                               generator=torch.Generator(device=dev)
                               .manual_seed(7)), 128)
    lars = [lars_case(*one, "resnet50_bucket", 400),
            lars_case(*many, "resnet50_bucket", 401),
            lars_case(*arbitrary, "check_arbitrary_ids", 402)]
    for c in lars:
        log(f"[bucket_lars] n={c['n']} nseg={c['nseg']} norms="
            f"{c['ms_norms']:.4f} trust={c['ms_trust']:.4f} update="
            f"{c['ms_update']:.4f} (cold {c['ms_update_cold']:.4f}) "
            f"plain={c['plain_ms']:.4f} "
            f"bound={c['bound_ms']:.4f}")
    emit({"phase": "kernels_bucket_lars", "cases": lars})

    mx, plugin = load_plugin()
    t0 = time.perf_counter()
    sa = scaled_add_cases(plugin)
    emit({"phase": "kernels_scaled_add", "cases": sa})
    t1 = time.perf_counter()
    plug = nd_plugin_phase(mx, plugin)
    plug["seconds"] = time.perf_counter() - t1
    log(f"[scaled_add] phases took {t1 - t0:.1f} s and "
        f"{plug['seconds']:.1f} s")
    log(f"[nd_plugin] launches={plug['scaled_add_launches']} loop "
        f"{plug['loop']['losses_card'][0]:.4f} -> "
        f"{plug['loop']['losses_card'][-1]:.4f} (host rel "
        f"{plug['loop']['max_rel_diff']:.2e}), nd dispatch "
        f"{plug['nd_dispatch_us']:.1f} us, wrapper "
        f"{plug['wrapper_dispatch_us']:.1f} us")
    emit(plug)

    trains = {}
    for name in TRAIN_PHASES:
        trains[name] = train_phase(name, warmup=2, steps=10)
        log(f"[{name}] {trains[name]['ms_per_step']:.2f} ms/step "
            f"{trains[name]['img_s']:.1f} img/s peak "
            f"{trains[name]['peak_mem_gib']:.2f} GiB losses "
            f"{trains[name]['losses']}")
        emit(trains[name])
        torch.cuda.empty_cache()
    train, t_lars, t_adam = (trains[n] for n in (
        "train_resnet50", "train_resnet50_lars", "train_resnet50_adam"))
    t0 = time.perf_counter()
    tel = telemetry_resnet50_phase(workdir)
    log(f"[telemetry_resnet50] ms/step "
        f"{ {k: round(a['ms_per_step'], 2) for k, a in tel['arms'].items()} }"
        f", FLOPs / analytic "
        f"{tel['arms']['runlog']['program_report']['flops_over_analytic']:.4f}"
        f", watchdog fired after "
        f"{tel['watchdog_drill']['seconds_to_fire']:.2f} s, numerics on/off ms "
        f"{tel['numerics']['on']['ms_per_step']:.2f}/"
        f"{tel['numerics']['off']['ms_per_step']:.2f} "
        f"({time.perf_counter() - t0:.1f} s)")
    prof_arm = tel["arms"]["runlog_sample1_watchdog_numerics_profiler"]
    for row in prof_arm["device_trace"]["top_device_ops"]:
        log(f"[telemetry_resnet50] top op {row['ms']:.2f} ms x"
            f"{row['calls']} {row['name'][:60]} <- {row['host_op']} in "
            f"{row['host_span']}")
    for row in prof_arm["device_trace"]["top_idle_gaps"]:
        log(f"[telemetry_resnet50] idle gap {row['ms']:.3f} ms during "
            f"{row['host_op']} in {row['host_span']}")
    torch.cuda.empty_cache()
    sgd_trains = [t for t in trains.values() if t["optimizer"] == "sgd"]
    hosts = {}
    cvc = {}
    for k, (_, _, _, net_kind, _) in CUDA_CPU_STEPS.items():
        if net_kind not in hosts:
            hosts[net_kind] = resnet50("cpu", 3, net_kind)
        cvc[k] = cuda_vs_cpu_phase(k, hosts[net_kind])

    torch.cuda.empty_cache()
    lenet = gluon_lenet_phase()
    log(f"[gluon_lenet] {lenet['ms_per_step_by_epoch']} ms/step, epochs "
        f"{lenet['epochs_loss_acc']}, val acc {lenet['val_acc']:.4f}")
    gres = gluon_resnet50_phase()
    log(f"[gluon_resnet50] {gres['ms_per_step']:.2f} ms/step "
        f"{gres['img_s']:.1f} img/s peak {gres['peak_mem_gib']:.2f} GiB, "
        f"trainer.step {gres['trainer_step_host_ms']:.2f} host ms, "
        f"losses {gres['losses']}")
    torch.cuda.empty_cache()
    gcvc = gluon_cuda_vs_cpu_phase()
    log(f"[gluon_cuda_vs_cpu] loss rel {gcvc['loss_rel']:.2e}, closest "
        f"{gcvc['closest_to_limit']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ghyb = gluon_hybrid_resnet50_phase(gres)
    log(f"[gluon_hybrid_resnet50] {ghyb['ms_per_step']:.2f} ms/step "
        f"(eager {gres['ms_per_step']:.2f}) peak "
        f"{ghyb['peak_mem_gib']:.2f} GiB, idle "
        f"{ghyb['profile_3_steps'].get('device_idle_share')}, fused "
        f"backward {ghyb['bnreluconv_dact_kernels_3_profiled_steps']} in 3 "
        f"replayed steps, graphed vs eager "
        f"{ghyb['graphed_vs_eager_max_abs']} (eager twice "
        f"{ghyb['eager_vs_eager_max_abs']}) "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gexp = gluon_export_resnet50_phase(workdir)
    log(f"[gluon_export_resnet50] predict ms {gexp['predict_ms']}, "
        f"agreement {gexp['agreement']} "
        f"({time.perf_counter() - t0:.1f} s)")

    del gexp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sres, served = serve_resnet50_phase(workdir)
    for kind, s in sres["servers"].items():
        busy = s["levels"][-1]
        log(f"[serve_resnet50] {kind}: buckets {s['buckets']}, captures "
            f"{s['captures_at_warmup']} at warm-up, "
            f"{s['captures_after_warmup']} after; busiest "
            f"{busy['requests_s']:.1f} req/s, idle "
            f"{busy.get('profile', {}).get('device_idle_share')}")
    shttp = serve_http_phase(served)
    log(f"[serve_http] predict host ms {shttp['predict_ms_host']}")
    t1 = time.perf_counter()
    straced = serve_traced_phase(served)
    log(f"[serve_traced] {time.perf_counter() - t1:.1f} s")
    del straced
    torch.cuda.empty_cache()
    fleet = fleet_host_phase(workdir, served)
    log(f"[serve phases] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qres, quant = quantize_resnet50_phase(workdir, served)
    del served
    torch.cuda.empty_cache()
    sq = serve_resnet50_int8_phase(workdir, quant)
    del quant
    for arm, s in sq["servers"].items():
        busy = s["levels"][-1]
        log(f"[serve_resnet50_int8] {arm}: busiest {busy['requests_s']:.1f}"
            f" req/s p50 {busy['p50_ms']:.2f} p99 {busy['p99_ms']:.2f} ms, "
            f"idle {busy.get('profile', {}).get('device_idle_share')}")
    torch.cuda.empty_cache()
    ares = amp_gluon_resnet50_phase(gres)
    log(f"[amp_gluon_resnet50] {ares['ms_per_step']:.2f} ms/step under "
        f"AMP, fp32 {ares['fp32_ms_per_step_same_net']:.2f}, bf16 cast "
        f"{gres['ms_per_step']:.2f}; overflow "
        f"{ares['planted_overflow']}")
    log(f"[quantized phases] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mres = module_resnet50_phase(plugin)
    log(f"[module_resnet50] {mres['ms_per_step']:.2f} ms/step "
        f"{mres['img_s']:.1f} img/s peak {mres['peak_mem_gib']:.2f} GiB, "
        f"update() {mres['update_host_ms']:.2f} host ms, losses "
        f"{mres['losses']} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mcvc = module_cuda_vs_cpu_phase()
    log(f"[module_cuda_vs_cpu] loss rel {mcvc['loss_rel']:.2e}, closest "
        f"{mcvc['closest_to_limit']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    mfit = module_fit_phase(workdir)
    log(f"[module_fit] val acc {mfit['val_acc']:.4f}, host predict "
        f"{mfit['card_vs_host_predict_max_abs']:.2e} "
        f"({time.perf_counter() - t0:.1f} s)")
    sbrc = symbol_bnreluconv_phase()
    for c in sbrc["cases"]:
        log(f"[symbol_bnreluconv] {c['dtype']} launches "
            f"{c['launches_per_forward_backward']} rel "
            f"{c['rel_err_vs_plain']} fwd+bwd {c['forward_backward_ms']:.3f}"
            f" ms")

    torch.cuda.empty_cache()
    vgg = train_vgg16_phase()
    prof = vgg["profile_3_steps"]
    log(f"[train_vgg16] {vgg['ms_per_step']:.2f} ms/step "
        f"{vgg['img_s']:.1f} img/s peak {vgg['peak_mem_gib']:.2f} GiB, "
        f"idle {prof.get('device_idle_share')}, {vgg['buckets']} buckets "
        f"(largest {vgg['largest_bucket']}), losses {vgg['losses']}")
    torch.cuda.empty_cache()
    # the bucket kernel at VGG-16's largest bucket (fc6's weight)
    vgg_sgd = bucket_case(vgg["largest_bucket"], "float32", 0.9,
                          "vgg16_bucket", 205)
    log(f"[bucket_sgd] n={vgg_sgd['n']} ms={vgg_sgd['ms']:.4f} "
        f"plain={vgg_sgd['plain_ms']:.4f} "
        f"fused_sgd={vgg_sgd['library_ms']:.4f} "
        f"bound={vgg_sgd['bound_ms']:.4f}")
    emit({"phase": "kernels_bucket_sgd_vgg16", "cases": [vgg_sgd]})
    torch.cuda.empty_cache()
    zoo = zoo_nets_phase()
    torch.cuda.empty_cache()
    zoo_cuda_vs_cpu_phase()
    rnd = random_ops_phase()
    log(f"[random_ops] mean sigmas "
        f"{[(r['sampler'], round(r['mean_sigmas'], 2)) for r in rnd['samplers']]}")
    oob = oob_indices_phase()
    log(f"[oob_indices] card equals host {oob['card_equals_host']}")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wlm = word_lm_phase()
    log(f"[word_lm] {wlm['ms_per_step']:.2f} ms/step "
        f"{wlm['tokens_s']:.0f} tokens/s peak {wlm['peak_mem_gib']:.2f} GiB,"
        f" trainer.step {wlm['trainer_step_host_ms']:.2f} host ms, idle "
        f"{wlm['profile_3_steps'].get('device_idle_share')}, losses "
        f"{[round(v, 4) for v in wlm['losses']]} "
        f"({time.perf_counter() - t0:.1f} s)")
    del wlm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rcvc = rnn_cuda_vs_cpu_phase()
    log(f"[rnn_cuda_vs_cpu] worst cuDNN "
        f"{max(c['cudnn_vs_host'] for c in rcvc['cases'].values()):.2e}, "
        f"card loop "
        f"{max(c['card_loop_vs_host'] for c in rcvc['cases'].values()):.2e},"
        f" float64 {max(rcvc['float64_cudnn_vs_host'].values()):.2e}, word "
        f"LM loss rel {rcvc['word_lm_3_steps']['loss_rel']:.2e} "
        f"({time.perf_counter() - t0:.1f} s)")
    bkt = lstm_bucketing_phase()
    log(f"[lstm_bucketing] perplexity {bkt['perplexity_first']:.2f} -> "
        f"{bkt['perplexity_last']:.2f}, cuDNN calls {bkt['rnn_cudnn_calls']}"
        f" ({bkt['seconds']:.1f} s)")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssd = train_ssd300_phase()
    fam = ssd["families_3_steps"].get("family_share", {})
    log(f"[train_ssd300] {ssd['ms_per_step']:.2f} ms/step "
        f"{ssd['img_s']:.1f} img/s peak {ssd['peak_mem_gib']:.2f} GiB, idle "
        f"{ssd['profile_3_steps'].get('device_idle_share')}, families "
        f"{ {k: round(v, 4) for k, v in fam.items()} }, MultiBoxTarget "
        f"{ssd['multibox_target_host_ms_in_loop']:.2f} host ms, detect "
        f"{ssd['detect']['ms_per_call']:.2f} ms, losses "
        f"{[round(v, 4) for v in ssd['losses']]} "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssd_detect_host_free_phase()
    dcvc = detection_cuda_vs_cpu_phase()
    log(f"[detection_cuda_vs_cpu] boundary anchors "
        f"{dcvc['cases']['MultiBoxTarget']['boundary_anchors']}, SSD steps "
        f"loss rel {dcvc['ssd_cuda_vs_cpu']['loss_rel']:.2e}, closest "
        f"{dcvc['ssd_cuda_vs_cpu']['closest_to_limit']} "
        f"({time.perf_counter() - t0:.1f} s)")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dres, corpus = data_plane_phase(workdir)
    head_aug = dres["augment_cases"][0]
    log(f"[data_plane] corpus {dres['corpus']['images']} JPEGs, mean "
        f"{dres['corpus']['mean_jpeg_bytes']:.0f} B, encoded in "
        f"{dres['corpus']['encode_s']:.1f} s; augment bit-equal "
        f"{[c['bit_equal'] for c in dres['augment_cases']]}, "
        f"{head_aug['ms']:.4f} ms on the card ("
        f"{head_aug['profiled_launches']} of 20 launches profiled; a call "
        f"back to back "
        f"{head_aug['call_ms']:.4f}, its host work "
        f"{head_aug['host_ms']:.4f}, plain {head_aug['plain_ms']:.3f}, "
        f"bound {head_aug['bound_ms']:.4f}); nvJPEG vs libjpeg "
        f"{ {k: v['max'] for k, v in dres['nvjpeg_vs_libjpeg_fixture'].items()} }"
        f"; manifest {dres['damaged_copy']['entries']}; kv "
        f"{dres['kv_stores']} ({time.perf_counter() - t0:.1f} s)")
    emit(dres)
    t0 = time.perf_counter()
    tim = train_imagenet_phase(corpus)
    log(f"[train_imagenet] fed {tim['fed_ms_per_step']:.2f} ms/step "
        f"{tim['fed_img_s']:.1f} img/s, resident "
        f"{tim['resident_img_s']:.1f} img/s, iterator alone "
        f"{tim['iterator_alone_img_s']:.1f} img/s, feed wait "
        f"{tim['feed_wait_s_per_batch'] * 1e3:.2f} ms and "
        f"{tim['h2d_bytes_per_batch']:.0f} B a batch, idle "
        f"{tim['profile_3_fed_steps'].get('device_idle_share')}, losses "
        f"{[round(v, 3) for v in tim['losses'][:12]]} "
        f"({time.perf_counter() - t0:.1f} s)")
    emit(tim)

    main = [c for c in cases if c["path"].startswith("serve")]
    head = next(c for c in cases if c["path"] == "serve_wide"
                and c["shape"][2] == 2048)
    brc_main = [c for c in brc if c["path"] == "resnet50_stage"]
    brc_head = brc_main[0]  # stage 1, bf16: the largest launch per step
    plain_head = sgd[3]
    lars_head = lars[0]  # the largest bucket

    def entry(name, source, replaces, launches, err, c):
        kind = c["bound_by"]
        res = {"name": name, "route": "cuda",
               "source": f"mxnet_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
               "bound_ms": c["bound_ms"],
               "bound_by": "bytes" if kind == "bytes" else "operations",
               "library_ms": c["library_ms"]}
        if kind not in ("bytes", "operations"):
            res["bound_kind"] = kind  # e.g. operations_3xtf32
        return res

    emit({"kernels": [
        entry("flash_attention", "flash_attention.cu",
              "mxnet_tpu/ops/flash_attention.py:87",
              bench["flash_launches"] + deep["flash_launches"]
              + wide["flash_launches"] + fleet["flash_launches"],
              max(c["max_abs_err"] for c in main), head),
        entry("bnreluconv_bwd", "bnreluconv_bwd.cu",
              "mxnet_tpu/ops/pallas_conv.py:83",
              sum(t["bnreluconv_launches"] for t in trains.values())
              + tel["bnreluconv_launches"]
              + gres["bnreluconv_launches"]
              + sbrc["bnreluconv_launches"],
              max(c["max_abs_err"] for c in brc_main), brc_head),
        entry("bucket_sgd_mom", "bucket_sgd.cu",
              "mxnet_tpu/ops/pallas_opt.py:157",
              sum(t["bucket_sgd_mom_launches"] for t in sgd_trains)
              + tel["bucket_sgd_mom_launches"]
              + zoo["bucket_sgd_mom_launches"]
              + tim["bucket_sgd_mom_launches"], 0.0, sgd[0]),
        # the same kernel at VGG-16's 102.76 M fc6 bucket, its own row
        entry("bucket_sgd_mom_vgg16", "bucket_sgd.cu",
              "mxnet_tpu/ops/pallas_opt.py:157",
              vgg["bucket_sgd_mom_launches"], 0.0, vgg_sgd),
        entry("bucket_sgd", "bucket_sgd.cu",
              "mxnet_tpu/ops/pallas_opt.py:145",
              cvc["sgd0"]["bucket_sgd_launches"], 0.0, plain_head),
        entry("bucket_adam", "bucket_adam.cu",
              "mxnet_tpu/ops/pallas_opt.py:173",
              t_adam["bucket_adam_launches"], 0.0, adam[0]),
        entry("bucket_lars_norms", "bucket_lars.cu",
              "mxnet_tpu/ops/pallas_opt.py:194",
              t_lars["bucket_lars_norms_launches"],
              max(c["slr_max_abs_err"] for c in lars), {
                  "ms": lars_head["ms_norms"] + lars_head["ms_trust"],
                  "plain_ms": lars_head["plain_norms_trust_ms"],
                  "bound_ms": lars_head["bound_norms_ms"],
                  "bound_by": "bytes", "library_ms": None}),
        entry("bucket_lars_update", "bucket_lars.cu",
              "mxnet_tpu/ops/pallas_opt.py:231",
              t_lars["bucket_lars_update_launches"],
              max(c["max_abs_err"] for c in lars), {
                  "ms": lars_head["ms_update_cold"],
                  "plain_ms": lars_head["plain_update_ms"],
                  "bound_ms": lars_head["bound_update_ms"],
                  "bound_by": "bytes", "library_ms": None}),
        entry("scaled_add", "scaled_add.cu",
              "example/plugin/pallas_ops.py:14",
              plug["scaled_add_launches"],
              max(c["max_abs_err"] for c in sa), sa[0]),
        # no TPU kernel: it replaces the host C++ of the reference's
        # decode_augment_batch, after the decode
        entry("image_augment", "image_augment.cu",
              "src/recordio_native.cc:142",
              tim["image_augment_launches"],
              max(c["max_abs_err"] for c in dres["augment_cases"]),
              dict(head_aug, library_ms=None))]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": emit_dev}), flush=True)


# ------------------------------------------------- the symbolic half
def resnet50_v1_symbol(sym, classes=1000, layers=(3, 4, 6, 3),
                       channels=(64, 256, 512, 1024, 2048), softmax=True):
    """ResNet-50 v1 written with ``sym`` calls (``sym`` is the symbol
    namespace of either package): the graph the JAX package's zoo
    ``resnet50_v1()`` traces to when called on ``sym.var("data")`` —
    channel-first, the zoo's biases on the two 1x1 body convolutions,
    its ``resnetv10_*`` parameter names, its op attributes in its order
    — ending in ``SoftmaxOutput`` (``softmax=False`` stops at the
    classifier, which is where the trace stops).  Variables carry no
    attributes; their shapes are inferred from the data."""
    def conv(x, name, num_filter, kernel, stride, pad, bias):
        k, s, p = (kernel,) * 2, (stride,) * 2, (pad,) * 2
        ins = [x, sym.var(f"{name}_weight")]
        if bias:
            ins.append(sym.var(f"{name}_bias"))
        return sym.Convolution(*ins, kernel=k, stride=s, dilate=(1, 1),
                               pad=p, num_filter=num_filter, num_group=1,
                               no_bias=not bias, layout="NCHW")

    def bn(x, name):
        return sym.BatchNorm(
            x, sym.var(f"{name}_gamma"), sym.var(f"{name}_beta"),
            sym.var(f"{name}_running_mean"),
            sym.var(f"{name}_running_var"), axis=1, eps=1e-05,
            momentum=0.9, fix_gamma=False, use_global_stats=False)

    def relu(x):
        return sym.Activation(x, act_type="relu")

    pre = "resnetv10_"
    x = conv(sym.var("data"), f"{pre}conv2d0", channels[0], 7, 2, 3, False)
    x = relu(bn(x, f"{pre}batchnorm0"))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    global_pool=False, pool_type="max",
                    pooling_convention="valid", layout="NCHW")
    for i, n_blocks in enumerate(layers):
        stage, ch = f"{pre}stage{i + 1}_", channels[i + 1]
        nc = nb = 0  # the stage's conv2d and batchnorm counters
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            body = x
            for width, kernel, st, pad, bias in (
                    (ch // 4, 1, stride, 0, True), (ch // 4, 3, 1, 1, False),
                    (ch, 1, 1, 0, True)):
                body = bn(conv(body, f"{stage}conv2d{nc}", width, kernel,
                               st, pad, bias), f"{stage}batchnorm{nb}")
                nc, nb = nc + 1, nb + 1
                if width != ch:
                    body = relu(body)
            residual = x
            if j == 0 and ch != channels[i]:
                residual = bn(conv(x, f"{stage}conv2d{nc}", ch, 1, stride,
                                   0, False), f"{stage}batchnorm{nb}")
                nc, nb = nc + 1, nb + 1
            x = relu(sym.elemwise_add(body, residual))
    x = sym.Pooling(x, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                    global_pool=True, pool_type="avg",
                    pooling_convention="full", layout="NCHW")
    x = sym.FullyConnected(x, sym.var(f"{pre}dense0_weight"),
                           sym.var(f"{pre}dense0_bias"), no_bias=False,
                           num_hidden=classes, flatten=True)
    if not softmax:
        return x
    return sym.SoftmaxOutput(x, sym.var("softmax_label"), name="softmax")


#: the symbolic ResNet-50 phase: the builder's symbol trained by
#: ``mx.mod.Module`` on the card, fp32, channel-first, with SGD
MODULE_RESNET = dict(batch=128, image=224, warmup=2, steps=10, profiled=3,
                     opt=(("learning_rate", 0.1), ("momentum", 0.9),
                          ("wd", 1e-4)))


def kernel_wrappers(plugin=None):
    """Every kernel wrapper, by the kernels line's names; each counts its
    launches in ``.launches``."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import pallas_conv as pc
    from mxnet_tpu_torch.ops import pallas_opt as po

    out = {"flash_attention": fa.flash_attention,
           "bnreluconv_bwd": pc.bnreluconv_bwd,
           "bucket_sgd_mom": po.bucket_sgd_mom,
           "bucket_sgd": po.bucket_sgd, "bucket_adam": po.bucket_adam,
           "bucket_lars_norms": po.bucket_lars_norms,
           "bucket_lars_update": po.bucket_lars_update}
    if plugin is not None:
        out["scaled_add"] = plugin.scaled_add
    return out


def _module_loss(mod, y):
    """Mean cross-entropy from ``SoftmaxOutput``'s probabilities."""
    import torch

    p = mod.get_outputs()[0]._data.float()
    return -torch.log(p.gather(1, y.long().view(-1, 1)).clamp_min(1e-30)) \
        .mean()


def module_resnet50_phase(plugin, seed=0):
    """ResNet-50 v1 (``resnet50_v1_symbol``) trained by ``mx.mod.Module``
    on ``mx.gpu(0)`` (fp32, the process's TF32 settings): ms/step by CUDA
    events over the timed steps, the host time of ``update()`` in the
    loop and alone (its device time too), peak memory, the idle share
    and kernel time by family over profiled steps.  Every kernel count is set to 0 just before the first step
    and read after the last timed one."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray

    cfg = MODULE_RESNET
    batch, image = cfg["batch"], cfg["image"]
    gpu = mx.gpu(0)
    dev = gpu.torch_device()
    torch.manual_seed(seed)  # Xavier's draws
    t0 = time.perf_counter()
    mod = mx.mod.Module(resnet50_v1_symbol(mx.sym), context=gpu)
    mod.bind([("data", (batch, 3, image, image))],
             [("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=cfg["opt"])
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((batch, 3, image, image), generator=gen, device=dev)
    y = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    data = mx.io.DataBatch([NDArray(x)], [NDArray(y.float())])
    ex = mod._exec
    stats0 = {n: a._data.clone() for n, a in ex.aux_dict.items()}
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [], []

    def step(record_host=False):
        mod.forward_backward(data)
        losses.append(_module_loss(mod, y))
        t1 = time.perf_counter()
        mod.update()
        if record_host:
            host_ms.append((time.perf_counter() - t1) * 1e3)

    wrappers = kernel_wrappers(plugin)
    for w in wrappers.values():
        w.launches = 0  # the main path starts here
    for _ in range(cfg["warmup"]):
        step()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(cfg["steps"] + 1)]
    marks[0].record()
    for i in range(cfg["steps"]):
        step(record_host=True)
        marks[i + 1].record()
    marks[-1].synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    moved = sum(not torch.equal(ex.aux_dict[n]._data, v)
                for n, v in stats0.items())
    arrays = [("arg", n, a) for n, a in ex.arg_dict.items()] + \
        [("grad", n, a) for n, a in ex.grad_dict.items()] + \
        [("aux", n, a) for n, a in ex.aux_dict.items()] + \
        [("output", str(i), a) for i, a in enumerate(ex.outputs)]
    off_card = [f"{k}:{n}" for k, n, a in arrays
                if a._data.device != torch.device("cuda", 0)]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t1 = time.perf_counter()
        for _ in range(cfg["profiled"]):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    # update() alone, the device idle before it: its host time without
    # the launch queue's back-pressure, and its device time
    alone_host, alone_dev = [], []
    t_start = torch.cuda.Event(enable_timing=True)
    t_end = torch.cuda.Event(enable_timing=True)
    for _ in range(cfg["profiled"]):
        mod.forward_backward(data)
        torch.cuda.synchronize()
        t_start.record()
        t1 = time.perf_counter()
        mod.update()
        alone_host.append((time.perf_counter() - t1) * 1e3)
        t_end.record()
        t_end.synchronize()
        alone_dev.append(t_start.elapsed_time(t_end))
    losses = [float(v) for v in losses]
    ms_step = marks[0].elapsed_time(marks[-1]) / cfg["steps"]
    res = {
        "phase": "module_resnet50",
        "loop": "mx.mod.Module forward_backward + update (graph executor, "
                "per-parameter updater)",
        "model": {"symbol": "chip_smoke.resnet50_v1_symbol",
                  "layout": "NCHW", "zoo_biases": True,
                  "arguments": len(ex.arg_dict),
                  "auxiliary_states": len(ex.aux_dict)},
        "batch": batch, "image": image, "dtype": "float32",
        "tf32": {"cudnn_conv": torch.backends.cudnn.allow_tf32,
                 "cuda_matmul": torch.backends.cuda.matmul.allow_tf32},
        "optimizer": "sgd", "optimizer_settings": dict(cfg["opt"]),
        "warmup_steps": cfg["warmup"], "timed_steps": cfg["steps"],
        "setup_s": setup_s, "ms_per_step": ms_step,
        "img_s": batch / ms_step * 1e3,
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "update_host_ms": sum(host_ms) / len(host_ms),
        "update_host_ms_each": host_ms,
        "update_alone_host_ms": sum(alone_host) / len(alone_host),
        "update_alone_ms": sum(alone_dev) / len(alone_dev),
        "updated_tensors": len(mod._updater.states), "losses": losses,
        "kernel_launches": counts,
        "moving_stats_moved": f"{moved} of {len(stats0)}",
        "arrays_off_card": off_card,
        "profile_3_steps": device_profile(prof, wall, top=25,
                                          shares=STEP_SHARES),
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"module_resnet50: loss not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"module_resnet50: the loss did not fall: {losses}")
    check(len(stats0) == 106 and moved == 106,
          f"module_resnet50: {moved} of {len(stats0)} moving statistics "
          "moved (106 expected)")
    check(not off_card and len(arrays) > 300,
          f"module_resnet50: arrays off cuda:0: {off_card[:8]}")
    return res


def _module_step_f64(mx, sym, arg, aux, x, y, opt):
    """The Module step in float64 on the host through the same pieces
    (the graph executor, the updater by parameter name, rescale
    1/batch)."""
    import torch

    f64 = torch.float64
    names = list(arg)
    args = {n: mx.nd.NDArray(v._data.to("cpu", f64)) for n, v in arg.items()}
    args["data"] = mx.nd.NDArray(x.to("cpu", f64))
    args["softmax_label"] = mx.nd.NDArray(y.to("cpu", f64))
    ex = sym.bind(mx.cpu(), args,
                  args_grad={n: mx.nd.zeros(args[n].shape, dtype="float64")
                             for n in names},
                  grad_req={n: "write" if n in arg else "null"
                            for n in sym.list_arguments()},
                  aux_states={n: mx.nd.NDArray(v._data.to("cpu", f64))
                              for n, v in aux.items()})
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", param_idx2name={n: n for n in names},
        rescale_grad=1.0 / x.shape[0], **dict(opt)))
    ex.forward(is_train=True)
    ex.backward()
    p = ex.outputs[0]._data
    loss = float(-torch.log(p.gather(1, y.long().view(-1, 1))).mean())
    for n in names:
        upd(n, ex.grad_dict[n], ex.arg_dict[n])
    return loss, ({n: ex.arg_dict[n]._data for n in names},
                  {n: st[0]._data for n, st in upd.states.items()},
                  {n: a._data for n, a in ex.aux_dict.items()})


def _module_step(mx, ctx, sym, arg, aux, x, y, opt):
    """One fp32 ``mx.mod.Module`` step on ``ctx`` from ``arg``/``aux``:
    (loss, (params, momenta, moving statistics))."""
    with ctx:
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([("data", tuple(x.shape))], [("softmax_label",
                                               tuple(y.shape))])
        mod.set_params(arg, aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        dev = ctx.torch_device()
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.NDArray(x.to(dev))], [mx.nd.NDArray(y.to(dev))]))
        loss = float(_module_loss(mod, y.to(dev)))
        mod.update()
        ex = mod._exec
        return loss, ({n: ex.arg_dict[n]._data for n in arg},
                      {n: st[0]._data for n, st in mod._updater.states.items()},
                      {n: a._data for n, a in ex.aux_dict.items()})


def module_cuda_vs_cpu_phase(batch=4, seed=3, n_batches=3):
    """One fp32 Module step of ``resnet50_v1_symbol`` on the card and on
    the host from the same parameters, TF32 off, each parameter's
    update, momentum and moving statistic held as the zoo nets' steps
    are (``CUDA_CPU_TOL``: the card's error against a float64 step no
    more than twice the host's plus 1e-3, on the median over
    ``n_batches`` batches)."""
    import statistics

    import torch

    import mxnet_tpu_torch as mx

    opt = MODULE_RESNET["opt"]
    sym = resnet50_v1_symbol(mx.sym)
    with mx.cpu():
        torch.manual_seed(seed)
        host = mx.mod.Module(sym, context=mx.cpu())
        host.bind([("data", (batch, 3, 224, 224))],
                  [("softmax_label", (batch,))])
        host.init_params(mx.init.Xavier())
        arg, aux = host.get_params()
    runs = []
    for b in range(n_batches):
        gen = torch.Generator().manual_seed(seed + 1 + b)
        x = torch.randn((batch, 3, 224, 224), generator=gen)
        y = torch.randint(0, 1000, (batch,), generator=gen).float()
        r = {"cuda": _module_step(mx, mx.gpu(0), sym, arg, aux, x, y, opt),
             "cpu": _module_step(mx, mx.cpu(), sym, arg, aux, x, y, opt)}
        with mx.cpu():
            r["cpu64"] = _module_step_f64(mx, sym, arg, aux, x, y, opt)
        runs.append({k: (loss, tuple({n: t.to("cpu", torch.float64)
                                      for n, t in d.items()} for d in ds))
                     for k, (loss, ds) in r.items()})
    start = {n: v._data.to(torch.float64) for n, v in arg.items()}
    stats0 = {n: v._data.to(torch.float64) for n, v in aux.items()}
    f64 = runs[0]["cpu64"][1]
    moved = {n: float((f64[0][n] - start[n]).norm()) for n in start}
    whole = math.sqrt(sum(v * v for v in moved.values()))
    trained = [n for n, v in moved.items() if v >= INERT_SHARE * whole]

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-30))

    def errs(r, key):
        run, ref = r[key][1], r["cpu64"][1]
        e = {f"update/{n}": rel(run[0][n] - start[n], ref[0][n] - start[n])
             for n in trained}
        e.update({f"momentum/{n}": rel(run[1][n], ref[1][n])
                  for n in trained})
        e.update({f"moving/{n}": rel(run[2][n] - stats0[n],
                                     ref[2][n] - stats0[n])
                  for n in ref[2]})
        return e

    card = [errs(r, "cuda") for r in runs]
    hosts = [errs(r, "cpu") for r in runs]
    card_m = {k: statistics.median(e[k] for e in card) for k in card[0]}
    host_m = {k: statistics.median(e[k] for e in hosts) for k in hosts[0]}
    over = {k: (card_m[k], host_m[k]) for k in card_m
            if card_m[k] > 2 * host_m[k] + 1e-3}
    loss_rel = max(abs(r["cuda"][0] - r["cpu"][0]) / abs(r["cpu"][0])
                   for r in runs)
    worst = max(card_m, key=lambda k: card_m[k] - 2 * host_m[k])
    res = {"phase": "module_cuda_vs_cpu", "symbol":
           "chip_smoke.resnet50_v1_symbol", "loop": "mx.mod.Module",
           "optimizer_settings": dict(opt), "batch": batch,
           "dtype": "float32", "batches": n_batches,
           "tf32": {"cudnn_conv": torch.backends.cudnn.allow_tf32,
                    "cuda_matmul": torch.backends.cuda.matmul.allow_tf32},
           "loss_cuda": runs[0]["cuda"][0], "loss_cpu": runs[0]["cpu"][0],
           "loss_cpu_f64": runs[0]["cpu64"][0], "loss_rel": loss_rel,
           "held": {"update": len(trained), "momentum": len(trained),
                    "moving_stat": len(runs[0]["cpu64"][1][2])},
           "not_held_inert": sorted(set(moved) - set(trained)),
           "err_cuda_vs_f64_max": max(card_m.values()),
           "err_cpu_vs_f64_max": max(host_m.values()),
           "closest_to_limit": {"quantity": worst,
                                "cuda_vs_f64": card_m[worst],
                                "cpu_vs_f64": host_m[worst]},
           "over_limit": {k: list(v) for k, v in list(over.items())[:8]},
           "tol": CUDA_CPU_TOL}
    emit(res)
    check(len(trained) > 100 and len(runs[0]["cpu64"][1][2]) == 106,
          f"module cuda vs cpu: {len(trained)} parameters held")
    check(loss_rel <= CUDA_CPU_TOL["loss"] and not over,
          f"module cuda vs cpu: loss rel {loss_rel}; over the limit "
          f"(card, host): {dict(list(over.items())[:8])}")
    return res


#: the MLP of ``Module.fit``: 2 epochs on synthetic separable classes
MODULE_FIT = dict(n=1000, n_val=300, features=20, classes=5, batch=64,
                  epochs=2, pred_tol=1e-5)


def _mlp_symbol(sym, classes):
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=64, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.var("softmax_label"), name="softmax")


def module_fit_phase(workdir, seed=0):
    """``Module.fit`` of an MLP on ``mx.gpu(0)`` from host batches
    (``NDArrayIter``: shuffle, ``pad``) with ``Speedometer``,
    ``eval_data`` and ``do_checkpoint``, then ``score`` and ``predict``;
    the card's checkpoint loaded on the host predicts the same outputs
    and saves the same bytes; one ``BucketingModule`` step over two
    buckets that share their weights."""
    import logging

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx

    cfg = MODULE_FIT
    rng = onp.random.RandomState(seed)
    w = rng.randn(cfg["features"], cfg["classes"]).astype("float32")
    x = rng.randn(cfg["n"], cfg["features"]).astype("float32")
    y = (x @ w).argmax(1).astype("float32")
    xv = rng.randn(cfg["n_val"], cfg["features"]).astype("float32")
    yv = (xv @ w).argmax(1).astype("float32")
    onp.random.seed(seed)  # NDArrayIter's shuffle
    torch.manual_seed(seed)  # Xavier's draws
    train = mx.io.NDArrayIter(x, y, batch_size=cfg["batch"], shuffle=True,
                              last_batch_handle="pad")
    val = mx.io.NDArrayIter(xv, yv, batch_size=cfg["batch"])
    prefix = os.path.join(workdir, "module_fit", "mlp")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod = mx.mod.Module(_mlp_symbol(mx.sym, cfg["classes"]),
                        context=mx.gpu(0))
    speed = []

    class _Log(logging.Handler):
        def emit(self, record):
            speed.append(record.getMessage())

    handler = _Log()
    logging.getLogger().addHandler(handler)
    prev = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, eval_metric="acc",
                num_epoch=cfg["epochs"], optimizer="sgd",
                optimizer_params=(("learning_rate", 0.2),
                                  ("momentum", 0.9)),
                initializer=mx.init.Xavier(),
                batch_end_callback=mx.callback.Speedometer(cfg["batch"], 5),
                epoch_end_callback=mx.callback.do_checkpoint(prefix))
    finally:
        logging.getLogger().removeHandler(handler)
        logging.getLogger().setLevel(prev)
    fit_s = time.perf_counter() - t0
    score = mod.score(val, "acc")[0][1]
    pred = mod.predict(val)
    on_card = pred.context == mx.gpu(0)
    last = cfg["epochs"]
    with mx.cpu():
        sym, arg, aux = mx.model.load_checkpoint(prefix, last)
        host = mx.mod.Module(sym, context=mx.cpu())
        host.bind(val.provide_data, val.provide_label, for_training=False)
        host.set_params(arg, aux)
        pred_host = host.predict(val)
        mx.model.save_checkpoint(prefix + "_host", last, sym, arg, aux)
    pred_err = float(onp.abs(pred.asnumpy() - pred_host.asnumpy()).max())
    same_bytes = {}
    for suffix in (f"-{last:04d}.params", "-symbol.json"):
        with open(prefix + suffix, "rb") as f1, \
                open(prefix + "_host" + suffix, "rb") as f2:
            same_bytes[suffix] = f1.read() == f2.read()

    # BucketingModule: two sequence lengths, one classifier
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        pooled = mx.sym.mean(data, axis=1, name=f"pool{seq_len}")
        fc = mx.sym.FullyConnected(pooled, num_hidden=8, name="fc_shared")
        out = mx.sym.SoftmaxOutput(fc, mx.sym.var("softmax_label"),
                                   name="softmax")
        return out, ("data",), ("softmax_label",)

    bmod = mx.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                  context=mx.gpu(0))
    desc = mx.io.DataDesc
    bmod.bind([desc("data", (16, 6, 4))], [desc("softmax_label", (16,))])
    bmod.init_params(mx.init.Xavier())
    bmod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
    w0 = bmod.get_params()[0]["fc_shared_weight"].asnumpy()
    seen = []
    for key in (6, 3):
        b = mx.io.DataBatch(
            [mx.nd.array(rng.randn(16, key, 4), ctx=mx.cpu())],
            [mx.nd.array(rng.randint(0, 8, 16), ctx=mx.cpu())],
            bucket_key=key, provide_data=[desc("data", (16, key, 4))],
            provide_label=[desc("softmax_label", (16,))])
        bmod.forward(b, is_train=True)
        bmod.backward()
        bmod.update()
        seen.append(bmod.get_params()[0]["fc_shared_weight"].asnumpy())
    shared = (bmod._buckets[3]._exec.arg_dict["fc_shared_weight"]
              is bmod._buckets[6]._exec.arg_dict["fc_shared_weight"])
    on_card_b = all(a._data.is_cuda for m in bmod._buckets.values()
                    for a in m._exec.arg_dict.values())
    res = {"phase": "module_fit", **{k: v for k, v in cfg.items()},
           "fit_s": fit_s, "speedometer_lines": [s for s in speed
                                                 if "samples/sec" in s][-3:],
           "val_acc": score, "predict_shape": list(pred.shape),
           "predict_on_card": on_card,
           "card_vs_host_predict_max_abs": pred_err,
           "resaved_bytes_identical": same_bytes,
           "bucketing": {"buckets": sorted(bmod._buckets),
                         "weights_shared": shared,
                         "on_card": on_card_b,
                         "weight_moved": [bool(not onp.array_equal(a, b))
                                          for a, b in zip([w0] + seen[:1],
                                                          seen)]}}
    emit(res)
    check(score >= 0.8, f"module_fit: validation accuracy {score}")
    check(any("samples/sec" in s for s in speed),
          "module_fit: Speedometer logged nothing")
    check(on_card and tuple(pred.shape) == (cfg["n_val"], cfg["classes"]),
          f"module_fit: predictions {pred.shape} on {pred.context}")
    check(pred_err <= cfg["pred_tol"],
          f"module_fit: host predictions differ by {pred_err}")
    check(all(same_bytes.values()),
          f"module_fit: re-saved files differ: {same_bytes}")
    check(shared and on_card_b and all(res["bucketing"]["weight_moved"]),
          f"module_fit: bucketing {res['bucketing']}")
    return res


#: the fused op through a symbol at ResNet-50's stage-1 tail
SYMBOL_BRC = dict(n=128, hw=56, ci=64, co=256)


def symbol_bnreluconv_case(dtype, seed):
    """``sym._contrib_BNReluConv(u, gamma, beta, weight)`` (channel-last)
    bound with ``simple_bind`` on the card: one ``forward(is_train=True)``
    + ``backward()`` must launch the fused backward once; its outputs and
    gradients are held against the same executor's plain version (the
    fused op with the plain pass 1) by ``BRC_TOL``.  Returns the result
    and the main-path launches."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import pallas_conv as pc

    cfg = SYMBOL_BRC
    n, hw, ci, co = cfg["n"], cfg["hw"], cfg["ci"], cfg["co"]
    tdt = getattr(torch, dtype)
    gpu = mx.gpu(0)
    dev = gpu.torch_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    feeds = {"u": torch.randn((n, hw, hw, ci), generator=gen,
                              device=dev).to(tdt),
             "gamma": torch.rand((ci,), generator=gen, device=dev) + 0.5,
             "beta": torch.randn((ci,), generator=gen, device=dev) * 0.3,
             "weight": (torch.randn((co, 1, 1, ci), generator=gen,
                                    device=dev) * 0.05).to(tdt)}
    heads = [torch.randn((n, hw, hw, co), generator=gen,
                         device=dev).to(tdt),
             torch.zeros((ci,), device=dev), torch.zeros((ci,), device=dev)]
    s = mx.sym._contrib_BNReluConv(*[mx.sym.var(k) for k in feeds],
                                   eps=1e-5, fix_gamma=False, name="brc")
    ex = s.simple_bind(gpu, type_dict={k: v.dtype for k, v in feeds.items()},
                       **{k: tuple(v.shape) for k, v in feeds.items()})
    heads_nd = [mx.nd.NDArray(h) for h in heads]

    def run():
        outs = ex.forward(is_train=True, **{
            k: mx.nd.NDArray(v) for k, v in feeds.items()})
        ex.backward(heads_nd)
        return [o._data for o in outs] + [ex.grad_dict[k]._data
                                          for k in feeds]

    n0 = pc.bnreluconv_bwd.launches
    got = [t.clone() for t in run()]
    torch.cuda.synchronize()
    launches = pc.bnreluconv_bwd.launches - n0
    # the plain version: the fused op with the plain pass 1, on the same
    # inputs and head gradients
    ug = {k: v.clone().requires_grad_(True) for k, v in feeds.items()}
    with autotune.force(pallas_bnreluconv="jnp"):
        outs = pc.fused_bn_relu_conv1x1(*ug.values(), eps=1e-5,
                                        fix_gamma=False)
        torch.autograd.backward(list(outs), heads)
    torch.cuda.synchronize()
    check(pc.bnreluconv_bwd.launches - n0 == launches,
          "the plain version launched the kernel")
    want = [o.detach() for o in outs] + [ug[k].grad for k in feeds]
    d_tol, s_tol = BRC_TOL[dtype]
    names = ["y", "batch_mean", "batch_var", "d_u", "d_gamma", "d_beta",
             "d_weight"]
    rel = {k: float((a.float() - r.float()).abs().max()
                    / r.float().abs().max().clamp_min(1e-30))
           for k, a, r in zip(names, got, want)}
    tol = {k: (s_tol if k.startswith(("d_gamma", "d_beta", "d_weight"))
               else d_tol) for k in names}
    ms = time_ms(run, budget_ms=200.0)
    res = {"dtype": dtype, "shape": {"u": [n, hw, hw, ci],
                                     "weight": [co, 1, 1, ci]},
           "m": n * hw * hw, "launches_per_forward_backward": launches,
           "rel_err_vs_plain": rel, "tol": tol,
           "max_abs_err": max(float((a.float() - r.float()).abs().max())
                              for a, r in zip(got, want)),
           "forward_backward_ms": ms,
           "on_card": all(a._data.is_cuda for a in
                          list(ex.arg_dict.values())
                          + list(ex.grad_dict.values()))}
    check(launches == 1, f"symbol_bnreluconv {dtype}: {launches} launches "
          "in one forward + backward")
    check(all(rel[k] <= tol[k] for k in names),
          f"symbol_bnreluconv {dtype}: {rel} over {tol}")
    check(res["on_card"], f"symbol_bnreluconv {dtype}: arrays off the card")
    return res, launches


def symbol_bnreluconv_phase(seed=900):
    """The fused block reached from a symbol, in bf16 and fp32: the
    kernel launches per backward, counted from 0 over the two
    forward + backward calls of the main path."""
    from mxnet_tpu_torch.ops import pallas_conv as pc

    cases, total = [], 0
    for i, dtype in enumerate(("bfloat16", "float32")):
        pc.bnreluconv_bwd.launches = 0  # this case's main path
        res, n = symbol_bnreluconv_case(dtype, seed + i)
        total += n
        cases.append(res)
    out = {"phase": "symbol_bnreluconv", "op": "_contrib_BNReluConv",
           "bound": "simple_bind on mx.gpu(0)", "cases": cases,
           "bnreluconv_launches": total}
    emit(out)
    return out


# ------------------------------------ the random foundation and the zoo
#: VGG-16 as ``example/image-classification/train_imagenet.py`` trains
#: it: the zoo's net (channel-first, 1000 classes, its own Xavier and
#: Normal(0.01) initializers, Dropout 0.5 after both 4096-wide layers)
#: at 224², batch 128 (the example's default), bf16 compute with a
#: dynamic loss scale, SGD with the VGG paper's settings through the
#: sharded-bucket step and the bucket kernel, a fresh key each step
VGG16 = dict(name="vgg16", batch=128, image=224, warmup=2, steps=10,
             profiled=3,
             opt=dict(learning_rate=0.01, momentum=0.9, wd=5e-4))
#: one net of each other family at its full width and input size
#: (image side, image channels, classes), 3 fused steps at batch 32
ZOO_NETS = {"alexnet": (224, 3, 1000), "vgg16_bn": (224, 3, 1000),
            "squeezenet1.1": (224, 3, 1000),
            "densenet121": (224, 3, 1000),
            "inceptionv3": (299, 3, 1000), "mobilenet1.0": (224, 3, 1000),
            "mobilenetv2_1.0": (224, 3, 1000), "lenet": (28, 1, 10)}
ZOO_BATCH, ZOO_STEPS = 32, 3
#: the card-vs-host steps of three zoo families at a small input, fp32,
#: SGD as VGG-16 trains.  MobileNet v2 at 32² ends at 1x1, where a
#: BatchNorm at batch 4 normalizes over four values: its fp32 step is
#: ill-conditioned there (the host's own update of one parameter 7 %
#: off float64, the losses 4e-5 apart), so it runs at 96² (3x3 at the
#: end)
ZOO_CUDA_CPU_STEPS = {
    name: ("sgd", "sgd", VGG16["opt"], name, 3)
    for name in ("vgg11", "squeezenet1.1", "mobilenetv2_1.0")}
ZOO_SMALL_IMAGE = {"vgg11": 32, "squeezenet1.1": 64, "mobilenetv2_1.0": 96}
#: each parameter's update error against float64 where twice the
#: host's + 1e-3 is no limit, read from runs (PERF.md §7).  MobileNet
#: v2's fp32 step is ill-conditioned at init: the error enters at the
#: last BatchNorm (the classifier's weight is within 1.4e-5) and every
#: layer below carries it, so one parameter's host error is no measure
#: of the noise.  Medians over the 3 batches: the host up to 0.61 % (on
#: one batch 1.4 %), the card with cuDNN up to 1.30 % (2.3-3.4x the
#: host's where the host's is above 1e-3; 213x where it is 2.3e-5),
#: the same in three card runs; the float64 pair holds the same step,
#: cuDNN on, to 8.5e-12
ZOO_CUDA_CPU_BOUND = {"mobilenetv2_1.0": 0.02}
#: a sampler's moments are held within this many standard errors of
#: the distribution's, and its KS statistic (continuous samplers) to a
#: p-value above this level, at RANDOM_DRAWS draws
RANDOM_SIGMAS, RANDOM_KS_P, RANDOM_DRAWS = 5.0, 1e-4, 10 ** 6


def zoo_net(name, device, seed, image=None):
    """A zoo net at its full width with the zoo's initializers (Xavier
    where a layer names none), drawn from ``seed`` on the host, its
    deferred shapes resolved from one image of ``image`` (default the
    net's own size)."""
    import torch

    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    side, channels, classes = ZOO_NETS.get(name, (224, 3, 1000))
    side = image or side
    net = get_model(name, classes=classes)
    net.initialize(initializer.Xavier(), device=device,
                   generator=torch.Generator().manual_seed(seed))
    with autograd.pause():
        net.infer_shape(torch.zeros((1, channels, side, side),
                                    device=device))
    return net


class float64_throughout:
    """Within it, the port's BatchNorm and train step keep a float64 step
    float64: as the reference, they round its batch statistics, loss and
    gradients to fp32 (``torch.float32`` in ``ops/nn.py`` and
    ``parallel``), which leaves a float64 step with fp32's error where
    those sums cancel.  Their module's ``torch`` is swapped for one whose
    ``float32`` is float64."""

    def __enter__(self):
        import types

        import torch

        from mxnet_tpu_torch import parallel
        from mxnet_tpu_torch.ops import nn

        class Float64Torch(types.ModuleType):
            def __getattr__(self, name):
                return getattr(torch, "float64" if name == "float32"
                               else name)

        self.mods = (nn, parallel)
        self.saved = [m.torch for m in self.mods]
        for m in self.mods:
            m.torch = Float64Torch("torch")
        return self

    def __exit__(self, *exc):
        for m, t in zip(self.mods, self.saved):
            m.torch = t


class _dropout_draw:
    """Within it, ``_rng.draw_bernoulli`` (Dropout's one draw function)
    is this object's ``draw``."""

    def __enter__(self):
        from mxnet_tpu_torch import _rng

        self.orig, _rng.draw_bernoulli = _rng.draw_bernoulli, self.draw
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch import _rng

        _rng.draw_bernoulli = self.orig


class fed_dropout_masks(_dropout_draw):
    """Dropout takes a mask drawn on the host from ``seed`` (one per
    mask shape, the same in every call), moved to the data's device:
    the card-vs-host steps' masks."""

    def __init__(self, seed):
        self.seed, self.masks = seed, {}

    def draw(self, keep, shape, device, gen):
        import torch

        key = (keep, tuple(shape))
        if key not in self.masks:
            g = torch.Generator().manual_seed(self.seed + len(self.masks))
            self.masks[key] = torch.rand(shape, generator=g) < keep
        return self.masks[key].to(device)


class recorded_dropout_masks(_dropout_draw):
    """Every Dropout mask drawn is also kept (``.masks``, a list per
    ``mark()``)."""

    def __init__(self):
        self.masks = [[]]

    def mark(self):
        self.masks.append([])

    def draw(self, keep, shape, device, gen):
        m = self.orig(keep, shape, device, gen)
        self.masks[-1].append(m.clone())
        return m


def fused_sgd_step(net, opt):
    """``make_train_step``'s step of ``net`` on the card as the zoo
    phases drive it: bf16 compute, dynamic loss scale, the
    sharded-bucket arm on the one-card mesh, SGD ``opt``; returns
    (step_fn, params, state)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss

    return parallel.make_train_step(
        net, loss.SoftmaxCrossEntropyLoss(), "sgd", **opt,
        mesh=parallel.get_mesh(), compute_dtype="bfloat16",
        loss_scale="dynamic", optimizer_sharding="ps")


def train_vgg16_phase(seed=0):
    """VGG-16 (``VGG16``) trained on the card through
    ``parallel.make_train_step`` with the bucket SGD kernel forced:
    warm-up steps, timed steps between CUDA events, then profiled steps
    (device activity only).  Every step takes a fresh key, so its
    Dropout masks differ from the step before; the first two profiled
    steps take one key, and their masks are equal.  The bucket kernel's
    launches are set to 0 just before the first step and read after the
    last timed one: one per bucket and step."""
    import torch

    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import pallas_opt as po

    cfg = VGG16
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    net = zoo_net(cfg["name"], dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x, y = image_batch(cfg["batch"], cfg["name"], gen, dev)
    torch.cuda.reset_peak_memory_stats()
    with autotune.force(fused_bucket_opt=True), \
            recorded_dropout_masks() as rec:
        step_fn, params, state = fused_sgd_step(net, cfg["opt"])
        plan = step_fn.zero_plan
        build_s = time.perf_counter() - t0
        carry = [params, state]

        def step(i, key):
            lv, carry[0], carry[1] = step_fn(*carry, x, y, key,
                                             float(i + 1))
            rec.mark()
            return lv, carry[1]["_loss_scale"][1]

        warm, timed = cfg["warmup"], cfg["steps"]
        po.bucket_sgd_mom.launches = 0
        losses, goods = [], []
        for i in range(warm):
            lv, good = step(i, 1000 + i)
            losses.append(lv)
            goods.append(good)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(warm, warm + timed):
            lv, good = step(i, 1000 + i)
            losses.append(lv)
            goods.append(good)
        end.record()
        end.synchronize()
        launches = po.bucket_sgd_mom.launches
        masks_run = rec.masks[:warm + timed]
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA])
        n = warm + timed
        with prof:
            t1 = time.perf_counter()
            for i, key in enumerate((7, 7, 8)[:cfg["profiled"]]):
                step(n + i, key)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        masks_prof = rec.masks[n:n + cfg["profiled"]]
    total = warm + timed
    losses = [float(v) for v in losses]
    ms_step = start.elapsed_time(end) / timed
    fc = [b.size for b in plan if b.size == max(b.size for b in plan)]
    draws = [len(m) for m in masks_run]
    keep = [float(m.float().mean()) for ms in masks_run for m in ms]
    fresh = all(not torch.equal(a[k], b[k]) for a, b in
                zip(masks_run, masks_run[1:]) for k in range(len(a)))
    same_key = all(torch.equal(a, b) for a, b in
                   zip(masks_prof[0], masks_prof[1]))
    other_key = all(not torch.equal(a, b) for a, b in
                    zip(masks_prof[0], masks_prof[2]))
    res = {
        "phase": "train_vgg16", "model": {"name": cfg["name"],
                                          "classes": 1000},
        "layout": "NCHW", "batch": cfg["batch"], "image": cfg["image"],
        "compute_dtype": "bfloat16", "optimizer": "sgd",
        "optimizer_settings": cfg["opt"], "driver": "make_train_step",
        "keys": "1000 + step; profiled steps 7, 7, 8",
        "warmup_steps": warm, "timed_steps": timed,
        "ms_per_step": ms_step, "img_s": cfg["batch"] / ms_step * 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "buckets": len(plan), "params": sum(b.size for b in plan),
        "largest_bucket": fc[0], "losses": losses,
        "loss_scale": float(carry[1]["_loss_scale"][0]),
        "steps_applied": sum(int(v) > 0 for v in goods),
        "bucket_sgd_mom_launches": launches,
        "dropout_draws_per_step": draws,
        "dropout_keep_share": [min(keep), max(keep)],
        "dropout_masks_fresh_each_step": fresh,
        "dropout_masks_equal_for_one_key": same_key,
        "dropout_masks_differ_for_two_keys": other_key,
        "build_s": build_s,
        "profile_3_steps": device_profile(prof, wall, top=25,
                                          shares=STEP_SHARES),
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"train_vgg16: loss not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"train_vgg16: loss did not fall on the fixed batch: {losses}")
    check(launches == len(plan) * total,
          f"train_vgg16: bucket_sgd_mom launches {launches} != "
          f"{len(plan)} buckets x {total} steps")
    check(draws == [2] * total, f"train_vgg16: Dropout draws {draws}")
    check(fresh, "train_vgg16: a step reused the Dropout masks of the one "
                 "before")
    check(same_key and other_key, "train_vgg16: masks for one key "
          f"equal {same_key}, for two keys differ {other_key}")
    check(all(0.49 < k < 0.51 for k in keep),
          f"train_vgg16: share of kept units {min(keep)}..{max(keep)}")
    return res


def zoo_nets_phase(seed=0):
    """One net of each other family (``ZOO_NETS``) at full width and
    input size, ``ZOO_STEPS`` fused steps at batch ``ZOO_BATCH`` on the
    card as ``train_vgg16`` drives them, the bucket kernel forced;
    ms/step between CUDA events over the steps after the first."""
    import torch

    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import pallas_opt as po

    dev = torch.device("cuda", 0)
    rows = []
    for i, name in enumerate(ZOO_NETS):
        t0 = time.perf_counter()
        net = zoo_net(name, dev, seed + i)
        gen = torch.Generator(device=dev).manual_seed(seed + 50 + i)
        x, y = image_batch(ZOO_BATCH, name, gen, dev)
        torch.cuda.reset_peak_memory_stats()
        with autotune.force(fused_bucket_opt=True):
            step_fn, params, state = fused_sgd_step(net, VGG16["opt"])
            carry, losses = [params, state], []
            po.bucket_sgd_mom.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for s in range(ZOO_STEPS):
                if s == 1:
                    start.record()
                lv, carry[0], carry[1] = step_fn(*carry, x, y, 2000 + s,
                                                 float(s + 1))
                losses.append(lv)
            end.record()
            end.synchronize()
        n_buckets = len(step_fn.zero_plan)
        row = {"net": name, "image": ZOO_NETS[name][0],
               "ms_per_step": start.elapsed_time(end) / (ZOO_STEPS - 1),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "buckets": n_buckets,
               "params": sum(b.size for b in step_fn.zero_plan),
               "bucket_sgd_mom_launches": po.bucket_sgd_mom.launches,
               "losses": [float(v) for v in losses],
               "seconds": time.perf_counter() - t0}
        log(f"[zoo_nets] {name} {row['ms_per_step']:.2f} ms/step, "
            f"{row['buckets']} buckets, losses {row['losses']}")
        rows.append(row)
        del net, step_fn, params, state, carry
        torch.cuda.empty_cache()
    res = {"phase": "zoo_nets", "batch": ZOO_BATCH, "steps": ZOO_STEPS,
           "compute_dtype": "bfloat16", "optimizer_settings": VGG16["opt"],
           "nets": rows,
           "bucket_sgd_mom_launches": sum(r["bucket_sgd_mom_launches"]
                                          for r in rows)}
    emit(res)
    for r in rows:
        check(all(math.isfinite(v) for v in r["losses"]),
              f"zoo_nets: {r['net']} loss not finite: {r['losses']}")
        check(r["bucket_sgd_mom_launches"] == r["buckets"] * ZOO_STEPS,
              f"zoo_nets: {r['net']} bucket launches "
              f"{r['bucket_sgd_mom_launches']} != {r['buckets']} x "
              f"{ZOO_STEPS}")
    return res


def zoo_cuda_vs_cpu_phase(seed=3):
    """``cuda_vs_cpu_phase`` for the zoo families of
    ``ZOO_CUDA_CPU_STEPS`` at a small input, the Dropout masks fed."""
    out = {}
    for i, name in enumerate(ZOO_CUDA_CPU_STEPS):
        image = ZOO_SMALL_IMAGE[name]
        host = zoo_net(name, "cpu", seed + i, image)
        out[name] = cuda_vs_cpu_phase(
            name, host, seed=seed, table=ZOO_CUDA_CPU_STEPS,
            phase="zoo_cuda_vs_cpu", image=image,
            bound=ZOO_CUDA_CPU_BOUND.get(name), float64_pair=True)
        log(f"[zoo_cuda_vs_cpu] {name} loss rel "
            f"{out[name]['loss_rel']:.2e}, closest "
            f"{out[name]['closest_to_limit']}")
    return out


def _moments_check(name, draws, mean, var, tol=RANDOM_SIGMAS):
    """(mean z, variance z): each sample moment's distance from the
    distribution's in standard errors (the variance's from the sample
    fourth central moment)."""
    d = draws.double().reshape(-1)
    n = d.numel()
    m = float(d.mean())
    v = float(d.var())
    m4 = float(((d - m) ** 4).mean())
    z_mean = abs(m - mean) / math.sqrt(var / n)
    z_var = abs(v - var) / math.sqrt(max(m4 - v * v, 1e-30) / n)
    check(z_mean < tol and z_var < tol,
          f"random_ops: {name} mean {m} (want {mean}, {z_mean:.2f} sigma) "
          f"var {v} (want {var}, {z_var:.2f} sigma)")
    return z_mean, z_var


def random_ops_phase(seed=0):
    """The samplers on ``cuda:0``: moments within ``RANDOM_SIGMAS``
    standard errors of the distribution's at ``RANDOM_DRAWS`` draws, a
    KS test for the continuous ones; ``mx.random.seed`` makes a run
    repeat; ``capture_rng``/``restore_rng`` resume the card's stream."""
    import numpy as onp
    import torch
    from scipy import stats

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience.checkpoint import (capture_rng,
                                                       restore_rng)

    ctx, n = mx.gpu(0), RANDOM_DRAWS
    r = mx.nd.random
    mx.random.seed(seed)
    cases = {  # name: (draws, mean, variance, scipy cdf or None)
        "uniform": (r.uniform(-1, 3, shape=(n,), ctx=ctx), 1.0, 16 / 12,
                    stats.uniform(-1, 4).cdf),
        "normal": (r.normal(2, 3, shape=(n,), ctx=ctx), 2.0, 9.0,
                   stats.norm(2, 3).cdf),
        "gamma": (r.gamma(2.5, 1.5, shape=(n,), ctx=ctx), 3.75, 5.625,
                  stats.gamma(2.5, scale=1.5).cdf),
        "exponential": (r.exponential(2.0, shape=(n,), ctx=ctx), 2.0, 4.0,
                        stats.expon(scale=2.0).cdf),
        "poisson": (r.poisson(4.0, shape=(n,), ctx=ctx), 4.0, 4.0, None),
        "negative_binomial": (r.negative_binomial(3, 0.4, shape=(n,),
                                                  ctx=ctx), 4.5, 11.25, None),
        "generalized_negative_binomial": (
            r.generalized_negative_binomial(2.0, 0.5, shape=(n,), ctx=ctx),
            2.0, 4.0, None),
        "randint": (r.randint(-3, 5, shape=(n,), ctx=ctx), 0.5, 63 / 12,
                    None),
        "multinomial": (r.multinomial(mx.nd.array([0.1, 0.2, 0.7],
                                                  ctx=ctx), shape=n),
                        1.6, 0.44, None),
        "sample_normal": (r.normal(mx.nd.array([1.0], ctx=ctx),
                                   mx.nd.array([0.5], ctx=ctx), shape=(n,)),
                          1.0, 0.25, stats.norm(1, 0.5).cdf),
    }
    rows = []
    for name, (arr, mean, var, cdf) in cases.items():
        check(arr.context == ctx, f"random_ops: {name} drew on "
              f"{arr.context}")
        z = _moments_check(name, arr._data, mean, var)
        row = {"sampler": name, "n": arr.size, "dtype": str(arr.dtype),
               "mean_sigmas": z[0], "var_sigmas": z[1]}
        if cdf is not None:
            ks = stats.kstest(arr.asnumpy().reshape(-1), cdf)
            row["ks_p"] = float(ks.pvalue)
            check(ks.pvalue > RANDOM_KS_P, f"random_ops: {name} KS p "
                  f"{ks.pvalue}")
        rows.append(row)
    perm = r.shuffle(mx.nd.arange(1000, ctx=ctx)).asnumpy()
    check(sorted(perm.tolist()) == list(range(1000)),
          "random_ops: shuffle is no permutation")

    def run():
        return onp.concatenate([r.uniform(shape=(64,), ctx=ctx).asnumpy(),
                                r.normal(shape=(64,), ctx=ctx).asnumpy()])

    mx.random.seed(11)
    first = run()
    mx.random.seed(11)
    again = run()
    snap = capture_rng()
    after = run()
    run()
    restore_rng(snap)
    resumed = run()
    res = {"phase": "random_ops", "draws": n, "samplers": rows,
           "tol": {"sigmas": RANDOM_SIGMAS, "ks_p_above": RANDOM_KS_P},
           "seed_repeats": bool((first == again).all()),
           "restore_resumes": bool((after == resumed).all()),
           "rng_devices": sorted(snap["device"]["generators"])}
    emit(res)
    check(res["seed_repeats"], "random_ops: mx.random.seed does not repeat "
                               "a run")
    check(res["restore_resumes"], "random_ops: restore_rng does not resume "
                                  "the card's stream")
    check("cuda:0" in res["rng_devices"], "random_ops: no card generator in "
          f"the captured state: {res['rng_devices']}")
    return res


def oob_indices_phase():
    """Indices out of range on ``cuda:0`` give the host's values (the
    reference's: NaN or a clamped row), then one more launch and a
    synchronize prove that the CUDA context survived."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx

    x = onp.arange(24, dtype=onp.float32).reshape(4, 6)
    w = onp.arange(8, dtype=onp.float32).reshape(4, 2)
    idx = onp.arange(-7, 9, dtype=onp.float32)
    lab = onp.array([0, 2, 7, -1, -4, 3], dtype=onp.float32)

    def calls(ctx):
        nd = mx.nd
        pred = nd.array(onp.linspace(-1, 1, 18).reshape(6, 3), ctx=ctx)
        return {
            "pick": nd.pick(nd.array(x, ctx=ctx),
                            nd.array(idx[:4], ctx=ctx), axis=1),
            "pick_all": nd.pick(nd.array(onp.tile(x[:1], (16, 1)), ctx=ctx),
                                nd.array(idx, ctx=ctx), axis=1),
            "embedding": nd.Embedding(nd.array(idx, ctx=ctx),
                                      nd.array(w, ctx=ctx), input_dim=4,
                                      output_dim=2),
            "gather_nd": nd.gather_nd(
                nd.array(x, ctx=ctx),
                nd.array(onp.stack([idx[:8] / 2, idx[8:]]).round(),
                         ctx=ctx)),
            "softmax_ce": mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                pred, nd.array(lab, ctx=ctx)),
        }

    card = calls(mx.gpu(0))
    torch.cuda.synchronize()
    host = calls(mx.cpu())
    same = {k: bool(onp.array_equal(card[k].asnumpy(), host[k].asnumpy(),
                                    equal_nan=True)
                    if k != "softmax_ce" else
                    onp.allclose(card[k].asnumpy(), host[k].asnumpy(),
                                 rtol=1e-6, atol=1e-6, equal_nan=True))
            for k in card}
    after = torch.ones(1024, device="cuda").sum()
    torch.cuda.synchronize()
    res = {"phase": "oob_indices", "indices": idx.tolist(),
           "card_equals_host": same,
           "nan_counts": {k: int(onp.isnan(v.asnumpy()).sum())
                          for k, v in card.items()},
           "context_alive": float(after) == 1024.0}
    emit(res)
    check(all(same.values()), f"oob_indices: card differs from host: "
          f"{same}")
    check(res["context_alive"], "oob_indices: the card's context died")
    check(all(res["nan_counts"][k] > 0 for k in ("pick", "embedding",
                                                 "softmax_ce")),
          f"oob_indices: no fill value where the reference has NaN: "
          f"{res['nan_counts']}")
    return res


# ------------------------------------------------- the recurrent path
#: the word LM at upstream MXNet's example/gluon/word_language_model
#: train.py defaults (LSTM, 2 x 650, bptt 35, batch 32, dropout 0.5,
#: clip 0.25) at WikiText-2's vocabulary, the repo example's lr 1.0,
#: on its synthetic Markov corpus (WikiText-2 is not in the repo)
WORD_LM = dict(vocab=33278, embed=650, hidden=650, layers=2, bptt=35,
               batch=32, dropout=0.5, lr=1.0, clip=0.25, warmup=2,
               steps=10, profiled=3, corpus=40000)
#: kernel time of a word-LM step by family, by the PyTorch op that
#: launched each kernel (cuDNN's own GEMMs count as cuDNN RNN; every
#: op inside ``trainer.step`` as the update)
RNN_FAMILIES = {
    "cudnn_rnn": ("_cudnn_rnn",),
    "decoder_gemm": ("aten::mm", "aten::addmm", "aten::bmm"),
    "softmax_cross_entropy": ("log_softmax", "aten::gather", "scatter",
                              "nll_loss"),
    "embedding": ("aten::index", "embedding"),
    "weight_packing": ("aten::cat",),
}
#: the RNN op's cases card against host (fp32, TF32 off): (mode, layers,
#: bidirectional, projection, clip) at T 35, N 16, I 96, H 128
RNN_CUDA_CPU_CASES = {
    "lstm": ("lstm", 2, False, None, None),
    "lstm_bi": ("lstm", 2, True, None, None),
    "gru": ("gru", 2, False, None, None),
    "gru_bi": ("gru", 2, True, None, None),
    "rnn_tanh_bi": ("rnn_tanh", 2, True, None, None),
    "rnn_relu": ("rnn_relu", 2, False, None, None),
    "lstmp_bi": ("lstm", 2, True, 64, None),
    "lstm_clip": ("lstm", 2, False, None, 0.5),
}
RNN_CUDA_CPU_SHAPE = dict(T=35, N=16, I=96, H=128)
#: each output, final state and gradient of the card's arms against the
#: host's loop, relative to the tensor's largest magnitude (fp32): read
#: from runs, twice the largest reading (cuDNN's tanh RNN, bidirectional,
#: 4.70e-5; the card's loop at most 3.3e-6)
RNN_CUDA_CPU_TOL = 1e-4
RNN_CUDA_CPU_F64_TOL = 1e-10
#: the word LM card against host: 3 steps at vocabulary 1,000, p = 0
WORD_LM_CUDA_CPU = dict(vocab=1000, embed=200, hidden=200, layers=2,
                        bptt=35, batch=32, steps=3)


def op_family_profile(prof, families, update="trainer.step", ranges=()):
    """Kernel time by family from a torch.profiler run that recorded CPU
    ops and CUDA kernels: each kernel counts for the op that launched
    it (its innermost), and the op for ``"update"`` when it ran inside
    the ``update`` label (a ``record_function``), for a label of
    ``ranges`` when it ran inside that label (the innermost label
    wins), else for the first of ``families`` whose fragments its name
    holds, else ``elementwise_and_other``."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    labels = {update: "update", **{r: r for r in ranges}}
    fam = {k: 0.0 for k in families}
    fam.update({r: 0.0 for r in ranges})
    fam.update(update=0.0, elementwise_and_other=0.0)
    by_op = {}
    for evt in prof.events():
        t_us = getattr(evt, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "self_cuda_time_total", 0.0)
        if t_us <= 0 or getattr(evt, "device_type", cpu) != cpu:
            continue
        by_op[evt.name] = by_op.get(evt.name, 0.0) + t_us
        parent, label = evt.cpu_parent, None
        while parent is not None and label is None:
            label = labels.get(parent.name)
            parent = parent.cpu_parent
        if label is None:
            label = next((k for k, frags in families.items()
                          if any(f in evt.name for f in frags)),
                         "elementwise_and_other")
        fam[label] += t_us
    owned = sum(fam.values())
    if owned <= 0:
        return {"families": "not measured (no op owned device time)"}
    kernels = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if getattr(e, "device_type", cpu) != cpu
                  and e.key not in labels)  # the labels' device ranges
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {"kernel_ms": kernels / 1e3, "owned_by_ops_ms": owned / 1e3,
            "family_ms": {k: v / 1e3 for k, v in fam.items()},
            "family_share": {k: v / owned for k, v in fam.items()},
            "top_ops": [{"op": k, "ms": v / 1e3} for k, v in top]}


def _labelled(fn, label):
    """``fn`` run inside ``torch.profiler.record_function(label)``."""
    import torch

    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return run


def word_lm_phase(seed=0):
    """The port's word LM (``example/word_lm.py``'s ``build`` and
    ``step``) at ``WORD_LM``'s full width on ``mx.gpu(0)``: ms/step and
    tokens/s by CUDA events over 10 steps after 2, the host ms of
    ``trainer.step``, peak memory; a profile of 3 more steps (idle
    share, kernels by name), 3 more with CPU ops (kernel time by
    family), and ``trainer.step`` alone on an idle device.  The RNN
    op's counts are set to 0 just before the first step and read after
    the last timed one."""
    import warnings

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example import word_lm
    from mxnet_tpu_torch.ops import rnn as rnn_op

    cfg = WORD_LM
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    warmup, steps, prof_n = cfg["warmup"], cfg["steps"], cfg["profiled"]
    bptt, batch, vocab = cfg["bptt"], cfg["batch"], cfg["vocab"]
    data = word_lm.batchify(word_lm.synthetic_corpus(vocab, cfg["corpus"]),
                            batch)
    n_batches = warmup + steps + 3 * prof_n
    check(data.shape[0] > bptt * n_batches + 1,
          f"word_lm: corpus too short for {n_batches} batches")
    batches = [(mx.nd.array(data[i:i + bptt], ctx=ctx),
                mx.nd.array(data[i + 1:i + 1 + bptt], ctx=ctx))
               for i in range(0, bptt * n_batches, bptt)]
    onp.random.seed(seed)  # the initializer's draws
    t0 = time.perf_counter()
    model, trainer, loss_fn = word_lm.build(
        vocab, cfg["embed"], cfg["hidden"], cfg["layers"], cfg["dropout"],
        cfg["lr"], cfg["clip"], ctx)
    build_s = time.perf_counter() - t0
    states = model.begin_state(batch, ctx=ctx)
    feed = iter(batches)
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [], []
    rnn_op.cudnn_layer.launches = 0
    rnn_op.loop_layer.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with recorded_dropout_masks() as rec:
            loss, states = word_lm.step(model, trainer, loss_fn,
                                        *next(feed), states)
        losses.append(loss._data.mean())
        for _ in range(warmup - 1):
            loss, states = word_lm.step(model, trainer, loss_fn,
                                        *next(feed), states)
            losses.append(loss._data.mean())
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        marks[0].record()
        for i in range(steps):
            loss, states = word_lm.step(model, trainer, loss_fn,
                                        *next(feed), states, host_ms)
            losses.append(loss._data.mean())
            marks[i + 1].record()
        marks[-1].synchronize()
    mem1 = torch.cuda.memory_stats()
    cudnn_calls = rnn_op.cudnn_layer.launches
    loop_calls = rnn_op.loop_layer.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t1 = time.perf_counter()
        for _ in range(prof_n):
            _, states = word_lm.step(model, trainer, loss_fn, *next(feed),
                                     states)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    by_op = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    trainer.step = _labelled(trainer.step, "trainer.step")
    with by_op:
        for _ in range(prof_n):
            _, states = word_lm.step(model, trainer, loss_fn, *next(feed),
                                     states)
        torch.cuda.synchronize()
    del trainer.step  # the class's method again
    # trainer.step alone, the device idle before it
    alone_host, alone_dev = [], []
    t_start = torch.cuda.Event(enable_timing=True)
    t_end = torch.cuda.Event(enable_timing=True)
    for _ in range(prof_n):
        x, y = next(feed)
        states = word_lm.detach(states)
        with mx.autograd.record():
            out = model(x, *states)
            states = list(out[1:])
            loss = loss_fn(out[0].reshape((-1, vocab)), y.reshape((-1,)))
        loss.backward()
        torch.cuda.synchronize()
        t_start.record()
        t1 = time.perf_counter()
        trainer.step(batch * bptt)
        alone_host.append((time.perf_counter() - t1) * 1e3)
        t_end.record()
        t_end.synchronize()
        alone_dev.append(t_start.elapsed_time(t_end))
    losses = [float(v) for v in losses]
    ms_step = marks[0].elapsed_time(marks[-1]) / steps
    params = model.collect_params()
    devices = sorted({str(p.data()._data.device) for p in params.values()})
    keep = [float(m.float().mean()) for m in rec.masks[0]]
    compaction = [str(w.message) for w in caught
                  if "contiguous chunk" in str(w.message)]
    n_params = sum(p.data().size for p in params.values())
    res = {
        "phase": "word_lm", "loop": "gluon.Trainer (imperative), hybridized",
        "model": "Embedding -> Dropout -> LSTM -> Dropout -> Dense",
        "config": {k: v for k, v in cfg.items()
                   if k not in ("warmup", "steps", "profiled", "corpus")},
        "data": f"synthetic Markov corpus, {cfg['corpus'] + 1} tokens",
        "dtype": "float32",
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "parameters": n_params, "build_s": build_s,
        "warmup_steps": warmup, "timed_steps": steps,
        "ms_per_step": ms_step,
        "tokens_s": batch * bptt / ms_step * 1e3,
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "peak_mem_gib": peak,
        "logits_and_grad_mb": 2 * bptt * batch * vocab * 4 / 1e6,
        "timed_cuda_mallocs": mem1.get("num_device_alloc", 0)
        - mem0.get("num_device_alloc", 0),
        "trainer_step_host_ms": sum(host_ms) / len(host_ms),
        "trainer_step_alone_host_ms": sum(alone_host) / len(alone_host),
        "trainer_step_alone_ms": sum(alone_dev) / len(alone_dev),
        "losses": losses,
        "rnn_cudnn_calls": cudnn_calls, "rnn_loop_calls": loop_calls,
        "dropout_keep_share_step1": keep,
        "weight_compaction_warnings": compaction[:1],
        "parameter_devices": devices,
        "profile_3_steps": device_profile(prof, wall, top=20, shares={
            "cudnn_rnn_kernels": ("RNN", "LSTM", "lstm", "rnn"),
            "elementwise": ("elementwise", "vectorized", "unrolled")}),
        "families_3_steps": op_family_profile(by_op, RNN_FAMILIES),
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"word_lm: loss not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"word_lm: the loss did not fall: {losses}")
    check(cudnn_calls == cfg["layers"] * (warmup + steps) and loop_calls == 0,
          f"word_lm: cuDNN arm {cudnn_calls} calls (want "
          f"{cfg['layers'] * (warmup + steps)}), loop {loop_calls} (want 0)")
    check(len(keep) == 3 and all(0.49 <= k <= 0.51 for k in keep),
          f"word_lm: Dropout keep shares {keep}")
    check(devices == ["cuda:0"], f"word_lm: parameters on {devices}")
    check(not compaction, f"word_lm: cuDNN compacted the weights: "
          f"{compaction[:1]}")
    return res


def _rnn_case_tensors(case, dtype, seed):
    """Inputs, op keywords and head gradients of one
    ``RNN_CUDA_CPU_CASES`` case, on the host."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch.ops import rnn as rnn_op

    mode, layers, bi, proj, clip = RNN_CUDA_CPU_CASES[case]
    s = RNN_CUDA_CPU_SHAPE
    d = 2 if bi else 1
    r = proj or s["H"]
    rs = onp.random.RandomState(seed)
    n = rnn_op.rnn_param_size(mode, layers, s["I"], s["H"], bi, proj)
    arrays = [rs.randn(s["T"], s["N"], s["I"]), rs.randn(n) * 0.1,
              rs.randn(layers * d, s["N"], r)]
    if mode == "lstm":
        arrays.append(rs.randn(layers * d, s["N"], s["H"]))
    kw = dict(state_size=s["H"], num_layers=layers, mode=mode,
              bidirectional=bi, state_outputs=True, projection_size=proj)
    if clip is not None:
        kw.update(lstm_state_clip_min=-clip, lstm_state_clip_max=clip)
    cots = [rs.randn(s["T"], s["N"], d * r), rs.randn(layers * d, s["N"], r)]
    if mode == "lstm":
        cots.append(rs.randn(layers * d, s["N"], s["H"]))
    return ([torch.tensor(a, dtype=dtype) for a in arrays], kw,
            [torch.tensor(c, dtype=dtype) for c in cots])


def _rnn_run(arm, inputs, kw, cots, device, compacted=None):
    """Outputs, final states and input gradients of the RNN op through
    ``arm`` on ``device``, on the host as float64; whether cuDNN
    compacted the weights (its warning) is appended to ``compacted``."""
    import warnings

    import torch

    from mxnet_tpu_torch.ops import rnn as rnn_op

    ts = [t.detach().to(device, copy=True).requires_grad_()
          for t in inputs]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = rnn_op.rnn_arm(arm, *ts, **kw)
        torch.autograd.backward(outs, [c.to(device) for c in cots])
    if compacted is not None:
        compacted.append(any("contiguous chunk" in str(w.message)
                             for w in caught))
    return [t.detach().to("cpu", torch.float64)
            for t in list(outs) + [t.grad for t in ts]]


def _max_rel(got, want):
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def _word_lm_card_host(seed=5):
    """``WORD_LM_CUDA_CPU``'s 3 steps from one host model's weights on
    the card (fp32), the host (fp32) and the host in float64: losses
    and each parameter's update, and the held errors."""
    import copy

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.example import word_lm

    cfg = WORD_LM_CUDA_CPU
    data = word_lm.batchify(word_lm.synthetic_corpus(cfg["vocab"]),
                            cfg["batch"])
    onp.random.seed(seed)
    with mx.cpu():
        host, _, _ = word_lm.build(cfg["vocab"], cfg["embed"], cfg["hidden"],
                                   cfg["layers"], 0.0, ctx=mx.cpu())
        host(mx.nd.array(data[:cfg["bptt"]]),
             *host.begin_state(cfg["batch"], ctx=mx.cpu()))
    runs = {}
    for key, ctx, dtype in (("cuda", mx.gpu(0), "float32"),
                            ("cpu", mx.cpu(), "float32"),
                            ("cpu64", mx.cpu(), "float64")):
        net = copy.deepcopy(host).to(ctx.torch_device())
        net.cast(dtype)
        params = net.collect_params()
        before = {n: p.data()._data.detach().to("cpu", torch.float64,
                                                copy=True)
                  for n, p in params.items()}
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0,
                                                "clip_gradient": 0.25})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        states = net.rnn.begin_state(batch_size=cfg["batch"], ctx=ctx,
                                     dtype=dtype)
        losses = []
        for k in range(cfg["steps"]):
            i = k * cfg["bptt"]
            x = mx.nd.array(data[i:i + cfg["bptt"]], ctx=ctx)
            y = mx.nd.array(data[i + 1:i + 1 + cfg["bptt"]], ctx=ctx)
            loss, states = word_lm.step(net, trainer, loss_fn, x, y, states)
            losses.append(float(loss._data.double().mean()))
        upd = {n: p.data()._data.detach().to("cpu", torch.float64) - before[n]
               for n, p in params.items()}
        runs[key] = (losses, upd)

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-30))

    ref = runs["cpu64"][1]
    card = {n: rel(runs["cuda"][1][n], ref[n]) for n in ref}
    hostr = {n: rel(runs["cpu"][1][n], ref[n]) for n in ref}
    over = {n: (card[n], hostr[n]) for n in ref
            if card[n] > 2 * hostr[n] + 1e-3}
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(runs["cuda"][0], runs["cpu"][0]))
    return {"config": cfg, "losses_cuda": runs["cuda"][0],
            "losses_cpu": runs["cpu"][0], "losses_cpu_f64": runs["cpu64"][0],
            "loss_rel": loss_rel,
            "update_err_cuda_vs_f64": card, "update_err_cpu_vs_f64": hostr,
            "over_limit": over, "tol": CUDA_CPU_TOL}


def rnn_cuda_vs_cpu_phase(seed=7):
    """The RNN op three ways on the same inputs, fp32 with TF32 off: the
    cuDNN arm on the card, the loop on the card and the loop on the
    host (the plain version), every mode, bidirectional, LSTMP and
    the state clip; outputs, final states and the gradients of data,
    parameters and states, each against the host's to
    ``RNN_CUDA_CPU_TOL`` of its largest magnitude.  A float64 pair (the
    cuDNN arm against the host) to ``RNN_CUDA_CPU_F64_TOL``.  Then 3
    word-LM steps card against host, held as the fused steps are."""
    import torch

    from mxnet_tpu_torch.ops import rnn as rnn_op

    cases = {}
    for i, case in enumerate(RNN_CUDA_CPU_CASES):
        inputs, kw, cots = _rnn_case_tensors(case, torch.float32, seed + i)
        host = _rnn_run(rnn_op.loop_layer, inputs, kw, cots, "cpu")
        compacted = []
        cudnn = _rnn_run(rnn_op.cudnn_layer, inputs, kw, cots, "cuda",
                         compacted)
        loop = _rnn_run(rnn_op.loop_layer, inputs, kw, cots, "cuda")
        cases[case] = {"cudnn_vs_host": _max_rel(cudnn, host),
                       "card_loop_vs_host": _max_rel(loop, host),
                       "cudnn_vs_card_loop": _max_rel(cudnn, loop),
                       "cudnn_compacted_weights": compacted[0]}
    f64 = {}
    for i, case in enumerate(("lstm_bi", "gru", "lstmp_bi")):
        inputs, kw, cots = _rnn_case_tensors(case, torch.float64, seed + 20
                                             + i)
        f64[case] = _max_rel(
            _rnn_run(rnn_op.cudnn_layer, inputs, kw, cots, "cuda"),
            _rnn_run(rnn_op.loop_layer, inputs, kw, cots, "cpu"))
    lm = _word_lm_card_host()
    res = {"phase": "rnn_cuda_vs_cpu", "shape": RNN_CUDA_CPU_SHAPE,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "cases": cases, "tol": RNN_CUDA_CPU_TOL,
           "float64_cudnn_vs_host": f64, "float64_tol": RNN_CUDA_CPU_F64_TOL,
           "word_lm_3_steps": lm}
    emit(res)
    worst = max(max(c["cudnn_vs_host"], c["card_loop_vs_host"])
                for c in cases.values())
    check(worst <= RNN_CUDA_CPU_TOL,
          f"rnn_cuda_vs_cpu: {worst} > {RNN_CUDA_CPU_TOL}: {cases}")
    check(max(f64.values()) <= RNN_CUDA_CPU_F64_TOL,
          f"rnn_cuda_vs_cpu: float64 {f64}")
    check(not any(c["cudnn_compacted_weights"] for c in cases.values()),
          f"rnn_cuda_vs_cpu: cuDNN compacted the packed weights: {cases}")
    check(lm["loss_rel"] <= CUDA_CPU_TOL["loss"] and not lm["over_limit"],
          f"rnn_cuda_vs_cpu: word LM loss rel {lm['loss_rel']}, over the "
          f"limit (card, host): {lm['over_limit']}")
    return res


def lstm_bucketing_phase(seed=0):
    """The port's ``lstm_bucketing`` example on ``mx.gpu(0)`` (its
    defaults: 60 steps over buckets 8 and 16): perplexity falls below
    0.8 of where it started, each RNN node runs the cuDNN arm (one call
    a forward, none of the loop), and the shared ``lstm_parameters``
    lie on the card."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example import lstm_bucketing
    from mxnet_tpu_torch.ops import rnn as rnn_op

    onp.random.seed(seed)  # the initializer's draws
    rnn_op.cudnn_layer.launches = 0
    rnn_op.loop_layer.launches = 0
    t0 = time.perf_counter()
    out = lstm_bucketing.train(ctx=mx.gpu(0), log=log)
    seconds = time.perf_counter() - t0
    cudnn, loop = rnn_op.cudnn_layer.launches, rnn_op.loop_layer.launches
    mod = out["module"]
    where = {k: str(mod._buckets[k]._exec.arg_dict["lstm_parameters"]
                    ._data.device) for k in sorted(mod._buckets)}
    shared = len({mod._buckets[k]._exec.arg_dict["lstm_parameters"]
                  ._data.data_ptr() for k in mod._buckets})
    ppl = out["perplexity"]
    steps = len(ppl)
    res = {"phase": "lstm_bucketing", "steps": steps,
           "buckets_seen": sorted(set(out["buckets"])),
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "perplexity_first": ppl[0], "perplexity_last": ppl[-1],
           "perplexity": ppl, "ms_per_step": out["ms_per_step"],
           "seconds": seconds, "rnn_cudnn_calls": cudnn,
           "rnn_loop_calls": loop, "lstm_parameters_device": where,
           "lstm_parameters_tensors": shared,
           "reference_host_run": {"perplexity_first": 31.97,
                                  "perplexity_last": 1.13}}
    emit(res)
    check(ppl[-1] < 0.8 * ppl[0],
          f"lstm_bucketing: perplexity {ppl[0]} -> {ppl[-1]}")
    check(cudnn == steps and loop == 0,
          f"lstm_bucketing: cuDNN arm {cudnn} calls for {steps} steps, "
          f"loop {loop}")
    check(set(where.values()) == {"cuda:0"} and shared == 1,
          f"lstm_bucketing: lstm_parameters on {where}, {shared} tensors")
    return res


# ------------------------------------------------- the detection path
#: upstream MXNet's example/ssd/train.py defaults through the repo's
#: example/ssd/train_ssd.py recipe: VOC's 20 classes, 300², batch 32,
#: SGD lr 0.002 momentum 0.9 wd 5e-4, fp32 (TF32 off); the data is the
#: example's synthetic boxes (VOC is not in the repo), one fixed batch
SSD300 = dict(network="ssd_300_vgg16_reduced", num_classes=20,
              data_shape=300, batch=32, lr=0.002, momentum=0.9, wd=5e-4,
              warmup=2, steps=10, profiled=3, anchors=7478,
              detect_calls=5)
#: kernel time of an SSD step by family, by the PyTorch op that
#: launched each kernel; MultiBoxTarget, the loss and trainer.step by
#: the labelled range they ran in
SSD_FAMILIES = {
    "cudnn_convolution": ("convolution", "cudnn"),
    "pooling": ("pool",),
}
SSD_RANGES = ("multibox_target", "loss")
#: the detection ops on the card against the host: boxes (in [0, 1]),
#: scores and IOUs absolute; the RoI ops' outputs and gradients and
#: Proposal's RoIs (image coordinates, up to 800: an ulp there is
#: 6.1e-5) relative to each tensor's largest magnitude; ids, kept sets,
#: orders and the sort ops exactly
DET_CUDA_CPU_TOL = {"boxes_scores": 1e-5, "roi_rel": 1e-5,
                    "proposal_rel": 1e-5,
                    "ids_kept_sort": "identical",
                    "multibox_target": "positives, loc_mask, positive "
                    "classes identical; loc_target 1e-5; negatives equal "
                    "but within a relative 1e-6 of the num_neg-th score"}
#: RoI ops at a Faster R-CNN shape: VGG-16's conv5 of a 600 x 800 image
ROI_CASE = dict(data=(2, 512, 38, 50), rois=128, pooled=(7, 7),
                spatial_scale=1.0 / 16)
PROPOSAL_CASE = dict(a=12, h=38, w=50, rpn_pre_nms_top_n=6000,
                     rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16)


class host_syncs:
    """Counts the host syncs of the work inside: torch's sync debug mode
    set to "warn" and its warnings counted (``count`` after exit)."""

    def __enter__(self):
        import warnings

        import torch

        self._caught = warnings.catch_warnings(record=True)
        self._records = self._caught.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._caught.__exit__(*exc)
        self.count = sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in self._records)


def _ssd_anchor_maps(net, device):
    """The SSD-300 anchors (1, N, 4) on ``device``, from the net's sizes
    and ratios at its six feature-map sides."""
    import torch

    from mxnet_tpu_torch.ops import detection_ops as det

    feats = [torch.zeros(1, 1, s, s, device=device)
             for s in (37, 18, 9, 5, 3, 2)]
    return torch.cat([det.multibox_prior(f, sizes=tuple(net._sizes[i]),
                                         ratios=tuple(net._ratios[i]))
                      for i, f in enumerate(feats)], dim=1)


def train_ssd300_phase(seed=0):
    """The port's SSD example (``example/train_ssd.py``'s ``build`` and
    ``step``) at ``SSD300``'s full width on ``mx.gpu(0)``, one fixed
    batch: ms/step and img/s by CUDA events over 10 steps after 2 (the
    second under torch's sync debug mode around MultiBoxTarget), the
    host ms of ``trainer.step`` and of MultiBoxTarget in the loop, peak
    memory; a profile of 3 more steps (idle share, kernels by name), 3
    more with CPU ops (kernel time by family); MultiBoxTarget alone on
    an idle device; then ``net.detect`` at batch 32 (sync-watched once,
    then timed)."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example import train_ssd

    cfg = SSD300
    ctx = mx.gpu(0)
    classes, batch = cfg["num_classes"], cfg["batch"]
    onp.random.seed(seed)  # the initializer's draws
    t0 = time.perf_counter()
    net, trainer = train_ssd.build(classes, cfg["lr"], cfg["momentum"],
                                   cfg["wd"], cfg["data_shape"], ctx,
                                   cfg["network"])
    build_s = time.perf_counter() - t0
    x, y = train_ssd.synthetic_batch(onp.random.RandomState(seed), batch,
                                     classes, cfg["data_shape"], ctx)
    contrib = mx.nd.contrib
    target = contrib.MultiBoxTarget
    target_ms, syncs = [], []

    def timed_target(*a, **k):
        t = time.perf_counter()
        out = target(*a, **k)
        target_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def watched_target(*a, **k):
        with host_syncs() as hs:
            out = target(*a, **k)
        syncs.append(hs.count)
        return out

    losses, host_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        losses.append(train_ssd.step(net, trainer, x, y, classes)._data)
        contrib.MultiBoxTarget = watched_target  # after the first step
        losses.append(train_ssd.step(net, trainer, x, y, classes)._data)
        contrib.MultiBoxTarget = timed_target
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(cfg["steps"] + 1)]
        marks[0].record()
        for i in range(cfg["steps"]):
            losses.append(train_ssd.step(net, trainer, x, y, classes,
                                         host_ms)._data)
            marks[i + 1].record()
        marks[-1].synchronize()
    finally:
        contrib.MultiBoxTarget = target
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t1 = time.perf_counter()
        for _ in range(cfg["profiled"]):
            train_ssd.step(net, trainer, x, y, classes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    by_op = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    loss_fn = train_ssd.multibox_loss
    contrib.MultiBoxTarget = _labelled(target, "multibox_target")
    train_ssd.multibox_loss = _labelled(loss_fn, "loss")
    trainer.step = _labelled(trainer.step, "trainer.step")
    try:
        with by_op:
            for _ in range(cfg["profiled"]):
                train_ssd.step(net, trainer, x, y, classes)
            torch.cuda.synchronize()
    finally:
        contrib.MultiBoxTarget = target
        train_ssd.multibox_loss = loss_fn
        del trainer.step  # the class's method again
    # the forward's outputs: MultiBoxTarget alone on an idle device, and
    # the detections
    cls_preds, loc_preds, anchors = net(x)
    cls_t = cls_preds.transpose((0, 2, 1))
    alone_host, alone_dev = [], []
    t_start = torch.cuda.Event(enable_timing=True)
    t_end = torch.cuda.Event(enable_timing=True)
    for _ in range(cfg["profiled"]):
        torch.cuda.synchronize()
        t_start.record()
        t1 = time.perf_counter()
        target(anchors, y, cls_t, overlap_threshold=0.5,
               negative_mining_ratio=3.0)
        alone_host.append((time.perf_counter() - t1) * 1e3)
        t_end.record()
        t_end.synchronize()
        alone_dev.append(t_start.elapsed_time(t_end))
    det = net.detect(cls_preds, loc_preds, anchors)  # warm-up
    with host_syncs() as hs:
        det = net.detect(cls_preds, loc_preds, anchors)
    detect_syncs = hs.count
    torch.cuda.synchronize()
    t_start.record()
    t1 = time.perf_counter()
    for _ in range(cfg["detect_calls"]):
        det = net.detect(cls_preds, loc_preds, anchors)
    detect_host = (time.perf_counter() - t1) * 1e3 / cfg["detect_calls"]
    t_end.record()
    t_end.synchronize()
    detect_ms = t_start.elapsed_time(t_end) / cfg["detect_calls"]
    d = det._data.cpu()
    kept = d[d[..., 0] >= 0]
    losses = [float(v) for v in losses]
    ms_step = marks[0].elapsed_time(marks[-1]) / cfg["steps"]
    params = net.collect_params()
    devices = sorted({str(p.data()._data.device) for p in params.values()})
    res = {
        "phase": "train_ssd300", "loop": "gluon.Trainer (imperative)",
        "config": {k: v for k, v in cfg.items()
                   if k not in ("warmup", "steps", "profiled",
                                "detect_calls")},
        "data": "the example's synthetic boxes, one fixed batch",
        "dtype": "float32",
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "parameters": sum(p.data().size for p in params.values()),
        "anchors": int(anchors.shape[1]), "build_s": build_s,
        "warmup_steps": cfg["warmup"], "timed_steps": cfg["steps"],
        "ms_per_step": ms_step, "img_s": batch / ms_step * 1e3,
        "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "peak_mem_gib": peak,
        "trainer_step_host_ms": sum(host_ms) / len(host_ms),
        "multibox_target_host_ms_in_loop": sum(target_ms) / len(target_ms),
        "multibox_target_alone_host_ms": sum(alone_host) / len(alone_host),
        "multibox_target_alone_ms": sum(alone_dev) / len(alone_dev),
        "multibox_target_host_syncs": syncs,
        "losses": losses, "parameter_devices": devices,
        "detect": {"shape": list(d.shape), "ms_per_call": detect_ms,
                   "host_ms_per_call": detect_host,
                   "host_syncs": detect_syncs, "kept": int(len(kept)),
                   "nms_topk": 400},
        "profile_3_steps": device_profile(prof, wall, top=16, shares={
            "cudnn_convolution": ("conv", "cudnn", "implicit", "xmma",
                                  "wgrad", "dgrad"),
            "elementwise": ("elementwise", "vectorized", "unrolled")}),
        "families_3_steps": op_family_profile(by_op, SSD_FAMILIES,
                                              ranges=SSD_RANGES),
    }
    emit(res)
    check(all(math.isfinite(v) for v in losses),
          f"train_ssd300: loss not finite: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"train_ssd300: the loss did not fall: {losses}")
    check(res["anchors"] == cfg["anchors"],
          f"train_ssd300: {res['anchors']} anchors, want {cfg['anchors']}")
    check(devices == ["cuda:0"], f"train_ssd300: parameters on {devices}")
    check(syncs == [0] and detect_syncs == 0,
          f"train_ssd300: host syncs in MultiBoxTarget {syncs}, in "
          f"detect {detect_syncs}")
    check(list(d.shape) == [batch, cfg["anchors"], 6],
          f"train_ssd300: detect gave {list(d.shape)}")
    check(len(kept) > 0 and bool(((kept[:, 1] >= 0) & (kept[:, 1] <= 1))
                                 .all())
          and bool(((kept[:, 2:] >= 0) & (kept[:, 2:] <= 1)).all()),
          f"train_ssd300: {len(kept)} kept detections, scores or boxes "
          f"outside [0, 1]")
    return res


def _ssd_op_inputs(net, batch, seed, device):
    """SSD-300's detection inputs (anchors, labels, class logits,
    softmax probabilities, location predictions, box_nms rows) made on
    the host from ``seed`` and moved to ``device``."""
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example import train_ssd

    n = SSD300["anchors"]
    rs = onp.random.RandomState(seed)
    _, labels = train_ssd.synthetic_batch(rs, batch, SSD300["num_classes"],
                                          8, ctx=mx.cpu())
    logits = torch.from_numpy(rs.randn(batch, 21, n).astype("float32"))
    prob = torch.softmax(logits * 3, dim=1)
    loc = torch.from_numpy((rs.randn(batch, n * 4) * 0.5).astype("float32"))
    xy = torch.from_numpy(rs.rand(batch, n, 2).astype("float32"))
    wh = torch.from_numpy((rs.rand(batch, n, 2) * 0.3 + 0.02)
                          .astype("float32"))
    score = torch.from_numpy(rs.rand(batch, n, 1).astype("float32"))
    score[:, 1::2] = score[:, 0::2]  # ties, pair by pair
    ids = torch.from_numpy(rs.randint(-1, 20, (batch, n, 1))
                           .astype("float32"))
    rows = torch.cat([ids, score, xy, xy + wh], dim=-1)
    anchors = _ssd_anchor_maps(net, "cpu").to(device)
    return {"anchors": anchors, "labels": labels._data.to(device),
            "cls_pred": logits.to(device), "cls_prob": prob.to(device),
            "loc_pred": loc.to(device), "nms_rows": rows.to(device)}


def ssd_detect_host_free_phase(seed=1):
    """MultiBoxDetection (nms_topk 400, threshold 0.01, nms_threshold
    0.45), box_nms (topk 400) and MultiBoxTarget at SSD-300's shapes,
    batch 32, on the card: after a warm-up call, one call under torch's
    sync debug mode (no host sync allowed), one under the profiler
    (device operations per call), then ms and host ms per call."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import detection_ops as det

    net = vision.get_model(SSD300["network"], num_classes=20)
    t = _ssd_op_inputs(net, SSD300["batch"], seed, "cuda")
    calls = {
        "MultiBoxDetection": lambda: det.multibox_detection(
            t["cls_prob"], t["loc_pred"], t["anchors"], nms_topk=400,
            threshold=0.01, nms_threshold=0.45),
        "box_nms": lambda: det.box_nms(
            t["nms_rows"], topk=400, overlap_thresh=0.45,
            valid_thresh=0.01, id_index=0),
        "MultiBoxTarget": lambda: det.multibox_target(
            t["anchors"], t["labels"], t["cls_pred"],
            overlap_threshold=0.5, negative_mining_ratio=3.0),
    }
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with host_syncs() as hs:
            fn()
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(1 for e in prof.events()
                  if getattr(e, "device_type", None) == cuda)
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t1) * 1e3 / reps
        end.record()
        end.synchronize()
        out[name] = {"host_syncs": hs.count,
                     "device_ops_per_call": ops,
                     "ms_per_call": start.elapsed_time(end) / reps,
                     "host_ms_per_call": host}
        log(f"[ssd_detect_host_free] {name}: {out[name]}")
    res = {"phase": "ssd_detect_host_free", "batch": SSD300["batch"],
           "anchors": SSD300["anchors"], "ops": out}
    emit(res)
    check(all(v["host_syncs"] == 0 for v in out.values()),
          f"ssd_detect_host_free: host syncs "
          f"{ {k: v['host_syncs'] for k, v in out.items()} }")
    check(all(v["device_ops_per_call"] > 0 for v in out.values()),
          "ssd_detect_host_free: a call ran nothing on the device")
    return res


def _max_abs(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max()) \
        if a.numel() else 0.0


def _targets_agree(card, host, cls_pred):
    """MultiBoxTarget card against host, by the hard-negative rule:
    (problems, anchors at the num_neg boundary)."""
    import torch

    (c_loc, c_mask, c_cls), (h_loc, h_mask, h_cls) = \
        [[t.cpu() for t in r] for r in (card, host)]
    bad = []
    if not torch.equal(c_mask, h_mask):
        bad.append("loc_mask")
    if not torch.equal(c_cls > 0, h_cls > 0) or not torch.equal(
            c_cls[h_cls > 0], h_cls[h_cls > 0]):
        bad.append("positives")
    if _max_abs(c_loc, h_loc) > DET_CUDA_CPU_TOL["boxes_scores"]:
        bad.append(f"loc_target {_max_abs(c_loc, h_loc)}")
    bg = torch.softmax(cls_pred.cpu().double(), dim=1)[:, 0]
    boundary = 0
    for b in range(h_cls.shape[0]):
        cn, hn = c_cls[b] == 0, h_cls[b] == 0
        differ = (cn != hn).nonzero().flatten()
        if cn.sum() != hn.sum():
            bad.append(f"negative count, image {b}")
        if len(differ):
            edge = bg[b][hn].max()
            if not bool(((bg[b][differ] - edge).abs()
                         <= 1e-6 * edge.abs()).all()):
                bad.append(f"negatives, image {b}")
            boundary += len(differ)
    return bad, boundary


def _roi_inputs(seed):
    """Faster R-CNN's RoI ops inputs on the host: conv5 features and 128
    RoIs in image coordinates (some past the image's edge)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    b, c, h, w = ROI_CASE["data"]
    data = torch.randn(ROI_CASE["data"], generator=g)
    data[1, :, :10, :10] = 0.25  # a tied region
    n = ROI_CASE["rois"]
    scale = 1 / ROI_CASE["spatial_scale"]
    xy = torch.rand(n, 2, generator=g) * torch.tensor([w, h]) * scale
    wh = torch.rand(n, 2, generator=g) * 300 + 8
    rois = torch.cat([torch.randint(0, b, (n, 1), generator=g).float(),
                      xy, xy + wh], dim=1)
    head = torch.randn((n, c) + ROI_CASE["pooled"], generator=g)
    return data, rois, head


def _roi_run(fn, data, rois, head, device, **kw):
    d = data.detach().to(device).requires_grad_()  # a leaf of its own
    out = fn(d, rois.to(device), **kw)
    out.backward(head.to(device))
    return out.detach().cpu(), d.grad.cpu()


def detection_cuda_vs_cpu_phase(seed=2):
    """Each ported detection and sort op on the card against the host on
    the same inputs at SSD-300's shapes (batch 32), the RoI ops and
    their gradients at a Faster R-CNN shape and Proposal at an RPN's
    (``ROI_CASE``, ``PROPOSAL_CASE``), held to ``DET_CUDA_CPU_TOL``;
    then three SSD-300 training steps card against host
    (``ssd_cuda_vs_cpu``)."""
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import detection_ops as det
    from mxnet_tpu_torch.ops import sort_ops

    tol = DET_CUDA_CPU_TOL["boxes_scores"]
    net = vision.get_model(SSD300["network"], num_classes=20)
    host = _ssd_op_inputs(net, SSD300["batch"], seed, "cpu")
    card = {k: v.cuda() for k, v in host.items()}
    cases, bad = {}, []

    def both(fn):
        c = fn(card)
        h = fn(host)
        return c, h

    # the sort ops on tied scores (two decimals) and on signed zeros,
    # infinities and NaNs
    g = torch.Generator().manual_seed(seed)
    tied = torch.round(torch.rand(SSD300["batch"], SSD300["anchors"],
                                  generator=g) * 100) / 100
    pool = torch.tensor([0.0, -0.0, 1.0, -1.0, float("nan"),
                         -float("nan"), float("inf"), -float("inf")])
    special = pool[torch.randint(0, len(pool), (64, 257), generator=g)]
    for label, x in (("tied", tied), ("special", special)):
        for name, fn in (
                ("sort", lambda v: sort_ops.sort(v, is_ascend=False)),
                ("argsort", lambda v: sort_ops.argsort(v)),
                ("topk", lambda v: sort_ops.topk(
                    v, k=min(400, v.shape[-1]), ret_typ="both"))):
            c, h = fn(x.cuda()), fn(x)
            c = c if isinstance(c, tuple) else (c,)
            h = h if isinstance(h, tuple) else (h,)
            same = all(torch.equal(torch.signbit(a.cpu()), torch.signbit(b))
                       and torch.equal(torch.isnan(a.cpu()), torch.isnan(b))
                       and torch.equal(torch.nan_to_num(a.cpu()),
                                       torch.nan_to_num(b))
                       for a, b in zip(c, h))
            cases[f"{name}_{label}"] = {"identical": same}
            if not same:
                bad.append(f"{name}_{label}")
    cases["MultiBoxPrior"] = {"max_abs": _max_abs(
        _ssd_anchor_maps(net, "cuda"), host["anchors"])}
    c, h = both(lambda t: det.multibox_target(
        t["anchors"], t["labels"], t["cls_pred"], overlap_threshold=0.5,
        negative_mining_ratio=3.0))
    problems, boundary = _targets_agree(c, h, host["cls_pred"])
    cases["MultiBoxTarget"] = {"problems": problems,
                               "boundary_anchors": boundary,
                               "positives": int((h[2] > 0).sum())}
    bad += [f"MultiBoxTarget {p}" for p in problems]
    for name, fn in (
            ("MultiBoxDetection", lambda t: det.multibox_detection(
                t["cls_prob"], t["loc_pred"], t["anchors"], nms_topk=400,
                threshold=0.01, nms_threshold=0.45)),
            ("box_nms", lambda t: det.box_nms(
                t["nms_rows"], topk=400, overlap_thresh=0.45,
                valid_thresh=0.01, id_index=0))):
        c, h = both(fn)
        c = c.cpu()
        same = torch.equal(c[..., 0], h[..., 0]) and torch.equal(
            c == -1, h == -1)
        cases[name] = {"ids_kept_identical": same,
                       "max_abs": _max_abs(c, h),
                       "kept": int((h[..., 0] >= 0).sum())}
    c, h = both(lambda t: det.box_iou(t["anchors"][0], t["labels"][0, :, 1:]))
    cases["box_iou"] = {"max_abs": _max_abs(c, h)}
    data, rois, head = _roi_inputs(seed)
    kw = dict(pooled_size=ROI_CASE["pooled"],
              spatial_scale=ROI_CASE["spatial_scale"])
    for name, fn, extra in (("ROIPooling", det.roi_pooling, {}),
                            ("ROIAlign", det.roi_align, {}),
                            ("ROIAlign_aligned", det.roi_align,
                             {"aligned": True, "sample_ratio": 2})):
        t1 = time.perf_counter()
        co, cg = _roi_run(fn, data, rois, head, "cuda", **kw, **extra)
        card_s = time.perf_counter() - t1
        ho, hg = _roi_run(fn, data, rois, head, "cpu", **kw, **extra)
        cases[name] = {"out_rel": _max_rel([co], [ho]),
                       "grad_rel": _max_rel([cg], [hg]), "card_s": card_s}
        if max(cases[name]["out_rel"], cases[name]["grad_rel"]) > \
                DET_CUDA_CPU_TOL["roi_rel"]:
            bad.append(name)
    pc = PROPOSAL_CASE
    g = torch.Generator().manual_seed(seed + 1)
    p_in = [torch.rand(1, 2 * pc["a"], pc["h"], pc["w"], generator=g),
            torch.randn(1, 4 * pc["a"], pc["h"], pc["w"], generator=g) * 0.1,
            torch.tensor([[pc["h"] * 16.0, pc["w"] * 16.0, 1.0]])]
    kw = {k: v for k, v in pc.items() if k.startswith(("rpn", "thr"))}
    c = det.proposal(*[v.cuda() for v in p_in], output_score=True, **kw)
    h = det.proposal(*p_in, output_score=True, **kw)
    cases["Proposal"] = {"rel": _max_rel([a.cpu() for a in c], h),
                         "kept": int((h[0][:, 1:] != 0).any(1).sum())}
    if cases["Proposal"]["rel"] > DET_CUDA_CPU_TOL["proposal_rel"]:
        bad.append("Proposal")
    for name in ("MultiBoxPrior", "MultiBoxDetection", "box_nms",
                 "box_iou"):
        if cases[name]["max_abs"] > tol or not cases[name].get(
                "ids_kept_identical", True):
            bad.append(name)
    steps = _ssd_cuda_vs_cpu(seed)
    res = {"phase": "detection_cuda_vs_cpu", "batch": SSD300["batch"],
           "anchors": SSD300["anchors"], "roi_case": ROI_CASE,
           "proposal_case": PROPOSAL_CASE, "tol": DET_CUDA_CPU_TOL,
           "cases": cases, "ssd_cuda_vs_cpu": steps}
    emit(res)
    check(not bad, f"detection_cuda_vs_cpu: out of bounds: {bad}")
    check(steps["loss_rel"] <= CUDA_CPU_TOL["loss"] and not steps["over"],
          f"ssd_cuda_vs_cpu: loss rel {steps['loss_rel']}, over the limit "
          f"(card, host) {steps['over']}")
    return res


def _ssd_cuda_vs_cpu(seed, batch=4, steps=3):
    """Three SSD-300 steps of the example's recipe from the same weights
    and batch on the card and on the host (fp32, TF32 off) and in
    float64 on the host, held as the zoo's steps are
    (``CUDA_CPU_TOL``): each step's loss to 1e-5; each parameter's whole
    update no farther from the float64 one than twice the host's fp32
    one, plus 1e-3."""
    import copy

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.example import train_ssd
    from mxnet_tpu_torch.ndarray import NDArray

    cfg = SSD300
    with mx.cpu():
        onp.random.seed(seed)
        host_net, _ = train_ssd.build(cfg["num_classes"], cfg["lr"],
                                      data_shape=cfg["data_shape"],
                                      ctx=mx.cpu(), network=cfg["network"])
        x, y = train_ssd.synthetic_batch(
            onp.random.RandomState(seed), batch, cfg["num_classes"],
            cfg["data_shape"], mx.cpu())
    runs = {}
    for key, where, dtype in (("cuda", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cpu64", "cpu", torch.float64)):
        net = copy.deepcopy(host_net).to(where)
        net.cast(str(dtype).replace("torch.", ""))
        params = net.collect_params()
        before = {n: p.data()._data.detach().to("cpu", torch.float64,
                                                copy=True)
                  for n, p in params.items()}
        trainer = gluon.Trainer(params, "sgd", {
            "learning_rate": cfg["lr"], "momentum": cfg["momentum"],
            "wd": cfg["wd"]})
        losses = []
        with float64_throughout() if dtype == torch.float64 else \
                contextlib.nullcontext():
            for _ in range(steps):
                loss = train_ssd.step(net, trainer,
                                      NDArray(x._data.to(where, dtype)),
                                      NDArray(y._data.to(where, dtype)),
                                      cfg["num_classes"])
                losses.append(float(loss._data.double()))
        after = {n: p.data()._data.detach().to("cpu", torch.float64,
                                               copy=True)
                 for n, p in params.items()}
        runs[key] = (losses, {n: after[n] - before[n] for n in after})
        del net, trainer, params
    f64 = runs["cpu64"][1]
    whole = math.sqrt(sum(float(v.norm()) ** 2 for v in f64.values()))
    held = [n for n, v in f64.items() if float(v.norm()) >= INERT_SHARE
            * whole]

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-30))

    card = {n: rel(runs["cuda"][1][n], f64[n]) for n in held}
    hostr = {n: rel(runs["cpu"][1][n], f64[n]) for n in held}
    over = {n: (card[n], hostr[n]) for n in held
            if card[n] > 2 * hostr[n] + 1e-3}
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(runs["cuda"][0], runs["cpu"][0]))
    worst = max(held, key=lambda n: card[n] - 2 * hostr[n])
    return {"batch": batch, "steps": steps, "dtype": "float32",
            "losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
            "losses_cpu_f64": runs["cpu64"][0], "loss_rel": loss_rel,
            "held": len(held), "not_held_inert": sorted(set(f64) - set(held)),
            "err_cuda_vs_f64_max": max(card.values()),
            "err_cpu_vs_f64_max": max(hostr.values()),
            "closest_to_limit": {"parameter": worst,
                                 "cuda_vs_f64": card[worst],
                                 "cpu_vs_f64": hostr[worst]},
            "over": {k: list(v) for k, v in list(over.items())[:8]},
            "tol": CUDA_CPU_TOL}


def resnet50_plan():
    """ResNet-50's flat buckets (the default
    ``MXNET_KVSTORE_BIGARRAY_BOUND`` split), from the shapes alone."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import zero

    import torch

    net = resnet50_v1(classes=1000, layout="NHWC", no_bias=True)
    params = {n: torch.empty(p.shape, device="meta")
              for n, p in net.collect_params().items()}
    return zero.plan_buckets(params, 1)


def zero_segments(bucket, device):
    """``(ids on device, nseg)`` of one bucket, as the ps step makes
    them."""
    from mxnet_tpu_torch.parallel import zero

    ids, nseg = zero.bucket_segments(bucket)
    return ids.to(device), nseg


def main(argv=None):
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file")
    ap.add_argument("--profile", action="store_true",
                    help="profile each serving campaign (kernel time by "
                         "name, device idle share); slows the campaign. "
                         "The training phase always profiles three extra "
                         "steps")
    ap.add_argument("--old-brc", default=None, metavar="SOURCE",
                    help="also time an earlier version of "
                         "csrc/bnreluconv_bwd.cu (same C interface), "
                         "built from SOURCE, at the fused backward's "
                         "stage shapes")
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
    t_script = time.perf_counter()
    try:
        run(profile=args.profile,
            old_brc=args.old_brc and os.path.abspath(args.old_brc),
            workdir=cache_dir)
    except Exception:  # any failed phase fails the run, loudly
        log(traceback.format_exc())
        return 1
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        log(f"chip_smoke: the whole script took "
            f"{time.perf_counter() - t_script:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
