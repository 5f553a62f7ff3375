#!/usr/bin/env python3
"""Read the LARS norms kernel's device time on one CUDA card, cold and
warm, several times in one process.

    python3 chip_lars_reading.py [--readings N]

At ResNet-50's largest flat bucket (2,359,296 fp32 elements, with the
segment ids ``chip_smoke.zero_segments`` gives it), each reading is the
kernel's summed device time over 50 calls under ``torch.profiler``
(``chip_smoke.device_ms``): cold, each call of
``pallas_opt.bucket_lars_norms`` reads one of the rotating copies that
together span four times the L2; warm, every call reads the same
tensors; in sequence, each call runs the norms, trust and update
kernels one after the other on a cold copy (the step's order, and how
``chip_smoke``'s ``kernels_bucket_lars`` phase times the norms kernel).
Prints one JSON line with every reading, the medians and each median's
share of the bytes bound (12 bytes an element over the card's memory
rate), then the card's name and power limit.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_lars_reading: torch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import pallas_opt as po

    dev = torch.device("cuda", 0)
    plan = cs.resnet50_plan()
    big = max(plan, key=lambda b: b.size)
    ids, nseg = cs.zero_segments(big, dev)
    n = ids.numel()
    gen = torch.Generator(device=dev).manual_seed(400)
    w = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev) * 0.01
    hp = dict(cs.LARS_HYPER)
    hp.pop("momentum")
    kw = dict(hp, rescale=1.0, clip=None, with_finite=True)
    m = torch.randn(n, generator=gen, device=dev) * 0.01
    next_set = cs.rotating((w, g))
    next_step = cs.rotating((w, g, m))
    up_kw = dict(wd=hp["wd"], momentum=cs.LARS_HYPER["momentum"],
                 rescale=1.0, clip=None)

    def step():
        ws, gs, ms = next_step()
        slr = po.bucket_lars_norms(ws, gs, ids, nseg, **kw)
        po.bucket_lars_update(ws, gs, ms, ids, slr[0], **up_kw)

    def norms_ms(fn):
        per = cs.device_ms(fn, by_kernel=True)
        return sum(t for k, t in per.items() if "lars_norms_kernel" in k)

    cold, warm, seq = [], [], []
    for _ in range(args.readings):
        cold.append(norms_ms(lambda: po.bucket_lars_norms(
            *next_set(), ids, nseg, **kw)))
        warm.append(norms_ms(lambda: po.bucket_lars_norms(
            w, g, ids, nseg, **kw)))
        seq.append(norms_ms(step))
    bound_ms = cs.bound(4.0 * n, 12.0 * n, "float32")[0]
    res = {"kernel": "lars_norms_kernel", "n": n, "nseg": nseg,
           "cold_ms": cold, "warm_ms": warm, "in_sequence_ms": seq,
           "cold_median_ms": statistics.median(cold),
           "warm_median_ms": statistics.median(warm),
           "in_sequence_median_ms": statistics.median(seq),
           "bound_ms": bound_ms, "bound_by": "bytes",
           "cold_share_of_bound": bound_ms / statistics.median(cold),
           "warm_share_of_bound": bound_ms / statistics.median(warm),
           "in_sequence_share_of_bound": bound_ms / statistics.median(seq),
           "rotating_copies": next_set.n_sets}
    print(json.dumps(res), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
