#!/usr/bin/env python3
"""Read the image-augment kernel's time on one CUDA card several ways,
several times in one process, with the card's clocks beside them.

    python3 chip_augment_reading.py [--readings N]

On a batch of 128 JPEGs of 500x375 (``chip_smoke.smooth_images``,
encoded and decoded by nvJPEG), resize-short 256 and a random 224x224
crop and mirror, as ``train_imagenet`` feeds it, each reading is one of:
the kernel's device time under ``torch.profiler``, averaged over the
launches the profiler recorded, with its launches spaced by the
wrapper's host work (``image_augment.image_augment``), back to back
from metadata made once, or spaced by 0.8 ms sleeps; and CUDA events
around back-to-back launches from metadata made once (no profiler).
The SM and memory clocks, the power draw and the performance state are
read by ``nvidia-smi`` at idle, during a loop of wrapper calls and
during a loop of back-to-back launches.  Prints one JSON line with
every reading and the bytes bound, then the card's name and power
limit.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,pstate",
          "--format=csv,noheader"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=3)
    args = ap.parse_args(argv)
    import numpy as onp
    import torch

    if not torch.cuda.is_available():
        print("chip_augment_reading: torch sees no CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.io import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia

    _kernels.build(["image_augment", "jpeg_nvjpeg"])
    dev = torch.device("cuda", 0)
    enc = nvjpeg.decoder(dev)
    jpegs = [enc.encode(im, 90, 2)
             for im in cs.smooth_images(128, (375, 500), 0, dev)]
    buf, offs, hs, ws, bad, _ = nvjpeg.decode_batch(jpegs, dev)
    n = len(hs)
    rng = onp.random.RandomState(1)
    cx = rng.rand(n).astype("float32")
    cy = rng.rand(n).astype("float32")
    mir = (rng.rand(n) < 0.5).astype("uint8")
    aug = cs.IMAGENET_AUG
    wrapped = (buf, offs, hs, ws, 224, 224, cx, cy, mir, aug["mean"],
               aug["std"], 256)

    def wrapper():
        ia.image_augment(*wrapped)

    # the wrapper's launch with its metadata made once
    g = ia.plan(hs, ws, 224, 224, cx, cy, 256)
    meta = onp.empty((8, n), onp.int32)
    meta[0], meta[1], meta[2:7], meta[7] = hs, ws, g, mir
    meta_d = torch.from_numpy(meta).to(dev)
    offs_d = torch.from_numpy(onp.asarray(offs, onp.int64)).to(dev)
    out = torch.empty((n, 3, 224, 224), dtype=torch.float32, device=dev)
    fn = ia._kernel()
    norm = [float(v) for v in ia._norm(aug["mean"], 0.0)] \
        + [float(v) for v in ia._norm(aug["std"], 1.0)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw():
        fn(buf.data_ptr(), offs_d.data_ptr(),
           *(meta_d[k].data_ptr() for k in range(8)), out.data_ptr(), n,
           224, 224, *norm, stream)

    def slept():
        raw()
        time.sleep(0.0008)

    raw()
    torch.cuda.synchronize()
    cs.check(torch.equal(out, ia.image_augment(*wrapped)),
             "the raw launch differs from the wrapper's")

    def profiled(fn_, calls):
        """(ms a launch over the launches recorded, launches recorded)."""
        fn_()
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(calls):
                fn_()
            torch.cuda.synchronize()
        seen = [(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0), e.count)
                for e in prof.key_averages() if "augment_kernel" in e.key]
        count = sum(c for _, c in seen)
        return (sum(t for t, _ in seen) / 1e3 / count if count else None,
                count)

    def clocks_during(loop, seconds=2.0):
        probe = subprocess.Popen(["bash", "-c", "sleep 1; "
                                  + " ".join(CLOCKS)],
                                 stdout=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loop()
        torch.cuda.synchronize()
        return probe.communicate(timeout=60)[0].strip()

    idle = subprocess.run(CLOCKS, capture_output=True, text=True,
                          timeout=60).stdout.strip()
    read = {"wrapper_spaced": [], "back_to_back": [], "sleep_spaced": [],
            "events_back_to_back": []}
    recorded = {k: [] for k in read if k != "events_back_to_back"}
    for _ in range(args.readings):
        for key, fn_, calls in (("wrapper_spaced", wrapper, 20),
                                ("back_to_back", raw, 200),
                                ("sleep_spaced", slept, 20)):
            ms, count = profiled(fn_, calls)
            read[key].append(ms)
            recorded[key].append([count, calls])
        read["events_back_to_back"].append(cs.time_ms(raw))
    during_wrapper = clocks_during(wrapper)
    during_raw = clocks_during(lambda: [raw() for _ in range(100)])
    nbytes = cs.augment_read_bytes(hs, ws, g, 224, 224) \
        + n * 3 * 224 * 224 * 4 + n * (8 * 4 + 8)
    bound_ms, bound_by = cs.bound(0.0, nbytes, "float32")
    res = {"kernel": "augment_kernel", "images": n, "source_hw": [375, 500],
           "out": [224, 224], "resize_short": 256, "readings_ms": read,
           "launches_recorded_of_made": recorded,
           "medians_ms": {k: statistics.median(v) for k, v in read.items()
                          if None not in v},
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "clocks_idle": idle, "clocks_wrapper_loop": during_wrapper,
           "clocks_back_to_back_loop": during_raw}
    print(json.dumps(res), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
