#!/usr/bin/env python3
"""Read which cuDNN algorithms the fp32 step of ``cifar10_dist.py``
takes on one CUDA card, and whether cuDNN's own settings move the
step's error against a float64 step.

    python3 chip_cudnn_reading.py [--out FILE]

Under each setting of ``SETTINGS`` (cuDNN's defaults,
``torch.backends.cudnn.deterministic``, ``.benchmark``, both), with TF32
off:

- one recorded step of the example's net (ResNet-18 v1, 3×32×32, batch
  64, fp32) runs under ``torch.profiler``, and the convolution kernels
  it launched are listed by name with their counts;
- the distributed Trainer's ``fp32_example`` run of
  ``tests/torch_dist_trainer_worker.py`` (2 workers on the card, one step
  from the same weights on each of 3 batches) runs under that setting,
  and ``chip_smoke._example_step_errs`` holds it against the host's
  fp32 and float64 runs of the same worker (``--cpu``), as the
  ``dist_trainer`` phase does.

Prints one JSON line with the kernels and the readings of each setting,
then the card's name and power limit.  Exits 2 without a card.  The
script is its own worker: ``--worker torch OUT RUN ...`` runs the
worker's ``train`` for each RUN, a setting's name or one of the
worker's own runs.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import runpy
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "tests", "torch_dist_trainer_worker.py")
#: setting name -> the ``torch.backends.cudnn`` flags it sets
SETTINGS = {"fp32_example": {},
            "fp32_example_det": {"deterministic": True},
            "fp32_example_bench": {"benchmark": True},
            "fp32_example_det_bench": {"deterministic": True,
                                       "benchmark": True}}
#: name fragments of convolution kernels in a profile
CONV_KERNELS = ("conv", "cudnn", "xmma", "winograd", "fft", "implicit",
                "gemm", "wgrad", "dgrad", "fprop")


def _flags(torch, setting):
    flags = SETTINGS.get(setting, {})
    torch.backends.cudnn.deterministic = flags.get("deterministic", False)
    torch.backends.cudnn.benchmark = flags.get("benchmark", False)


def worker(argv):
    """``--worker torch OUT RUN ...``: each RUN of the Trainer's worker,
    a setting trained as its ``fp32_example``."""
    which, out, runs = argv[0], argv[1], argv[2:]
    w = runpy.run_path(WORKER, run_name="torch_dist_trainer_worker")
    for name in SETTINGS:
        w["RUNS"][name] = w["RUNS"]["fp32_example"]
    import torch

    mx, nn_ops, array_mod = w["_package"](which)
    plain = getattr(nn_ops, array_mod)
    rank = None
    for run in runs:
        _flags(torch, run)
        f64 = w["RUNS"][run][0] == "float64"
        setattr(nn_ops, array_mod, w["_Float64"](plain) if f64 else plain)
        rank = w["train"](mx, run, out)
    print(f"[worker {rank}] done", flush=True)
    return 0


def profile_kernels(setting):
    """``{kernel name: launches}`` of the convolution kernels in one
    recorded step under ``setting``."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    _flags(torch, setting)
    gen = torch.Generator().manual_seed(0)
    with mx.gpu(0):
        net = gluon.model_zoo.vision.get_resnet(1, 18, classes=10)
        net.initialize(init=mx.init.Xavier())
        x = mx.nd.array(torch.rand(64, 3, 32, 32, generator=gen).numpy())
        y = mx.nd.array(torch.randint(0, 10, (64,), generator=gen)
                        .float().numpy())
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()

        for _ in range(2):  # cuDNN's choices (and benchmark's timing)
            step()
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step()
            torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if any(s in e.key.lower() for s in CONV_KERNELS)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        return worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_cudnn_reading: torch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import numpy as onp

    if args.out:
        cs._out_file = os.path.abspath(args.out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="chip_cudnn_reading_")
    me = os.path.abspath(__file__)
    card = cs._Launched(cs.DIST_WORKERS,
                        [me, "--worker", "torch", os.path.join(work, "card"),
                         *SETTINGS], env={"OMP_NUM_THREADS": "2"})
    host = cs._Launched(cs.DIST_WORKERS,
                        [me, "--worker", "torch", os.path.join(work, "host"),
                         "fp32_example", "f64_example"], cpu=True,
                        env={"OMP_NUM_THREADS": "2"})
    kernels = {s: profile_kernels(s) for s in SETTINGS}
    _flags(torch, None)
    card.check_ok("the card's runs", "done")
    host.check_ok("the host's runs", "done")

    def batches(side, run):
        out = []
        for path in sorted(glob.glob(os.path.join(
                work, f"{side}.{run}.b*.r0.npz"))):
            with onp.load(path) as f:
                out.append(dict(f))
        return out

    errs = cs._example_step_errs(
        {s: batches("card", s) for s in SETTINGS},
        batches("host", "fp32_example"), batches("host", "f64_example"))
    smi = cs.nvidia_smi_line()
    for s in SETTINGS:
        e = errs[s]
        cs.log(f"[chip_cudnn_reading] {s}: largest update error "
               f"{e['update_err_cuda_vs_f64_max']:.4g} (host "
               f"{e['update_err_cpu_vs_f64_max']:.4g}), over 2 x host + "
               f"1e-3: {e['over_limit']} ({smi})")
    cs.emit({"reading": "chip_cudnn_reading", "settings": SETTINGS,
             "kernels": kernels, "errs": errs, "nvidia_smi": smi})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
