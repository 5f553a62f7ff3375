"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``_build/lib<name>-<hash>.so``, and loaded with ``ctypes``.  The hash
covers the sources and the flags, so an edited kernel rebuilds and an
unchanged one loads at once.  Builds run under a file lock (several
processes may start together), every missing library's ``nvcc`` starts
at the same time, and a failed build raises with nvcc's stderr.
Nothing here runs at import: a host without ``nvcc`` imports the
package and never calls it.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

__all__ = ["NVCC_FLAGS", "LINK_FLAGS", "sources", "build", "load",
           "build_log"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: libraries a source links against, after the shared flags (a source
#: not named here links against none)
LINK_FLAGS = {"jpeg_nvjpeg": ("-lnvjpeg",)}

_lock = threading.Lock()
_libs = {}


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on "
                     "PATH); the CUDA kernels build on the card's host")


def _key(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if name in LINK_FLAGS:
        h.update(" ".join(LINK_FLAGS[name]).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}-{_key(name)}.so")


def build_log(name):
    """nvcc's output of the last build of ``name`` (ptxas register and
    spill counts), or None."""
    path = _lib_path(name)[:-3] + ".log"
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def build(names=None):
    """Compile every listed source whose library is missing, all at
    once.  Returns ``{name: seconds}`` for what was compiled."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a+") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(_lib_path(n))]
        if not todo:
            return {}
        nvcc = _nvcc()
        started = {}
        for name in todo:
            out = _lib_path(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu"),
                   *LINK_FLAGS.get(name, ())]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, out, time.perf_counter())
        seconds, failed = {}, []
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            with open(out[:-3] + ".log", "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})"
                              f"\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise MXNetError("CUDA kernel build failed:\n" +
                             "\n".join(failed))
        return seconds


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
