"""Runtime feature detection + multi-process bring-up (counterpart of
``mxnet_tpu/runtime.py``).

The reference surfaces build flags (CUDA/CUDNN/NCCL/DIST_KVSTORE/...,
include/mxnet/libinfo.h) through ``mx.runtime.feature_list()``
(python/mxnet/runtime.py).  The port has no compile-time matrix: its
capabilities are the live torch install's, so features are probed at
call time, under the reference's names.

This module is also the front door of the elastic multi-process
runtime: :func:`init_distributed` runs ``resilience.elastic``'s
bring-up, and :func:`distributed_info` reports the live world.
"""
from __future__ import annotations

import collections

__all__ = ["Feature", "feature_list", "Features", "init_distributed",
           "distributed_info"]


def init_distributed(coordinator=None, num_processes=None,
                     process_id=None, **kw):
    """Multi-process bring-up (idempotent).  Resolves the coordinator
    and process identity from args > ``MXNET_COORDINATOR`` /
    ``MXNET_NUM_PROCESSES`` / ``MXNET_PROCESS_ID`` > the ``DMLC_*``
    launcher contract, retries the process-group bring-up with backoff,
    proves the group with a barrier, and returns the
    :class:`~mxnet_tpu_torch.resilience.elastic.ElasticContext`."""
    from .resilience import elastic

    return elastic.elastic_init(coordinator=coordinator,
                                num_processes=num_processes,
                                process_id=process_id, **kw)


def distributed_info():
    """The live elastic context, or None before ``init_distributed``
    (single-process jobs get a local context once initialized)."""
    from .resilience import elastic

    return elastic.context()


class Feature:
    """One named capability flag (reference runtime.py:28 exposes
    ctypes structs; here a plain object with the same attributes)."""

    def __init__(self, name, enabled):
        self._name = name
        self._enabled = bool(enabled)

    @property
    def name(self):
        return self._name

    @property
    def enabled(self):
        return self._enabled

    def __repr__(self):
        if self.enabled:
            return f"✔ {self.name}"
        return f"✖ {self.name}"


def _probe():
    import torch
    import torch.distributed as dist

    feats = collections.OrderedDict()

    def add(name, on):
        feats[name] = Feature(name, on)

    add("CUDA", torch.cuda.is_available())
    add("CUDNN", torch.backends.cudnn.is_available())
    add("NCCL", dist.is_available() and dist.is_nccl_available())
    add("CPU", True)
    add("BF16", True)
    add("INT64_TENSOR_SIZE", True)
    # the dist_* stores: a gloo group over the job's TCPStore
    add("DIST_KVSTORE", dist.is_available() and dist.is_gloo_available())
    from .resilience import elastic

    # enabled = the env asks for multi-process bring-up or it ran
    add("ELASTIC", elastic.elastic_enabled() or elastic.initialized())
    add("SIGNAL_HANDLER", False)
    add("PROFILER", True)
    add("OPENCV", _has_module("cv2"))
    add("MKLDNN", torch.backends.mkldnn.is_available())
    add("TENSORRT", False)
    add("LAPACK", True)  # torch.linalg
    return feats


def _has_module(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


def feature_list():
    """List capabilities of the current runtime (reference
    runtime.py:51)."""
    return list(_probe().values())


class Features(collections.OrderedDict):
    """OrderedDict of name -> Feature (reference runtime.py:65)."""

    def __init__(self):
        super().__init__([(f.name, f) for f in feature_list()])

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown, "
                               "known features are: "
                               f"{list(self.keys())}")
        return self[feature_name].enabled
