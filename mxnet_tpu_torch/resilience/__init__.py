"""Resilience: the elastic training runtime (counterpart of
``mxnet_tpu/resilience``).

* :mod:`.checkpoint` — atomic, versioned, CRC-verified checkpoints
  with a ``latest`` pointer, previous-good fallback and asynchronous
  snapshots.
* :mod:`.preempt` — SIGTERM/SIGINT drain-to-checkpoint for
  ``Module.fit``.
* :mod:`.faultsim` — deterministic, hit-count-armed fault injection
  (``MXNET_FAULT_SPEC``).
* :mod:`.retry` — the shared bounded exponential-backoff-with-jitter
  helper.
* :mod:`.elastic` — multi-process bring-up over ``torch.distributed``,
  topology-stamped checkpoints and the reshard-on-resize verdict.
* :mod:`.healing` — peer liveness, guarded collectives, the emergency
  checkpoint and the respawn supervisor.

``faultsim``/``retry`` are import-light (hot paths import them); the
rest load lazily because they pull in the ndarray/torch stack.
"""
from . import faultsim  # noqa: F401
from .retry import retry_call  # noqa: F401

__all__ = ["faultsim", "retry_call", "checkpoint", "preempt",
           "elastic", "healing", "CheckpointManager", "PreemptionDrain",
           "atomic_write_bytes", "restore_rng"]


def __getattr__(name):
    if name in ("checkpoint", "preempt", "elastic", "healing"):
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if name in ("CheckpointManager", "atomic_write_bytes",
                "capture_rng", "restore_rng"):
        from . import checkpoint as _ckpt

        val = getattr(_ckpt, name)
        globals()[name] = val
        return val
    if name == "PreemptionDrain":
        from .preempt import PreemptionDrain

        globals()[name] = PreemptionDrain
        return PreemptionDrain
    raise AttributeError(
        f"module 'mxnet_tpu_torch.resilience' has no attribute {name!r}")
