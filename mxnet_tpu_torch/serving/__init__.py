"""Serving (counterpart of ``mxnet_tpu/serving``): trained models and
the generative decoder, on the card.

* :class:`~mxnet_tpu_torch.serving.server.ModelServer` — request queue
  + continuous batcher (microbatch size from live queue depth, padded
  to a small set of bucketed batch shapes: on the card one captured
  CUDA graph each), deadline-aware admission control with structured
  load shedding, circuit breaker with probe-driven re-warm, SIGTERM
  drain, readiness/liveness probes, warm start from ``deploy``
  artifacts (``from_artifact``) or from a tuned micro-batch predictor
  (``from_predictor``).
* :class:`~mxnet_tpu_torch.serving.server.ServeRejected` — the
  structured rejection every shed/expired/tripped request receives.
* :class:`~mxnet_tpu_torch.serving.frontend.ServeFrontend` — the HTTP
  front (stdlib ``ThreadingHTTPServer``, JSON bodies) over a server or
  a host.
* :class:`~mxnet_tpu_torch.serving.fleet.ModelHost` — multi-model
  residency under a device-memory budget with zero-downtime swap (load
  beside, warm-probe, cut over between batches, roll back on a failed
  probe); :class:`~mxnet_tpu_torch.serving.fleet.GenerativeHostServer`
  serves a generative artifact there.
* :class:`~mxnet_tpu_torch.serving.kvcache.PagedKVPool` and
  :class:`~mxnet_tpu_torch.serving.generate.GenerativeServer` — the
  generative decode path: a paged KV cache with token-budget admission
  and an int8 gate, prefill (the flash-attention kernel on the card)
  and token-level continuous decode.

Fault points ``serve.admit`` / ``serve.batch`` / ``serve.model`` /
``serve.prefill`` / ``serve.decode`` and ``fleet.swap`` are registered
with :mod:`mxnet_tpu_torch.resilience.faultsim` when this package
imports.  The reference's ``FleetRouter`` (replica processes behind a
router) is ROADMAP §A 10.
"""
from .fleet import (  # noqa: F401
    GenerativeHostServer,
    ModelHost,
    SwapRolledBack,
    artifact_reserved_bytes,
)
from .frontend import ServeFrontend  # noqa: F401
from .generate import (  # noqa: F401
    GenerateHandle,
    GenerativeServer,
    params_from_numpy,
    toy_decoder_params,
)
from .kvcache import PagedKVPool  # noqa: F401
from .server import (  # noqa: F401
    ModelServer,
    ServeHandle,
    ServeRejected,
    default_buckets,
)

__all__ = ["ModelServer", "ServeHandle", "ServeRejected",
           "default_buckets", "ModelHost", "GenerativeHostServer",
           "ServeFrontend", "SwapRolledBack",
           "artifact_reserved_bytes", "GenerativeServer",
           "GenerateHandle", "PagedKVPool", "toy_decoder_params",
           "params_from_numpy"]
