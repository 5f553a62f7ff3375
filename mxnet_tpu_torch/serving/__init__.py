"""Serving (counterpart of ``mxnet_tpu/serving``): the generative
decode path so far.

* :class:`~mxnet_tpu_torch.serving.kvcache.PagedKVPool` — fixed
  physical KV-page pool under a byte budget, token-budget admission,
  optional int8 storage.
* :class:`~mxnet_tpu_torch.serving.generate.GenerativeServer` —
  prefill/decode disaggregation with token-level continuous batching,
  breaker/shed/drain failure story.
* :class:`~mxnet_tpu_torch.serving.server.ServeRejected` — the
  structured rejection.

Fault points ``serve.admit`` / ``serve.prefill`` / ``serve.decode``
are registered with :mod:`mxnet_tpu_torch.resilience.faultsim` when
this package imports.
"""
from .generate import (  # noqa: F401
    GenerateHandle,
    GenerativeServer,
    params_from_numpy,
    toy_decoder_params,
)
from .kvcache import PagedKVPool  # noqa: F401
from .server import ServeRejected  # noqa: F401

__all__ = ["ServeRejected", "GenerativeServer", "GenerateHandle",
           "PagedKVPool", "toy_decoder_params", "params_from_numpy"]
