"""The structured rejection of the serving path (counterpart of
``ServeRejected`` in ``mxnet_tpu/serving/server.py``)."""
from __future__ import annotations

from ..base import MXNetError
from ..resilience import faultsim

__all__ = ["ServeRejected"]

faultsim.register_point(
    "serve.admit", "serving admission decision (GenerativeServer.submit)")


class ServeRejected(MXNetError):
    """Structured rejection — the load-shedding contract: a request
    the server cannot serve fails fast with a machine-readable
    ``reason``, it never hangs.

    Reasons used by the generative server: ``queue_full``,
    ``token_budget``, ``expired``, ``breaker_open``, ``draining``,
    ``shutdown``, ``model_error``."""

    def __init__(self, reason, detail=""):
        msg = f"request rejected ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason
        self.detail = detail
