"""Environment-variable registry (counterpart of ``mxnet_tpu/config.py``).

The same ``register_env`` / ``get_env`` contract and the same names and
defaults as the reference, for the variables the ported modules read.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

from .base import MXNetError

__all__ = ["register_env", "get_env", "list_env"]

_ENV: dict[str, "EnvVar"] = {}


@dataclasses.dataclass
class EnvVar:
    name: str
    default: Any
    type: Callable
    doc: str


def register_env(name, default, typ=str, doc=""):
    _ENV[name] = EnvVar(name, default, typ, doc)
    return _ENV[name]


def get_env(name):
    """Typed read of a registered env var (dmlc::GetEnv analog)."""
    if name not in _ENV:
        raise MXNetError(f"env var {name} is not registered")
    ev = _ENV[name]
    raw = os.environ.get(name)
    if raw is None:
        return ev.default
    try:
        if ev.type is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return ev.type(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(f"invalid value {raw!r} for {name}") from e


def list_env():
    return sorted(_ENV)


register_env("MXNET_AUTOTUNE", 1, int,
             "Variant autotuner (mxnet_tpu_torch.autotune): 0 = off, "
             "1 = consult the persisted winner cache and race where "
             "the caller measures, 2 = re-race even on a cache hit.")
register_env("MXNET_AUTOTUNE_CACHE_DIR", "", str,
             "Directory for autotune.json (persisted variant winners). "
             "Empty = ~/.cache/mxnet_tpu_torch.")
register_env("MXNET_FLASH_ATTENTION", "", str,
             "Hand override for the 'flash_attention' variant: "
             "naive/0 (the plain PyTorch math), or pallas/1, "
             "pallas_b256, pallas_pad (all three mean the hand-written "
             "kernel on a CUDA tensor).")
register_env("MXNET_FAULT_SPEC", "", str,
             "Deterministic fault injection spec for "
             "resilience.faultsim, e.g. 'serve.decode:raise@1-2' — "
             "point:action[=value]@hits clauses armed by per-point "
             "hit count.  Empty = disarmed (counters only).")
register_env("MXNET_KV_PAGE_TOKENS", 16, int,
             "Tokens per KV-cache page of the generative decode "
             "server (serving.kvcache.PagedKVPool).")
register_env("MXNET_KV_POOL_BUDGET", 4194304, int,
             "Device byte budget of the paged KV-cache pool: the pool "
             "sizes its physical page count to fit under this many "
             "bytes; admission is by token budget.")
register_env("MXNET_DECODE_SLOTS", 8, int,
             "Decode-slot capacity of the generative server: the "
             "decode step runs over this fixed slot tensor; sequences "
             "are admitted/evicted by in-place slot updates.")
register_env("MXNET_KV_DTYPE", "float32", str,
             "KV-cache storage dtype of the generative server: "
             "'float32' or 'int8' (per-(token, head) symmetric "
             "scales), int8 adopted only if the warmup agreement "
             "probe clears the floor.")
register_env("MXNET_PAGED_ATTENTION", "", str,
             "Hand override for the 'paged_decode_attention' variant: "
             "gather/0 or paged/1.  Unset: the cached winner of the "
             "generative server's warmup race.")
