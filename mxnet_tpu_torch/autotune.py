"""Variant autotuner (counterpart of ``mxnet_tpu/autotune.py``).

An op with several lowerings (``VARIANT_OPS``) consults
:func:`variant_choice` when it runs; :func:`tune` races the variants
with a caller-supplied measurement, records the fastest in
``autotune.json`` keyed on (op, shape, dtype, platform, mesh) and
answers later races from that file without re-measuring.  The platform
is ``cuda`` or ``cpu``, so a winner measured on the card never applies
to the host and the reverse.

Decision precedence (``variant_choice``): a :func:`force` scope, then
an explicitly set env override (``MXNET_FLASH_ATTENTION``,
``MXNET_PAGED_ATTENTION``), then the caller's default.

``MXNET_AUTOTUNE``: 0 = off (no race), 1 = consult the cache and race
on a miss (default), 2 = race even on a hit.  Timing on the card is by
CUDA events (:func:`time_call`).
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["VARIANT_OPS", "variant_choice", "force", "tune", "lookup",
           "lookup_entry", "record", "cache_path", "cache_clear",
           "time_call", "autotune_level"]

#: op -> {variant name: forced value}
VARIANT_OPS = {
    # ops/flash_attention.py: "naive" is the plain PyTorch math; the
    # three kernel names of the reference all mean the hand-written
    # kernel on a CUDA tensor
    "flash_attention": {"naive": "naive", "pallas": "pallas",
                        "pallas_b256": "pallas_b256",
                        "pallas_pad": "pallas_pad"},
    # ops/flash_attention.paged_decode_attention: one gather then a
    # dense masked softmax, or an online-softmax walk over the pages
    "paged_decode_attention": {"gather": "gather", "paged": "paged"},
}


def _parse_flash(raw):
    lowered = raw.lower()
    if lowered in ("0", "false", "no", "off", "naive"):
        return "naive"
    if lowered in ("1", "true", "yes", "on", "pallas"):
        return "pallas"
    if lowered in ("pallas_b256", "pallas_pad"):
        return lowered
    return None  # unknown value: no override


def _parse_paged(raw):
    lowered = raw.lower()
    if lowered in ("0", "false", "no", "off", "gather", "dense"):
        return "gather"
    if lowered in ("1", "true", "yes", "on", "paged"):
        return "paged"
    return None


#: env var that explicitly overrides each variant op, with its parser
_ENV_OVERRIDE = {
    "flash_attention": ("MXNET_FLASH_ATTENTION", _parse_flash),
    "paged_decode_attention": ("MXNET_PAGED_ATTENTION", _parse_paged),
}

_tls = threading.local()
_lock = threading.Lock()
_mem = {"path": None, "mtime": None, "entries": {}}


class _Scope:
    def __init__(self, choices):
        self._choices = dict(choices)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "forced", None)
        merged = dict(self._prev or {})
        merged.update(self._choices)
        _tls.forced = merged
        return self

    def __exit__(self, *exc):
        _tls.forced = self._prev


def force(**choices):
    """Scope pinning variant ops to concrete values (wins over
    everything) — the tuner's own scope while it measures a variant."""
    return _Scope(choices)


def variant_choice(op, default=None):
    """The decision an op consults: force scope > env override >
    ``default``."""
    forced = getattr(_tls, "forced", None) or {}
    if op in forced:
        return forced[op]
    env = _ENV_OVERRIDE.get(op)
    if env is not None:
        raw = os.environ.get(env[0])
        if raw is not None:
            parsed = env[1](raw)
            if parsed is not None:
                return parsed
    return default


# ------------------------------------------------------------ the cache
def autotune_level():
    from .config import get_env

    return int(get_env("MXNET_AUTOTUNE"))


def cache_path():
    from .config import get_env

    d = get_env("MXNET_AUTOTUNE_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "mxnet_tpu_torch")
    return os.path.join(d, "autotune.json")


def _key(op, shape, dtype, platform, mesh):
    mesh = "none" if mesh is None else str(mesh)
    return "|".join((op, str(tuple(shape)), str(dtype), platform, mesh))


def _sane_entries(data):
    """The entries dict of a parsed autotune.json with anything a
    corrupt file could smuggle dropped — a corrupt cache can only ever
    cost a re-measurement."""
    entries = data.get("entries", {}) if isinstance(data, dict) else {}
    if not isinstance(entries, dict):
        entries = {}
    return {k: v for k, v in entries.items() if isinstance(v, dict)}


def _load(path):
    """mtime-checked load: winners recorded by another process on the
    same host are visible without restarting."""
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    with _lock:
        if _mem["path"] == path and _mem["mtime"] == mtime:
            return _mem["entries"]
    try:
        with open(path) as f:
            entries = _sane_entries(json.load(f))
    except (OSError, ValueError):
        entries = {}
    with _lock:
        _mem.update(path=path, mtime=mtime, entries=entries)
    return entries


def _save(path, new_entries):
    """Read-merge-write under an exclusive flock and an atomic rename,
    so concurrent tuners lose no winners."""
    import fcntl

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with _lock, open(f"{path}.lock", "a+") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                on_disk = _sane_entries(json.load(f))
        except (OSError, ValueError):
            on_disk = {}
        on_disk.update(new_entries)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": on_disk}, f, indent=1)
        os.replace(tmp, path)
        _mem.update(path=path, entries=on_disk,
                    mtime=os.stat(path).st_mtime_ns)


def lookup_entry(op, shape, dtype, platform, mesh=None):
    return _load(cache_path()).get(_key(op, shape, dtype, platform,
                                        mesh))


def lookup(op, shape, dtype, platform, mesh=None):
    """Cached winner name or None."""
    entry = lookup_entry(op, shape, dtype, platform, mesh)
    return None if entry is None else entry.get("winner")


def record(op, shape, dtype, winner, platform, timings=None, mesh=None):
    """Persist a winner (timings in seconds ride along)."""
    entry = {"winner": winner, "timings": timings or {},
             "recorded": time.time()}
    _save(cache_path(), {_key(op, shape, dtype, platform, mesh): entry})
    return entry


def cache_clear():
    """Drop the in-memory mirror (tests point the cache dir elsewhere)."""
    with _lock:
        _mem.update(path=None, mtime=None, entries={})


# ------------------------------------------------------------- the tuner
def time_call(fn, device, iters=4):
    """Seconds per call of ``fn()`` on ``device``: one warm-up call,
    then ``iters`` calls between two CUDA events on the current stream
    (on the CPU, a host clock around them)."""
    import torch

    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def tune(op, shape, dtype, variants, measure, platform, mesh=None,
         level=None):
    """Race: ``measure(value)`` runs under ``force(op=value)`` for each
    candidate, the fastest wins and is recorded.  A cache hit at level
    1 returns the stored winner without measuring.

    Returns ``(winner_name, report)``; report carries the timings
    (seconds) and whether the cache answered."""
    lvl = autotune_level() if level is None else level
    if lvl < 1:
        return None, {"enabled": False}
    if lvl == 1:
        entry = lookup_entry(op, shape, dtype, platform, mesh)
        if entry is not None and entry.get("winner") in variants:
            return entry["winner"], {"cached": True,
                                     "timings": entry.get("timings", {})}
    timings = {}
    for name, value in variants.items():
        with force(**{op: value}):
            timings[name] = measure(value)
    winner = min(timings, key=timings.get)
    record(op, shape, dtype, winner, platform, timings=timings,
           mesh=mesh)
    return winner, {"cached": False, "timings": timings}
