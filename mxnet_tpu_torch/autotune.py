"""In-step variant autotuner (counterpart of ``mxnet_tpu/autotune.py``).

An op with several lowerings (``VARIANT_OPS``) consults
:func:`variant_choice` when it runs; :func:`tune` races the variants
with a caller-supplied measurement, records the fastest in
``autotune.json`` keyed on (op, shape, dtype, platform, mesh) and
answers later races from that file without re-measuring.  The platform
is ``cuda`` or ``cpu``, so a winner measured on the card never applies
to the host and the reverse.

:func:`tune_train_step` races ops inside the caller's real train step:
each arm's time is the marginal seconds of one chained step
(:func:`chain_time`), because a lowering that wins in isolation can
lose in the step (the reference measured its fused BN-ReLU-conv kernel
at 0.48 against 1.18 ms alone and 54.8 against 46.3 ms in the step).

Decision precedence (``variant_choice``):

  1. a :func:`force` scope — the tuner's own while it measures an arm;
  2. an explicitly set env override (``MXNET_CONV_1X1_DOT``,
     ``MXNET_DTYPE_LADDER``, ``MXNET_BNRELUCONV_VARIANT``,
     ``MXNET_PALLAS_OPT``, ``MXNET_FLASH_ATTENTION``,
     ``MXNET_PAGED_ATTENTION``, ``MXNET_QUANTIZE``);
  3. :func:`program_scope` — the cached winners of the program's input
     signature, applied by the entry points (``make_train_step``'s
     step, a hybridized block's cached call, ``Executor.forward``);
  4. the caller's default.

The card's rosters (:func:`op_variants` on ``cuda``) leave out the arms
that compute a hand-written kernel's plain version (``jnp`` of
``fused_bucket_opt`` and of ``pallas_bnreluconv``, ``naive`` of
``flash_attention``), so no race on the card times them and no cached
winner applies them; a force scope or an env override that names one
stays the user's explicit choice.

``MXNET_AUTOTUNE``: 0 = off (no race, no cached winner), 1 = consult
the cache and race on a miss (default), 2 = race even on a hit.  Timing
on the card is by CUDA events (:func:`time_call`, :func:`chain_time`).
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["VARIANT_OPS", "variant_choice", "force", "program_scope",
           "tune", "tune_train_step", "lookup", "lookup_entry", "record",
           "cache_path", "cache_clear", "last_report", "mesh_desc",
           "dtype_ladder_armed", "ladder_rungs", "chain_time", "time_call",
           "op_variants", "enabled", "autotune_level"]

#: op -> {variant name: forced value}
VARIANT_OPS = {
    # ops/conv.py: a channel-last 1x1 convolution as one matmul over
    # the channel dimension (True) or as a convolution (False)
    "conv1x1_dot": {"conv": False, "dot": True},
    # ops/flash_attention.py: "naive" is the plain PyTorch math; the
    # three kernel names of the reference all mean the hand-written
    # kernel on a CUDA tensor
    "flash_attention": {"naive": "naive", "pallas": "pallas",
                        "pallas_b256": "pallas_b256",
                        "pallas_pad": "pallas_pad"},
    # ops/flash_attention.paged_decode_attention: one gather then a
    # dense masked softmax, or an online-softmax walk over the pages
    "paged_decode_attention": {"gather": "gather", "paged": "paged"},
    # ops/pallas_conv.py: "stock" is the unfused layer path, "jnp" the
    # fused op with the plain backward, "pallas" the fused op with the
    # hand-written backward kernel
    "pallas_bnreluconv": {"stock": "stock", "jnp": "jnp",
                          "pallas": "pallas"},
    # ops/pallas_opt.py: the fused bucket kernel against the plain
    # fused_bucket_update, consulted by parallel.zero
    "fused_bucket_opt": {"jnp": False, "pallas": True},
    # make_train_step's compute dtype: fp32, bf16 (amp_cast_params) or
    # the fp8 rung (e4m3 forward, e5m2 gradient, delayed per-tensor
    # scaling, ops/pallas_opt.fp8_qdq).  Raced and applied only when
    # MXNET_DTYPE_LADDER arms it, and fp8 only where its roster names
    # it (ladder_rungs): a dtype change is not numerics-neutral
    "dtype_ladder": {"fp32": "fp32", "bf16": "bf16", "fp8": "fp8"},
    # quantization/rewrite.py: a rewritten net's QuantizedConv/
    # QuantizedDense run the wrapped fp32 layer (False), the calibrated
    # int8 program (True) or the fp8 one (e4m3 operands, f32
    # accumulation); quantization.tune_quantized races them on the
    # net's real forward
    "quantized_conv": {"fp32": False, "int8": True, "fp8": "fp8"},
    "quantized_fc": {"fp32": False, "int8": True, "fp8": "fp8"},
}

#: the arms of each op that compute a hand-written kernel's plain
#: version: never raced, never applied from the cache on the card
_CARD_DROPS = {"fused_bucket_opt": ("jnp",),
               "pallas_bnreluconv": ("jnp",),
               "flash_attention": ("naive",)}


def _parse_bool(raw):
    return raw.lower() in ("1", "true", "yes", "on")


def _parse_bnreluconv(raw):
    lowered = raw.lower()
    return lowered if lowered in ("stock", "jnp", "pallas") else None


def _parse_flash(raw):
    lowered = raw.lower()
    if lowered in ("0", "false", "no", "off", "naive"):
        return "naive"
    if lowered in ("1", "true", "yes", "on", "pallas"):
        return "pallas"
    if lowered in ("pallas_b256", "pallas_pad"):
        return lowered
    return None  # unknown value: no override


#: MXNET_DTYPE_LADDER rung spellings -> canonical rung name
_LADDER_TOKENS = {
    "fp32": "fp32", "float32": "fp32",
    "bf16": "bf16", "bfloat16": "bf16",
    "fp8": "fp8", "float8": "fp8", "e4m3": "fp8",
}


def _parse_ladder(raw):
    """A single rung pins that arm; a roster ("fp32,bf16,fp8") and the
    arming values ("1"/"auto") carry no override: the race decides."""
    lowered = raw.lower()
    if "," in lowered:
        return None
    if lowered in ("bf16", "bfloat16"):
        return "bf16"
    if lowered in ("fp8", "float8", "e4m3"):
        return "fp8"
    if lowered in ("0", "off", "fp32", "float32"):
        return "fp32"
    return None


def ladder_rungs():
    """The dtype-ladder rungs this process may race or apply, from
    MXNET_DTYPE_LADDER: a comma roster names them, a single rung pins
    it (and is the only rung), the arming values ("1"/"auto") give the
    pair fp32/bf16 — fp8 never joins unless named, because its
    delayed-scaling state is provisioned at build time.  () when the
    ladder is unarmed."""
    raw = os.environ.get("MXNET_DTYPE_LADDER")
    if raw is None or not dtype_ladder_armed():
        return ()
    lowered = raw.lower()
    if "," in lowered:
        out = []
        for tok in lowered.split(","):
            rung = _LADDER_TOKENS.get(tok.strip())
            if rung is not None and rung not in out:
                out.append(rung)
        return tuple(out)
    single = _LADDER_TOKENS.get(lowered)
    if single is not None:
        return (single,)
    return ("fp32", "bf16")


def dtype_ladder_armed():
    """The ladder races and applies only when MXNET_DTYPE_LADDER is set
    to anything but an off value: a cached bf16 or fp8 winner changes
    the step's numerics, so it never applies to a caller that did not
    opt in."""
    raw = os.environ.get("MXNET_DTYPE_LADDER")
    if raw is None:
        return False
    return raw.lower() not in ("", "0", "off", "false", "no")


def _parse_quantize(raw):
    """MXNET_QUANTIZE: 0/off/fp32 pins the fp32 arm, 1/on/int8 the int8
    program, fp8 the fp8 program; anything else (e.g. 'auto') carries no
    override."""
    lowered = raw.lower()
    if lowered in ("0", "false", "no", "off", "fp32", "float32"):
        return False
    if lowered in ("1", "true", "yes", "on", "int8"):
        return True
    if lowered in ("fp8", "float8", "e4m3"):
        return "fp8"
    return None


def _parse_paged(raw):
    lowered = raw.lower()
    if lowered in ("0", "false", "no", "off", "gather", "dense"):
        return "gather"
    if lowered in ("1", "true", "yes", "on", "paged"):
        return "paged"
    return None


#: env var that explicitly overrides each variant op, with its parser
#: (None = this raw value carries no override)
_ENV_OVERRIDE = {
    "conv1x1_dot": ("MXNET_CONV_1X1_DOT", _parse_bool),
    "fused_bucket_opt": ("MXNET_PALLAS_OPT", _parse_bool),
    "flash_attention": ("MXNET_FLASH_ATTENTION", _parse_flash),
    "dtype_ladder": ("MXNET_DTYPE_LADDER", _parse_ladder),
    "pallas_bnreluconv": ("MXNET_BNRELUCONV_VARIANT", _parse_bnreluconv),
    # one knob overrides both quantized arms
    "quantized_conv": ("MXNET_QUANTIZE", _parse_quantize),
    "quantized_fc": ("MXNET_QUANTIZE", _parse_quantize),
    "paged_decode_attention": ("MXNET_PAGED_ATTENTION", _parse_paged),
}

_tls = threading.local()
_lock = threading.Lock()
_mem = {"path": None, "mtime": None, "entries": {}}
_last_report = {}


# ------------------------------------------------------------ decisions
class _Scope:
    def __init__(self, name, choices):
        self._name = name
        self._choices = dict(choices)
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, self._name, None)
        merged = dict(self._prev or {})
        merged.update(self._choices)
        setattr(_tls, self._name, merged)
        return self

    def __exit__(self, *exc):
        setattr(_tls, self._name, self._prev)


def force(**choices):
    """Scope pinning variant ops to concrete values (wins over
    everything) — the tuner's own scope while it measures a variant."""
    return _Scope("forced", choices)


def variant_choice(op, default=None):
    """The decision an op consults (see the module docstring for the
    precedence).  Returns the chosen value or ``default``."""
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
    applied = getattr(_tls, "applied", None) or {}
    if op in applied:
        return applied[op]
    return default


def program_scope(shape, dtype, platform=None, mesh=None):
    """Apply every cached winner of this program's input signature
    (entered by the entry points around each call).  A winner outside
    the platform's roster (:func:`op_variants`) is ignored.  No-op when
    autotune is off or nothing is cached for the key."""
    if not enabled():
        return _Scope("applied", {})
    entries = _load(cache_path())
    choices = {}
    if entries:
        for op in VARIANT_OPS:
            variants = op_variants(op, platform)
            entry = entries.get(_key(op, shape, dtype, platform, mesh))
            winner = entry.get("winner") if entry else None
            if winner is not None and winner in variants:
                choices[op] = variants[winner]
    return _Scope("applied", choices)


# ------------------------------------------------------------ the cache
def enabled(override=None):
    """Does autotune consult its cache (and race where asked)?
    ``override`` (a step's ``autotune`` argument) replaces the
    MXNET_AUTOTUNE level."""
    lvl = autotune_level() if override is None else int(bool(override))
    return lvl >= 1


def autotune_level():
    from .config import get_env

    try:
        return int(get_env("MXNET_AUTOTUNE"))
    except Exception:
        return 1


def cache_path():
    from .config import get_env

    d = get_env("MXNET_AUTOTUNE_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "mxnet_tpu_torch")
    return os.path.join(d, "autotune.json")


def _current_platform():
    """``cuda`` or ``cpu``: where the current context's arrays live."""
    from .context import current_context

    return "cuda" if current_context().device_type == "gpu" else "cpu"


def mesh_desc(mesh):
    """Stable string key of a :class:`~mxnet_tpu_torch.parallel.Mesh`
    (or None), as the reference's of a jax mesh: ``data=1``."""
    if mesh is None:
        return "none"
    try:
        return ",".join(f"{n}={s}" for n, s in mesh.shape.items())
    except Exception:
        return "mesh"


def _dtype_name(dtype):
    """``float32`` for ``torch.float32`` and for ``"float32"``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _key(op, shape, dtype, platform, mesh):
    platform = platform or _current_platform()
    mesh = mesh if isinstance(mesh, str) else mesh_desc(mesh)
    return "|".join((op, str(tuple(shape)), _dtype_name(dtype), platform,
                     mesh))


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


def lookup_entry(op, shape, dtype, platform=None, mesh=None):
    return _load(cache_path()).get(_key(op, shape, dtype, platform,
                                        mesh))


def lookup(op, shape, dtype, platform=None, mesh=None):
    """Cached winner name or None (platform None: the current
    context's)."""
    entry = lookup_entry(op, shape, dtype, platform, mesh)
    return None if entry is None else entry.get("winner")


def record(op, shape, dtype, winner, platform=None, timings=None,
           mesh=None):
    """Persist a winner (timings in seconds ride along)."""
    entry = {"winner": winner, "timings": timings or {},
             "recorded": time.time()}
    _save(cache_path(), {_key(op, shape, dtype, platform, mesh): entry})
    return entry


def cache_clear():
    """Drop the in-memory mirror (tests point the cache dir elsewhere)."""
    with _lock:
        _mem.update(path=None, mtime=None, entries={})


def last_report():
    """The most recent :func:`tune_train_step` session's report."""
    return dict(_last_report)


def op_variants(op, platform=None):
    """The roster ``op`` races on ``platform`` (None: the current
    context's): VARIANT_OPS[op], the dtype ladder narrowed to the rungs
    MXNET_DTYPE_LADDER names, and on ``cuda`` without the arms that
    compute a hand-written kernel's plain version.  A cached winner
    outside the roster is ignored by the same rule."""
    variants = VARIANT_OPS[op]
    if op == "dtype_ladder":
        rungs = ladder_rungs()
        narrowed = {k: v for k, v in variants.items() if k in rungs}
        if narrowed:
            variants = narrowed
    if (platform or _current_platform()) == "cuda":
        drops = _CARD_DROPS.get(op, ())
        variants = {k: v for k, v in variants.items() if k not in drops}
    return variants


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


def _first_tensor(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def chain_time(fn, init, iters=8):
    """Marginal seconds of one iteration of ``fn(carry, i) -> carry``:
    K chained iterations run from ``init`` for K = 2 and K = 2 + iters,
    and the slope of the two times cancels the constant of starting and
    draining the chain.  On the card each run is timed by CUDA events
    on the current stream around its iterations; on the CPU by a host
    clock.  One run of 2 iterations warms up first."""
    import torch

    lead = _first_tensor(init)
    cuda = lead is not None and lead.device.type == "cuda"

    def run(k):
        carry = init
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                carry = fn(carry, i)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for i in range(k):
            carry = fn(carry, i)
        return time.perf_counter() - t0

    run(2)
    t1 = run(2)
    t2 = run(2 + iters)
    return max(t2 - t1, 1e-9) / iters


def _clone_tree(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _step_chain_time(step, params, opt_state, x, y, key, iters=8):
    """:func:`chain_time` over a ``make_train_step`` step
    ``step(params, opt_state, x, y, key, t) -> (loss, params,
    opt_state)``.  The chain starts from copies of ``params`` and
    ``opt_state``: a donating step updates its inputs in place, and
    the caller's state must come out of a race as it went in."""
    init = (None, _clone_tree(params), _clone_tree(opt_state))

    def body(carry, i):
        _, p_, o_ = carry
        return step(p_, o_, x, y, key, float(i + 1))

    return chain_time(body, init, iters=iters)


def tune(op, shape, dtype, variants, measure, platform=None, mesh=None,
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
            _telemetry_winner(op, shape, dtype, entry["winner"],
                              cached=True)
            return entry["winner"], {"cached": True,
                                     "timings": entry.get("timings", {})}
    timings = {}
    for name, value in variants.items():
        with force(**{op: value}):
            timings[name] = measure(value)
    winner = min(timings, key=timings.get)
    record(op, shape, dtype, winner, platform, timings=timings,
           mesh=mesh)
    _telemetry_winner(op, shape, dtype, winner, cached=False,
                      timings=timings)
    return winner, {"cached": False, "timings": timings}


def _telemetry_winner(op, shape, dtype, winner, cached, timings=None):
    """One run-log ``autotune`` event per decision: which variant won,
    for which signature, and whether the cache answered — the record
    that a compile event's ``autotune_winner`` cause points back to."""
    try:
        from . import telemetry

        telemetry.event(
            "autotune", op=op, shape=str(tuple(shape)),
            dtype=_dtype_name(dtype), winner=winner, cached=bool(cached),
            timings={k: round(float(v), 6)
                     for k, v in (timings or {}).items()})
    except Exception:
        pass  # telemetry must never kill a tuning session


def tune_train_step(step, params, opt_state, x, y, key,
                    variant_ops=("conv1x1_dot",), platform=None,
                    mesh=None, iters=8, level=None):
    """Race each listed variant op inside the real train step, greedily
    one op at a time, the earlier winners pinned while a later op races.
    Keyed on the step's batch signature (``x``'s shape and dtype), the
    signature :func:`program_scope` later applies the winners to.  On a
    warm cache no step runs (pure lookups)."""
    global _last_report
    report = {}
    decided = {}
    for op in variant_ops:
        variants = op_variants(op, platform)

        def measure(_value, _decided=dict(decided)):
            with force(**_decided):
                return _step_chain_time(step, params, opt_state, x, y,
                                        key, iters=iters)

        winner, info = tune(op, x.shape, x.dtype, variants, measure,
                            platform=platform, mesh=mesh, level=level)
        if winner is not None:
            decided[op] = variants[winner]
            report[op] = {"winner": winner, **info}
    _last_report = report
    return report
