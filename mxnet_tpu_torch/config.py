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
register_env("MXNET_QUANTIZE", "", str,
             "Hand override of the quantized-inference race "
             "(mxnet_tpu_torch.quantization; autotune variant ops "
             "quantized_conv/quantized_fc): 0/off/fp32 pins every "
             "rewritten layer to its fp32 arm, 1/on/int8 the int8 "
             "program, fp8 the fp8 program (e4m3 operands, f32 "
             "accumulation).  Unset/auto: the race's winner decides.")
register_env("MXNET_QUANT_CALIB_MODE", "naive", str,
             "Default calibration mode of quantization.calibrate: "
             "'naive' (running min/max per observed tensor) or "
             "'entropy' (the KL-divergence-optimal symmetric "
             "threshold over an absolute-value histogram).")
register_env("MXNET_QUANT_CALIB_BATCHES", 10, int,
             "Default number of calibration batches "
             "quantization.calibrate folds through the range "
             "collector when the caller does not pass num_batches.")
register_env("MXNET_KV_DTYPE", "float32", str,
             "KV-cache storage dtype of the generative server: "
             "'float32' or 'int8' (per-(token, head) symmetric "
             "scales), int8 adopted only if the warmup agreement "
             "probe clears the floor.")
register_env("MXNET_PAGED_ATTENTION", "", str,
             "Hand override for the 'paged_decode_attention' variant: "
             "gather/0 or paged/1.  Unset: the cached winner of the "
             "generative server's warmup race.")
register_env("MXNET_BNRELUCONV_VARIANT", "", str,
             "Hand override for the 'pallas_bnreluconv' variant: stock "
             "(unfused layer path), jnp (fused op, plain backward), "
             "pallas (fused op, the hand-written backward kernel).  "
             "Unset: the cached per-shape winner, then "
             "MXNET_FUSED_BNRELUCONV.")
register_env("MXNET_PALLAS_OPT", "", str,
             "Hand override for the 'fused_bucket_opt' variant: 1 forces "
             "the fused bucket kernel (prep + update + loss-scale count "
             "in one pass), 0 the plain fused_bucket_update.  Unset: "
             "the cached winner, then the kernel on the card and the "
             "plain rule on the host.")
register_env("MXNET_CONV_1X1_DOT", False, bool,
             "Lower channel-last 1x1 convolutions to one matmul over the "
             "channel dimension (no layout change).  Off by default; "
             "the 'conv1x1_dot' variant of make_train_step's in-step "
             "race.  When set explicitly it overrides any autotuned "
             "winner.")
register_env("MXNET_DTYPE_LADDER", "", str,
             "The dtype-ladder knob.  Unset/0: the ladder never races "
             "or applies (a dtype change is not numerics-neutral, so "
             "it is opt-in).  1/auto: make_train_step races fp32 vs "
             "bf16 compute in-step (compute_dtype=None steps only) and "
             "applies the cached per-program winner.  A comma roster "
             "like 'fp32,bf16,fp8' races exactly those rungs — fp8 "
             "(e4m3 fwd / e5m2 grad, delayed per-tensor scaling in "
             "opt_state) only ever joins by being named.  "
             "bf16/fp32/fp8: hand-pin the arm.")
register_env("MXNET_FP8_AMAX_HISTORY", 16, int,
             "Length of the rolling amax history behind the fp8 rung's "
             "delayed scaling: each quantized tensor class (input / "
             "weights / grads) carries this many steps of observed "
             "|t|_inf in opt_state['_fp8'], and the next step's scale "
             "is fp8_max / (2 * max(history)) — on the device, no host "
             "sync (ops/pallas_opt.fp8_delayed_scale).")
register_env("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000, int,
             "Flat-bucket split threshold (elements) of the sharded-"
             "server exchange (optimizer_sharding='ps', parallel.zero): "
             "a bucket closes once the next parameter would push it "
             "past this many elements; and the bound above which a "
             "compressed push to the parameter server is sliced into "
             "bound-sized shards, each with its own residual.")
register_env("MXNET_DEFAULT_CTX", "gpu", str,
             "The default context of entry points: 'gpu' (cuda:0), or "
             "'cpu' for the host (the launcher's --cpu sets it for its "
             "workers, as the reference's sets JAX_PLATFORMS=cpu).")
register_env("MXNET_PS_DEADLINE_SEC", 600.0, float,
             "Parameter-server wait deadline (seconds) for sync "
             "round-skew waits, pull readiness waits and the client's "
             "total retry budget.  Lower it so fault-injection tests "
             "fail in seconds; raise it for slow-merge deployments.")
register_env("MXNET_PS_NATIVE", 1, int,
             "1: each worker's parameter-server shard is the native C++ "
             "server (src/ps_server_native.cc, built with g++ on first "
             "use), else the Python shard; 0: always the Python shard.")
register_env("MXNET_PS_HEARTBEAT_SEC", 0.3, float,
             "Seconds between a worker's liveness heartbeats to every "
             "parameter-server shard (num_dead_node reads them).")
register_env("MXNET_BAD_STEP_LIMIT", 0, int,
             "Step-level NaN/Inf guard: >0 arms make_train_step's "
             "skip-and-count guard (opt_state['_bad_steps'] counts "
             "consecutive bad steps).  0 disables it.")
register_env("MXNET_CKPT_KEEP", 3, int,
             "Checkpoint versions Module.fit's internal manager retains "
             "(resilience.checkpoint keep_n); older params/states/"
             "manifest files are pruned after each save.")
register_env("MXNET_OPTIMIZER_SHARDING", "", str,
             "Sharded-server optimizer: 'ps'/'1' forces it on for a "
             "Module over several contexts, '0'/'off' forces it off, "
             "empty defers to the caller.  A Module on one context "
             "updates per parameter either way.")
register_env("MXNET_ZERO_STAGE", "", str,
             "ZeRO stage of the sharded-server exchange "
             "(optimizer_sharding='ps', parallel.zero): '1' = classic "
             "ZeRO-1 (per-bucket all-reduce, grads replicated, "
             "optimizer state sharded), '2' = gradient shards "
             "(per-bucket reduce-scatter — the default program when "
             "unset), '3' = parameter shards (params live sharded as "
             "flat buckets).  Unset defers to the caller's zero_stage/"
             "optimizer_sharding arguments.  Unknown values raise.")
register_env("MXNET_SNAPSHOT_EVERY", 0, int,
             "Batches between async snapshot checkpoints in "
             "Module.fit (needs checkpoint=).  0 (default) keeps the "
             "epoch-boundary-only cadence; N>0 makes the recovery "
             "point at most N batches old — the freshest snapshot is "
             "also what an emergency checkpoint (peer death, "
             "watchdog abort) flushes without any collective.")
register_env("MXNET_ELASTIC", False, bool,
             "Elastic multi-process runtime (resilience.elastic): arms "
             "runtime.init_distributed()/elastic_init() multi-process "
             "bring-up over torch.distributed, topology-stamped "
             "checkpoints, and reshard-on-resize resume — a job "
             "resumed at a different world size re-slices its cursor "
             "instead of dying.")
register_env("MXNET_COORDINATOR", "", str,
             "Rendezvous address of the elastic job as host:port "
             "(process 0 serves the TCPStore there).  Empty falls back "
             "to the DMLC_* launcher contract (DMLC_PS_ROOT_URI:"
             "DMLC_PS_ROOT_PORT when DMLC_NUM_WORKER > 1); "
             "unresolvable = single-process bring-up.")
register_env("MXNET_NUM_PROCESSES", 0, int,
             "Process count of the elastic job (0 = fall back to "
             "DMLC_NUM_WORKER, then single-process).")
register_env("MXNET_PROCESS_ID", -1, int,
             "This process's id in the elastic job (-1 = fall back to "
             "DMLC_WORKER_ID).")
register_env("MXNET_DIST_INIT_ATTEMPTS", 4, int,
             "Bounded-retry attempts around the process-group bring-up "
             "in elastic_init (backoff + jitter via resilience.retry; "
             "the dist.init fault point fires inside every attempt).")
register_env("MXNET_DIST_INIT_TIMEOUT_SEC", 120.0, float,
             "Total time budget (seconds) for elastic_init's bring-up "
             "retry loop — the deadline_sec cap, so attempt counts "
             "cannot overshoot the bring-up SLA once backoff grows.")
register_env("MXNET_PEER_TIMEOUT_SEC", 10.0, float,
             "Peer liveness timeout (resilience.healing): a peer "
             "whose heartbeat file goes stale for this many seconds "
             "is declared DEAD by every survivor's FailureDetector "
             "(a same-host peer whose pid vanished is declared dead "
             "immediately — the SIGKILL fast path).  Also sets the "
             "Heartbeater's default beat interval (timeout/4).")
register_env("MXNET_HEARTBEAT_DIR", "", str,
             "Shared directory of per-rank heartbeat files "
             "(resilience.healing).  Set on a multi-process elastic "
             "job and Module.fit arms the self-healing loop: this "
             "rank beats, the failure detector polls at step "
             "boundaries, and a declared peer death fires the "
             "emergency checkpoint + PeerDeadError instead of "
             "wedging in a collective.  Empty = healing unarmed.")
register_env("MXNET_CKPT_ASYNC", True, bool,
             "Snapshot checkpoints write asynchronously "
             "(CheckpointManager.save_async: device->host capture at "
             "the step boundary, serialization + atomic write on a "
             "background thread with a bounded back-pressure queue). "
             "0 forces the MXNET_SNAPSHOT_EVERY cadence writes "
             "synchronous — the A/B arm and a debugging escape "
             "hatch.")
register_env("MXNET_HEAL_MAX_RELAUNCH", 2, int,
             "Respawn bound of the self-healing supervisor "
             "(python -m mxnet_tpu_torch.resilience.healing "
             "--relaunch): a training command dying with a healable "
             "status (peer death rc 83, any signal kill, the faultsim "
             "crash 87) is relaunched at most this many times with "
             "MXNET_HEAL_ATTEMPT exported; anything else is final.")
register_env("MXNET_WATCHDOG_ABORT", False, bool,
             "Hang-watchdog escalation (default OFF — the observe-only "
             "contract is unchanged): after max_dumps stall dumps "
             "with the heartbeat still dead a full timeout later, "
             "flush the flight ring + the emergency checkpoint "
             "(freshest snapshot) and os._exit(85), so a permanently "
             "wedged job is rescheduled instead of burning its whole "
             "wall budget.")
register_env("MXNET_PROFILER_AUTOSTART", False, bool,
             "Start the profiler at import (reference knob; wired to "
             "mx.profiler.set_state('run')).")
register_env("MXNET_PROFILER_MODE", "imperative", str,
             "Default profiler scope (symbolic/imperative/all).")
register_env("MXNET_RUNLOG", "", str,
             "Path of the per-step JSONL run log (telemetry.RunLog). "
             "Empty = telemetry off entirely: every wire point takes "
             "the no-op fast exit and the fit loop performs no "
             "per-step device syncs.  Set it and every subsystem "
             "(step timing, compile/retrace causes, checkpoints, NaN "
             "guard, fault injections, serving batches and spans) "
             "reports into one JSONL file, plus a crash flight "
             "recorder at <path>.flight.<pid>.json.")
register_env("MXNET_TELEMETRY_SAMPLE", 25, int,
             "Device-sync sampling period for telemetry: the fit loop "
             "reads the loss/metric (one device sync) only every this "
             "many steps; unsampled step records keep wall timing but "
             "loss=null so the hot path stays async.")
register_env("MXNET_FLIGHTREC_DEPTH", 64, int,
             "Crash flight recorder ring depth: the last N step "
             "records (plus config/env/compile fingerprints) dumped "
             "atomically on SIGTERM drain, NaN-abort, fault-injection "
             "crash, a watchdog stall or an unhandled exception inside "
             "Module.fit.  0 disables the recorder (run log still "
             "written).")
register_env("MXNET_WATCHDOG_SEC", 0.0, float,
             "Hang watchdog (telemetry.Watchdog): >0 arms a background "
             "thread per Module.fit / per ModelServer that, when the "
             "heartbeat goes quiet for this many seconds — even with "
             "the main thread blocked inside a native call — appends "
             "an all-thread faulthandler stack dump, flushes the "
             "flight recorder with reason 'stall', and emits a "
             "'watchdog' run-log record.  It observes, it never "
             "kills.  0 (default) = no thread, zero hot-path cost.")
register_env("MXNET_NUMERICS", False, bool,
             "Numerics monitor (telemetry.numerics): per-gradient "
             "summary reductions (l2/min/max/NaN/Inf counts/zero "
             "fraction) ride in the train step's optimizer state and "
             "become sampled 'tensor_stats' run-log records, so a NaN "
             "step is explained (which tensor, which step).  Off by "
             "default: the built step is the step without the "
             "monitor.")
register_env("MXNET_NUMERICS_SAMPLE", 0, int,
             "Steps between numerics-monitor tensor_stats emissions "
             "(each costs one device readback of the summary "
             "vectors).  0 = follow MXNET_TELEMETRY_SAMPLE.")
register_env("MXNET_METRICS_TEXTFILE", "", str,
             "Prometheus-textfile export path (node_exporter textfile "
             "collector convention): telemetry counters + last "
             "throughput/loss, atomically rewritten on every sampled "
             "step.  Empty = off.")
register_env("MXNET_TRACE_CONTEXT", "", str,
             "Inbound W3C traceparent stamp "
             "('00-<32hex trace>-<16hex span>-01') set by a spawner so "
             "the child's spans parent onto the spawn "
             "(telemetry.tracing).  Empty = this process roots its "
             "own traces.")
register_env("MXNET_PROCESS_ROLE", "", str,
             "Process identity stamped by spawners into the child's "
             "run_start record (trainer|replica|router|fit) — the "
             "track-group label tools/tracemerge.py uses for the "
             "merged timeline.")
register_env("MXNET_PROCESS_RANK", "", str,
             "Numeric rank within the role (replica index, trainer "
             "attempt), stamped next to MXNET_PROCESS_ROLE into "
             "run_start.")
register_env("MXNET_SERVE_SLO_MS", 100.0, float,
             "Default per-request deadline (milliseconds) of the "
             "serving runtime (mxnet_tpu_torch.serving.ModelServer): a "
             "submit() without an explicit deadline_ms gets this SLO. "
             "Admission control sheds requests the latency EWMA says "
             "cannot finish inside it.")
register_env("MXNET_SERVE_QUEUE_DEPTH", 256, int,
             "Serving request-queue bound: submits beyond this many "
             "waiting requests are rejected with a structured "
             "ServeRejected(reason='queue_full') instead of growing "
             "an unbounded backlog.")
register_env("MXNET_SERVE_MAX_INFLIGHT", 0, int,
             "Bound on admitted-but-unfinished serving requests "
             "(queued + in the running batch).  0 = queue depth plus "
             "one max-size batch.")
register_env("MXNET_SERVE_BREAKER_LIMIT", 3, int,
             "Serving circuit breaker: after this many CONSECUTIVE "
             "model-invocation failures (exceptions or non-finite "
             "outputs — the bad-step machinery's serving analog) the "
             "breaker opens: requests get fast structured rejections "
             "while the batcher re-warms on probe batches; a probe "
             "success closes it.")
register_env("MXNET_FLEET_PORT", 0, int,
             "Default bind port of the serving HTTP frontend "
             "(serving.ServeFrontend); 0 = ephemeral.")
register_env("MXNET_FLEET_HBM_BUDGET_MB", 0.0, float,
             "Per-host model-residency budget in MiB for "
             "serving.ModelHost: an artifact is admitted only if its "
             "reserved device bytes (one forward's peak at the "
             "artifact's batch on the card) fit next to the resident "
             "models, else a structured "
             "ServeRejected(reason='hbm_budget').  0 = unlimited.")
register_env("MXNET_CPU_WORKER_NTHREADS", 0, int,
             "Host decode/augment threads of the native library (0 = "
             "all cores); ImageRecordIter's preprocess_threads default.")
register_env("MXNET_TPU_PREFETCH_BUFFER", 4, int,
             "Batches kept ready ahead of the training loop "
             "(ImageRecordIter prefetch_buffer default).")
register_env("MXNET_IO_WORKERS", 0, int,
             "Decode/augment worker pool size behind ImageRecordIter.  "
             "0 keeps one producer thread; N>0 runs N workers behind a "
             "sequence-ordered emitter (batches are assembled by index "
             "plan, so worker count, respawns and stragglers never "
             "change which sample lands in which row).")
register_env("MXNET_IO_WORKER_RESPAWN", 2, int,
             "Respawn budget of the io worker pool: a worker that dies "
             "holding a batch or wedges past the per-batch deadline is "
             "replaced (its batch re-dispatched) at most this many "
             "times per iterator; exhausting it fails loudly with the "
             "quarantine manifest named.")
register_env("MXNET_IO_MAX_SKIP_FRAC", 0.1, float,
             "Quarantine ceiling: the fraction of a .rec shard's "
             "records that may be skipped (framing resyncs + unpack/"
             "decode quarantines) before the data plane refuses to "
             "continue.")
register_env("MXNET_DEVICE_FEED", True, bool,
             "Asynchronous device feed: DataLoader and Module.fit wrap "
             "their batch source in io.DeviceFeedIter (pinned host "
             "buffers, a side CUDA stream), and ImageRecordIter "
             "decodes on the card ahead of the step.  0 gives host "
             "batches that the consumer moves.")
register_env("MXNET_DEVICE_FEED_DEPTH", 2, int,
             "Batches DeviceFeedIter keeps on the card ahead of the "
             "consumer.")
register_env("MXNET_FEED_JOIN_TIMEOUT_SEC", 10.0, float,
             "Bound on the feed's and the record iterator's producer "
             "joins at close(): a wedged producer is abandoned (daemon) "
             "after this many seconds.")
