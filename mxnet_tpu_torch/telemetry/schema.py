"""Run-log record schema (the port's own copy of
``mxnet_tpu/telemetry/schema.py``, field for field): one place tests,
CI and the bench harness agree on what a telemetry record must look
like.

Every line of an ``MXNET_RUNLOG`` JSONL file is one record with a
``type`` discriminator; :func:`validate_record` returns a list of
human-readable problems (empty = valid).  The step-record field table
is the documented contract (README "Observability"):

========  =============================================================
type      meaning
========  =============================================================
run_start process/config/env fingerprint, written when the log opens
step      one training step (wall time, throughput, feed stats, ...)
compile   a program (re)trace with its cause (shape/dtype/...)
program_report  compiled-program introspection (memory/flops/collectives)
checkpoint  one atomic checkpoint write with its duration
watchdog  a hang-watchdog stall (phase, quiet seconds, stack dump path)
opstats   aggregate per-op table folded from the profiler's op events
tensor_stats  sampled numerics-monitor summary of named tensors
serve     one dispatched serving microbatch (size, pad, latency,
          queue depth, cumulative shed, breaker state)
generate  one generative-serving snapshot (tokens/s, TTFT p50/p99,
          sequences in flight, KV pages in use, cumulative
          eviction/shed counters, effective KV dtype)
fleet     one fleet-router observation (replica counts, queue-depth
          EWMA, cumulative request/failover/shed counters) stamped
          with the action that produced it (probe/eject/resize/swap)
heal      one self-healing runtime observation (peer_death /
          collective_abandon / emergency_ckpt / heal_exit / relaunch /
          resume) with the cumulative peer-death / emergency /
          relaunch counters
data      one data-plane observation (quarantine / respawn /
          epoch_end) with the cumulative records-skipped and
          worker-respawn counters stamped on
freshness one online-learning loop observation (publish / swap_commit
          / swap_shed / swap_rollback / violation / relaunch) carrying
          the artifact's monotonic model version, the measured
          sample-to-served freshness and the loop's cumulative
          export/swap/shed/violation counters
span      one completed trace span (name, duration, trace/span/parent
          ids) — the cross-process causal unit tools/tracemerge.py
          stitches into one timeline
event     everything else (bad_step, ps_retry, fault, deadline, ...)
run_end   final counters, written at close
========  =============================================================

Every record type may additionally carry the optional trace
fields ``trace_id`` / ``span_id`` / ``parent_span_id`` (validated when
present; absent = compatible with logs written before tracing), and
``run_start`` may carry the process identity ``role`` / ``rank`` /
``parent_pid`` stamped by its spawner.
"""
from __future__ import annotations

__all__ = ["STEP_FIELDS", "RECORD_TYPES", "COMPILE_CAUSES",
           "OPSTATS_ROW_FIELDS", "TENSOR_STATS_ROW_FIELDS",
           "SERVE_FIELDS", "GENERATE_FIELDS", "FLEET_FIELDS",
           "HEAL_FIELDS", "DATA_FIELDS", "QUANT_FIELDS",
           "FRESHNESS_FIELDS", "SPAN_FIELDS", "TRACE_FIELDS",
           "validate_record", "validate_lines"]

#: step-record contract: field -> (types, required).  ``None`` is legal
#: for optional measurements (loss on an unsampled step, feed stats
#: when no device feed wraps the iterator).
STEP_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),            # seconds since run start
    "epoch": (int, True),
    "step": (int, True),                  # global step (monotonic)
    "batch": (int, True),                 # batch index within the epoch
    "wall_ms": ((int, float), True),
    "samples": (int, True),
    "samples_per_sec": ((int, float, type(None)), True),
    "loss": ((int, float, type(None)), True),
    "synced": (bool, True),               # sampled device sync happened
    "feed_wait_ms": ((int, float, type(None)), True),
    "h2d_bytes": ((int, type(None)), True),
    "collective_counts": ((dict, type(None)), True),
    "collective_bytes": ((int, type(None)), True),
    "sharding": (str, True),              # optimizer-sharding mode
    "bad_step": (bool, True),
    "ps_retries": (int, True),            # cumulative process counters
    "faults": (int, True),
    "checkpoints": (int, True),
}

RECORD_TYPES = ("run_start", "step", "compile", "program_report",
                "checkpoint", "watchdog", "opstats", "tensor_stats",
                "serve", "generate", "fleet", "heal", "data",
                "quantize", "freshness", "span", "event", "run_end")

#: contract of a ``span`` record (telemetry.tracing): one completed
#: span of a distributed trace.  ``t`` is the run-relative END time
#: (the runlog's native clock) and ``dur_ms`` walks it back to the
#: start, so tracemerge reconstructs wall time as
#: ``run_start.time + t - dur_ms/1e3``
SPAN_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),            # run-relative end time
    "name": (str, True),
    "kind": (str, True),                  # server|client|internal|...
    "dur_ms": ((int, float), True),
    "trace_id": (str, True),              # 32 hex
    "span_id": (str, True),               # 16 hex
    "parent_span_id": ((str, type(None)), True),
    "attrs": ((dict, type(None)), False),
}

#: optional trace stamps any OTHER record type may carry (absent =
#: record written before tracing) — validated for shape whenever present
TRACE_FIELDS = {
    "trace_id": (str, False),
    "span_id": (str, False),
    "parent_span_id": ((str, type(None)), False),
}


def _check_trace_ids(rec):
    """Hex-shape checks for trace stamps, applied whenever present."""
    problems = []
    tid = rec.get("trace_id")
    if isinstance(tid, str) and len(tid) != 32:
        problems.append(f"trace_id must be 32 hex chars, got {tid!r}")
    for name in ("span_id", "parent_span_id"):
        sid = rec.get(name)
        if isinstance(sid, str) and len(sid) != 16:
            problems.append(f"{name} must be 16 hex chars, got {sid!r}")
    return problems

#: per-batch contract of a ``serve`` record (serving.ModelServer)
SERVE_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "model": (str, True),
    "batch": (int, True),                 # live requests in the batch
    "padded_to": (int, True),             # the bucketed batch shape
    "queue_depth": (int, True),           # queue at dispatch end
    "latency_ms": ((int, float), True),
    "deadline_margin_ms": ((int, float, type(None)), True),
    "shed": (int, True),                  # cumulative shed count
    "breaker": (str, True),
}

#: per-snapshot contract of a ``generate`` record
#: (serving.generate.GenerativeServer.report): the generative decode
#: path's health at one moment — throughput, time-to-first-token
#: percentiles, continuous-batching occupancy, paged-KV pool pressure
#: and the cumulative eviction/shed counters
GENERATE_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "name": (str, True),
    "tokens": (int, True),                # cumulative generated tokens
    "tokens_s": ((int, float), True),
    "ttft_p50_ms": ((int, float, type(None)), True),
    "ttft_p99_ms": ((int, float, type(None)), True),
    "in_flight": (int, True),             # decode slots active now
    "max_in_flight": (int, True),
    "evictions": (int, True),             # cumulative KV preemptions
    "shed": (int, True),                  # cumulative rejections
    "pages_in_use": (int, True),          # paged-KV pool pressure
    "queue_depth": (int, True),           # prefill queue now
    "kv_dtype": (str, True),              # effective cache dtype
    "compiles": (int, True),              # post-warm compiles (0 proof)
}

#: per-observation contract of a ``fleet`` record (serving.fleet):
#: the router's view of its replica set at one moment, stamped with
#: the action that produced the record
FLEET_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "action": (str, True),                # probe|eject|resize|swap|...
    "replicas": (int, True),              # replicas not ejected/dead
    "ready": (int, True),                 # routable replicas
    "queue_depth": (int, True),           # summed across the fleet
    "queue_ewma": ((int, float), True),   # the autoscaler's signal
    "requests": (int, True),              # cumulative router counters
    "failovers": (int, True),
    "shed": (int, True),
}

#: per-observation contract of a ``heal`` record (resilience.healing):
#: one self-healing runtime event — a declared peer death, an
#: abandoned collective, an emergency checkpoint flush, the survivor's
#: heal_exit, a supervisor relaunch or the healed resume — with the
#: process's cumulative healing counters stamped on
HEAL_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "action": (str, True),        # peer_death|collective_abandon|...
    "peer_deaths": (int, True),   # cumulative process counters
    "emergency_ckpts": (int, True),
    "heal_relaunches": (int, True),
    "auto_reshards": (int, True),
}

#: per-observation contract of a ``data`` record (io data plane):
#: one quarantine / worker-respawn / epoch observation with the
#: process's cumulative skip and respawn counters stamped on — the
#: record chain that proves a shrunken epoch was DECLARED, not silent
DATA_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "action": (str, True),        # quarantine|respawn|epoch_end|...
    "workers": (int, True),       # pool size (0 = single producer)
    "skipped": (int, True),       # cumulative data_records_skipped
    "respawns": (int, True),      # cumulative io_worker_respawns
}

#: per-observation contract of a ``quantize`` record
#: (the quantization package): one calibrate / rewrite / race / export
#: observation — which mode ran and how many layers the pass touched,
#: so an armed run log names exactly what the int8 pipeline did
QUANT_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "action": (str, True),        # calibrate|rewrite|race|export
    "mode": (str, True),          # naive|entropy ('' when n/a)
    "layers": (int, True),        # layers the action touched/adopted
    "excluded": (int, True),      # layers fenced off by the caller
}

#: per-observation contract of a ``freshness`` record
#: (the online-learning loop): one online-loop event — a trainer export
#: published, a rolling swap committed/shed/rolled back, an SLO
#: violation or a supervisor relaunch — stamped with the artifact's
#: monotonic model version and the loop's cumulative counters, so a
#: run log alone proves the served version never regressed and names
#: every swap that was shed instead of silently skipped
FRESHNESS_FIELDS = {
    "type": (str, True),
    "t": ((int, float), True),
    "action": (str, True),        # publish|swap_commit|swap_shed|
                                  # swap_rollback|violation|relaunch
    "version": (int, True),       # monotonic model version (0 = n/a)
    "freshness_ms": ((int, float, type(None)), True),
    "exports": (int, True),       # cumulative loop counters
    "swaps": (int, True),
    "swaps_shed": (int, True),
    "violations": (int, True),
    "relaunches": (int, True),
}

#: per-op row contract of an ``opstats`` record (telemetry.opstats)
OPSTATS_ROW_FIELDS = {
    "count": (int, True),
    "total_us": ((int, float), True),
    "min_us": ((int, float), True),
    "max_us": ((int, float), True),
    "avg_us": ((int, float), True),
    "p99_us": ((int, float), True),
    "bytes": ((int, type(None)), True),
}

#: per-tensor row contract of a ``tensor_stats`` record
TENSOR_STATS_ROW_FIELDS = {
    "l2": ((int, float), True),
    "min": ((int, float), True),
    "max": ((int, float), True),
    "nan": (int, True),
    "inf": (int, True),
    "zero_frac": ((int, float), True),
}

#: the concrete retrace causes a compile record may carry
COMPILE_CAUSES = ("first_trace", "shape", "dtype", "train_mode",
                  "autotune_winner", "hyper_params", "sharding",
                  "program")


def _check_fields(rec, spec):
    problems = []
    for name, (types, required) in spec.items():
        if name not in rec:
            if required:
                problems.append(f"missing field {name!r}")
            continue
        if not isinstance(rec[name], types):
            problems.append(
                f"field {name!r} has type {type(rec[name]).__name__}, "
                f"want {types}")
    return problems


def validate_record(rec):
    """Validate one parsed record; returns a list of problems."""
    if not isinstance(rec, dict):
        return ["record is not an object"]
    t = rec.get("type")
    if t not in RECORD_TYPES:
        return [f"unknown record type {t!r}"]
    return _validate_typed(rec, t) + _check_fields(rec, TRACE_FIELDS) \
        + _check_trace_ids(rec)


def _validate_typed(rec, t):
    if t == "span":
        return _check_fields(rec, SPAN_FIELDS)
    if t == "step":
        return _check_fields(rec, STEP_FIELDS)
    if t == "compile":
        problems = _check_fields(rec, {
            "t": ((int, float), True), "program": (str, True),
            "cache": (str, True), "causes": (list, True),
            "fingerprint": (dict, True)})
        for c in rec.get("causes", ()):
            if c not in COMPILE_CAUSES:
                problems.append(f"unknown compile cause {c!r}")
        if rec.get("cache") not in ("hit", "miss"):
            problems.append(f"cache must be hit/miss, got "
                            f"{rec.get('cache')!r}")
        return problems
    if t == "program_report":
        return _check_fields(rec, {
            "t": ((int, float), True), "program": (str, True),
            "memory": (dict, True), "flops": ((int, float), True),
            "collectives": ((dict, type(None)), True)})
    if t == "checkpoint":
        return _check_fields(rec, {
            "t": ((int, float), True), "prefix": (str, True),
            "version": (int, True), "duration_s": ((int, float), True),
            "bytes": (int, True)})
    if t == "watchdog":
        return _check_fields(rec, {
            "t": ((int, float), True), "phase": (str, True),
            "quiet_s": ((int, float), True),
            "stack_path": ((str, type(None)), True)})
    if t == "opstats":
        problems = _check_fields(rec, {
            "t": ((int, float), True), "source": (str, True),
            "ops": (int, True), "rows": (dict, True)})
        for name, row in (rec.get("rows") or {}).items():
            if not isinstance(row, dict):
                problems.append(f"opstats row {name!r} is not an object")
                continue
            problems.extend(f"opstats row {name!r}: {p}"
                            for p in _check_fields(row,
                                                   OPSTATS_ROW_FIELDS))
        return problems
    if t == "tensor_stats":
        problems = _check_fields(rec, {
            "t": ((int, float), True), "step": (int, True),
            "where": (str, True), "nonfinite": (bool, True),
            "tensors": (dict, True)})
        for name, row in (rec.get("tensors") or {}).items():
            if not isinstance(row, dict):
                problems.append(
                    f"tensor_stats row {name!r} is not an object")
                continue
            problems.extend(
                f"tensor_stats row {name!r}: {p}"
                for p in _check_fields(row, TENSOR_STATS_ROW_FIELDS))
        return problems
    if t == "serve":
        return _check_fields(rec, SERVE_FIELDS)
    if t == "generate":
        return _check_fields(rec, GENERATE_FIELDS)
    if t == "fleet":
        return _check_fields(rec, FLEET_FIELDS)
    if t == "heal":
        return _check_fields(rec, HEAL_FIELDS)
    if t == "data":
        return _check_fields(rec, DATA_FIELDS)
    if t == "quantize":
        return _check_fields(rec, QUANT_FIELDS)
    if t == "freshness":
        return _check_fields(rec, FRESHNESS_FIELDS)
    if t == "event":
        return _check_fields(rec, {"t": ((int, float), True),
                                   "kind": (str, True)})
    if t == "run_start":
        return _check_fields(rec, {
            "time": ((int, float), True),
            "pid": (int, True),
            "env": (dict, True),
            "config": (dict, True),
            # process identity, stamped by spawners; optional so logs
            # written before tracing stay valid
            "role": (str, False),
            "rank": ((int, type(None)), False),
            "parent_pid": (int, False)})
    if t == "run_end":
        return _check_fields(rec, {"t": ((int, float), True),
                                   "counters": (dict, True)})
    return []


def validate_lines(lines):
    """Validate an iterable of JSONL lines; returns (records, problems)
    where problems carry the 1-based line number."""
    import json

    records, problems = [], []
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            problems.append(f"line {i}: not JSON ({e})")
            continue
        records.append(rec)
        problems.extend(f"line {i}: {p}" for p in validate_record(rec))
    return records, problems
