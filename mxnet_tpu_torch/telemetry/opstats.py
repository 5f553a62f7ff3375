"""Aggregate per-op statistics folded from the profiler's event buffer
(counterpart of ``mxnet_tpu/telemetry/opstats.py``).

The reference's ``profiler.dumps()`` is backed by AggregateStats
(src/profiler/aggregate_stats.cc): every op event lands in a per-op
row of count/total/min/max/avg dispatch time, dumped as a sorted text
table.  Our profiler keeps the richer artifact — the full Chrome-trace
event list — so this module derives the aggregate FROM the events,
which buys the two columns the reference table lacks:

* **p99_us** — tail latency per op, computed from the complete sample
  set rather than a running min/max pair;
* **bytes** — summed where the dispatcher knew the output size (the
  ``bytes`` arg on an op event).

Three outputs, same data:

* :func:`aggregate` — programmatic: ``{name: row_dict}``;
* :func:`dumps` — the ``profiler.dumps()``-style text table (or JSON);
* :func:`record` — a ``program_report``-style ``opstats`` record into
  the active RunLog, so the bench's run log carries the op table next
  to the step records that paid for it.
"""
from __future__ import annotations

import json as _json
import math

__all__ = ["aggregate", "dumps", "record", "percentile", "SORT_KEYS"]

SORT_KEYS = ("total", "avg", "min", "max", "p99", "count", "bytes")


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list (q in [0, 1]); the
    reference's convention, so TTFT percentiles mean the same in both
    packages."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return float(sorted_vals[rank - 1])


def aggregate(events=None, cat="operator"):
    """Fold complete-span ('X') trace events into per-op rows.

    ``events`` defaults to a snapshot of the profiler's live buffer;
    ``cat`` filters by event category (``"operator"`` = the nd
    dispatcher's op events; pass None to aggregate every span, e.g.
    the telemetry lane's step/feed_wait spans).  Returns
    ``{name: {count, total_us, min_us, max_us, avg_us, p99_us,
    bytes}}`` — ``bytes`` is None when no event carried one.
    """
    if events is None:
        from .. import profiler

        events = profiler.events_snapshot()
    durs = {}
    nbytes = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        name = ev.get("name")
        durs.setdefault(name, []).append(float(ev.get("dur", 0.0)))
        b = (ev.get("args") or {}).get("bytes")
        if b is not None:
            nbytes[name] = nbytes.get(name, 0) + int(b)
    rows = {}
    for name, ds in durs.items():
        ds.sort()
        total = sum(ds)
        rows[name] = {
            "count": len(ds),
            "total_us": total,
            "min_us": ds[0],
            "max_us": ds[-1],
            "avg_us": total / len(ds),
            "p99_us": percentile(ds, 0.99),
            "bytes": nbytes.get(name),
        }
    return rows


def dumps(format="table", sort_by="total", ascending=False,
          events=None, cat="operator"):
    """The ``profiler.dumps()`` analog over the event buffer: a sorted
    per-op text table (or JSON) with the p99/bytes columns."""
    from ..base import MXNetError

    if format not in ("table", "json"):
        raise MXNetError(f"invalid format {format!r}")
    if sort_by not in SORT_KEYS:
        raise MXNetError(f"invalid sort_by {sort_by!r} "
                         f"(one of {SORT_KEYS})")
    rows = aggregate(events=events, cat=cat)
    key = {"total": "total_us", "avg": "avg_us", "min": "min_us",
           "max": "max_us", "p99": "p99_us", "count": "count",
           "bytes": "bytes"}[sort_by]
    order = sorted(rows.items(), key=lambda kv: kv[1][key] or 0,
                   reverse=not ascending)
    if format == "json":
        return _json.dumps([{"name": n, **r} for n, r in order])
    lines = [f"{'Name':<40s}{'Calls':>8s}{'Total(us)':>14s}"
             f"{'Min(us)':>12s}{'Max(us)':>12s}{'Avg(us)':>12s}"
             f"{'P99(us)':>12s}{'Bytes':>14s}"]
    for n, r in order:
        b = "-" if r["bytes"] is None else str(r["bytes"])
        lines.append(
            f"{n:<40.40s}{r['count']:>8d}{r['total_us']:>14.1f}"
            f"{r['min_us']:>12.1f}{r['max_us']:>12.1f}"
            f"{r['avg_us']:>12.1f}{r['p99_us']:>12.1f}{b:>14s}")
    return "\n".join(lines)


def record(source="profiler", events=None, cat="operator", top=None):
    """Write the aggregate as an ``opstats`` RunLog record (no-op when
    telemetry is unarmed).  ``top`` keeps only the N largest rows by
    total time so a long eager session cannot bloat the run log.
    Returns the row dict either way (callers fold it into reports)."""
    rows = aggregate(events=events, cat=cat)
    if top is not None and len(rows) > top:
        keep = sorted(rows, key=lambda n: rows[n]["total_us"],
                      reverse=True)[:int(top)]
        rows = {n: rows[n] for n in keep}
    from .runlog import current

    rl = current()
    if rl is not None and rows:
        rl.opstats(rows, source=source)
    return rows
