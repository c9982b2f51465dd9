#!/usr/bin/env python
"""Cross-role transaction trace analysis over rolled trace JSONL.

Modeled on the reference's ``transaction_profiling_analyzer``: the span
events the roles emit for sampled transactions (runtime/span.py —
``TransactionDebug`` / ``CommitDebug`` / ``RpcDebug`` keyed by one
TraceID at every hop) are stitched back into per-transaction cross-role
timelines, and the tool reports:

- the **critical path** of each sampled transaction: the ordered span
  segments (consecutive event pairs) with their durations;
- **per-span p50/p99** across all sampled transactions (where is the
  fleet slow, not just one txn);
- the **top-k slowest** transactions with their full timelines;
- **SlowTask correlation**: event-loop stalls whose window overlaps a
  sampled transaction (one join instead of correlating by hand; it is
  one join);
- **storage apply correlation**: ``StorageApplyDebug`` events (emitted
  at DEBUG severity — run the sim's TraceLog at ``min_severity=DEBUG``
  to capture them) carry no trace id because the apply is asynchronous
  to every commit; the tool joins a transaction's commit Version into
  each storage tag's [MinVersion, MaxVersion] apply window instead.

Usage:
    python -m foundationdb_tpu_torch.tools.trace_tool trace.jsonl [more.jsonl ...] [--top 5]
    python -m foundationdb_tpu_torch.tools.trace_tool trace.jsonl --trace 000000000000002a
    python -m foundationdb_tpu_torch.tools.trace_tool trace.jsonl --json

Passing a base path picks up its rolled ``.N`` siblings automatically.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

SPAN_TYPES = {"TransactionDebug", "CommitDebug", "RpcDebug"}

# the canonical commit-path chain a COMPLETE timeline must touch
# (client→GRV→commit→resolve→TLog; storage joins via read spans or the
# version-correlated apply window)
REQUIRED_ROLES = ("client", "GrvProxy", "CommitProxy", "Resolver", "TLog")


def rolled_paths(path: str) -> list[str]:
    """A trace path plus its rolled ``.N`` siblings, oldest first."""
    rolls = []
    for p in glob.glob(glob.escape(path) + ".*"):
        suffix = p[len(path) + 1:]
        if suffix.isdigit():
            rolls.append((int(suffix), p))
    out = [p for _, p in sorted(rolls)]
    if os.path.exists(path):
        out.append(path)
    return out


def load_events(paths: list[str]) -> list[dict]:
    """Parse JSONL trace files; unparsable lines are skipped (a torn
    tail from a crash must not kill the analysis)."""
    events: list[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict) and "Type" in ev:
                    events.append(ev)
    return events


def reconstruct(events: list[dict]) -> dict[str, dict]:
    """Group span events by TraceID into per-transaction timelines.

    Returns {trace_id_hex: {"events": [...time-ordered...],
    "begin": t, "end": t, "total_ms": ms, "roles": [..],
    "commit_version": v or None, "outcome": str}}.
    """
    traces: dict[str, dict] = {}
    for ev in events:
        if ev.get("Type") not in SPAN_TYPES or "TraceID" not in ev:
            continue
        tr = traces.setdefault(ev["TraceID"], {"events": []})
        tr["events"].append(ev)
    for tid, tr in traces.items():
        evs = sorted(tr["events"], key=lambda e: (e.get("Time", 0.0)))
        tr["events"] = evs
        tr["begin"] = evs[0].get("Time", 0.0)
        tr["end"] = evs[-1].get("Time", 0.0)
        tr["total_ms"] = round((tr["end"] - tr["begin"]) * 1e3, 3)
        roles = []
        for e in evs:
            r = e.get("Role")
            if r and r not in roles:
                roles.append(r)
        tr["roles"] = roles
        version = None
        marks = set()
        for e in evs:
            if "Version" in e and e.get("Type") == "CommitDebug":
                version = e["Version"]
            loc = e.get("Location", "")
            if loc.endswith("commitBatch.Reply") and \
                    e.get("Committed") is False:
                marks.add("rejected")
            for suffix in ("commit.After", "commit.ReadOnly",
                           "commit.UnknownResult", "commit.Error"):
                if loc.endswith(suffix):
                    marks.add(suffix)
        # precedence, not last-event-wins: a conflicted txn's timeline
        # ends with the client's generic commit.Error, which must not
        # shadow the proxy's Committed=false verdict
        if "commit.After" in marks:
            outcome = "committed"
        elif "commit.ReadOnly" in marks:
            outcome = "read_only"
        elif "rejected" in marks:
            outcome = "conflict"
        elif "commit.UnknownResult" in marks:
            outcome = "unknown"
        elif "commit.Error" in marks:
            outcome = "error"
        else:
            outcome = "incomplete"
        tr["commit_version"] = version
        tr["outcome"] = outcome
    return traces


def join_storage_applies(traces: dict[str, dict],
                         events: list[dict]) -> None:
    """Attach StorageApplyDebug batches whose [MinVersion, MaxVersion]
    window covers a transaction's commit version — the async half of the
    storage role's participation in the timeline."""
    applies = [e for e in events if e.get("Type") == "StorageApplyDebug"]
    if not applies:
        return
    applies.sort(key=lambda e: e.get("MinVersion", 0))
    for tr in traces.values():
        v = tr.get("commit_version")
        # only COMMITTED txns have mutations in any apply batch — a
        # conflicted/errored txn's Version would false-join the window
        # (and a read-only txn's Version is a read version)
        if v is None or tr.get("outcome") != "committed":
            continue
        hits = [a for a in applies
                if a.get("MinVersion", 0) <= v <= a.get("MaxVersion", -1)]
        if hits:
            tr["storage_applies"] = hits
            if "StorageServer" not in tr["roles"]:
                tr["roles"].append("StorageServer")


def join_slow_tasks(traces: dict[str, dict], events: list[dict]) -> None:
    """Correlate SlowTask stalls with transactions whose live window
    overlaps the stall.

    The stall window comes from the event's Begin/EndMonotonic details:
    SlowTask is emitted from the profiler's watchdog THREAD, where the
    trace clock falls back to wall time, while span events carry the
    event loop's (monotonic) time — the Time fields of the two families
    are not comparable on a real cluster.  Begin/EndMonotonic share the
    loop's clock base.  Events predating those fields fall back to
    [Time - DurationMs, Time] (only right when both clocks agree)."""
    stalls = [e for e in events if e.get("Type") == "SlowTask"]
    if not stalls:
        return
    for tr in traces.values():
        hits = []
        for s in stalls:
            if "EndMonotonic" in s:
                s_end = s["EndMonotonic"]
                s_begin = s.get("BeginMonotonic",
                                s_end - s.get("DurationMs", 0.0) / 1e3)
            else:
                s_end = s.get("Time", 0.0)
                s_begin = s_end - s.get("DurationMs", 0.0) / 1e3
            if s_begin <= tr["end"] and tr["begin"] <= s_end:
                hits.append(s)
        if hits:
            tr["slow_tasks"] = hits


def critical_path(tr: dict) -> list[dict]:
    """The transaction's ordered span segments: for each consecutive
    pair of events, the elapsed ms and the hop it labels."""
    segs = []
    evs = tr["events"]
    for a, b in zip(evs, evs[1:]):
        segs.append({
            "from": f"{a.get('Role', '?')}:{a.get('Location', '?')}",
            "to": f"{b.get('Role', '?')}:{b.get('Location', '?')}",
            "ms": round((b.get("Time", 0.0) - a.get("Time", 0.0)) * 1e3, 3),
        })
    return segs


def is_complete(tr: dict) -> bool:
    """A timeline is complete when every commit-path role contributed a
    span AND the storage role participated (read span or apply join)."""
    roles = set(tr["roles"])
    return (all(r in roles for r in REQUIRED_ROLES)
            and ("StorageServer" in roles or "storage_applies" in tr))


def _pctl(xs: list[float], p: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


def span_stats(traces: dict[str, dict]) -> dict[str, dict]:
    """Per-segment p50/p99 across every reconstructed transaction,
    keyed by the segment's (from → to) label."""
    samples: dict[str, list[float]] = {}
    for tr in traces.values():
        for seg in critical_path(tr):
            samples.setdefault(f"{seg['from']} -> {seg['to']}",
                               []).append(seg["ms"])
    return {
        label: {
            "n": len(xs),
            "p50_ms": round(_pctl(xs, 0.5), 3),
            "p99_ms": round(_pctl(xs, 0.99), 3),
            "max_ms": round(max(xs), 3),
        }
        for label, xs in sorted(samples.items())
    }


def analyze(events: list[dict], top: int = 10) -> dict:
    """The whole report: reconstruct, join, rank."""
    traces = reconstruct(events)
    join_storage_applies(traces, events)
    join_slow_tasks(traces, events)
    ranked = sorted(traces.items(), key=lambda kv: -kv[1]["total_ms"])
    slowest = [{
        "trace_id": tid,
        "total_ms": tr["total_ms"],
        "outcome": tr["outcome"],
        "complete": is_complete(tr),
        "roles": tr["roles"],
        "commit_version": tr.get("commit_version"),
        "slow_tasks": len(tr.get("slow_tasks", ())),
        "critical_path": critical_path(tr),
    } for tid, tr in ranked[:top]]
    return {
        "traces": len(traces),
        "complete": sum(1 for tr in traces.values() if is_complete(tr)),
        "outcomes": _count(tr["outcome"] for tr in traces.values()),
        "span_stats": span_stats(traces),
        "slowest": slowest,
        "slow_task_correlated": sum(
            1 for tr in traces.values() if tr.get("slow_tasks")),
    }


def _count(it) -> dict[str, int]:
    out: dict[str, int] = {}
    for x in it:
        out[x] = out.get(x, 0) + 1
    return out


def format_timeline(tid: str, tr: dict) -> str:
    lines = [f"trace {tid}  total={tr['total_ms']}ms  "
             f"outcome={tr['outcome']}  roles={'>'.join(tr['roles'])}"]
    t0 = tr["begin"]
    for e in tr["events"]:
        dt = (e.get("Time", 0.0) - t0) * 1e3
        extra = " ".join(f"{k}={e[k]}" for k in ("Version", "Txns", "Rows",
                                                 "Committed", "Error")
                         if k in e)
        lines.append(f"  +{dt:9.3f}ms  {e.get('Role', '?'):<14} "
                     f"{e.get('Location', '?')} {extra}".rstrip())
    for a in tr.get("storage_applies", ()):
        lines.append(f"  [apply] tag={a.get('Tag')} "
                     f"versions=[{a.get('MinVersion')}, "
                     f"{a.get('MaxVersion')}] "
                     f"mutations={a.get('Mutations')} "
                     f"dur={a.get('DurationMs')}ms")
    for s in tr.get("slow_tasks", ()):
        lines.append(f"  [slowtask] {s.get('DurationMs')}ms ending at "
                     f"t={s.get('Time')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="trace JSONL file(s); rolled .N siblings of each "
                         "are included automatically")
    ap.add_argument("--top", type=int, default=10,
                    help="how many slowest transactions to list")
    ap.add_argument("--trace", help="print one trace id's full timeline")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    args = ap.parse_args(argv)

    paths: list[str] = []
    missing: list[str] = []
    for p in args.paths:
        found = rolled_paths(p)
        paths.extend(found)
        if not found:
            missing.append(p)
    if missing:
        print(f"no such trace file(s): {', '.join(missing)}",
              file=sys.stderr)
        return 1
    events = load_events(paths)
    if args.trace:
        traces = reconstruct(events)
        join_storage_applies(traces, events)
        join_slow_tasks(traces, events)
        tr = traces.get(args.trace)
        if tr is None:
            print(f"no such trace {args.trace}; have: "
                  f"{', '.join(sorted(traces))}", file=sys.stderr)
            return 1
        print(format_timeline(args.trace, tr))
        return 0

    report = analyze(events, top=args.top)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
        return 0
    print(f"events={len(events)} traces={report['traces']} "
          f"complete={report['complete']} outcomes={report['outcomes']} "
          f"slowtask-correlated={report['slow_task_correlated']}")
    print("\nper-span latency (across traces):")
    for label, row in report["span_stats"].items():
        print(f"  {row['p50_ms']:9.3f}ms p50 {row['p99_ms']:9.3f}ms p99 "
              f"(n={row['n']})  {label}")
    print(f"\ntop {len(report['slowest'])} slowest:")
    for s in report["slowest"]:
        print(f"  {s['trace_id']}  {s['total_ms']:9.3f}ms  {s['outcome']:<10}"
              f" complete={s['complete']} slow_tasks={s['slow_tasks']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
