#!/usr/bin/env python
"""Trace-derived time-series tooling — the flight recorder's read side.

The metrics plane (``runtime/metrics.py``) records every
role's counters and gauges into the trace JSONL as periodic ``*Metrics``
events, and the cluster controller writes a severity-pinned
``RecoveryState`` audit event at every recovery step.  This tool
reconstructs both AFTER THE FACT, from the rolled trace files alone —
an incident (a durability-lag spiral, an ambiguous-commit recovery cut)
can be replayed instead of reproduced under a live status poll.

Views:

- ``summary``:  every metrics series (one per Type+ID pair): emission
  count, time span, cadence, and the final sample of each numeric field.
- ``lag``:      the durability-lag / queue-depth time-series per storage
  tag (from ``StorageMetrics``: Version − DurableVersion over Time) and
  the TLog tip-vs-popped gap — the ratekeeper's falloff inputs, over
  time.  The same numbers ``cluster.lag`` in status computes live.
- ``recovery``: the full version-cut audit of every recovery in the
  file: per epoch, each RecoveryState step in order with its cuts,
  locked-tip vector and durable-copy adoptions.
- ``scrub``:    the consistency-scrub record: every completed
  replica-audit pass with its pinned version and pace, every key-exact
  ``ScrubMismatch``, every frontier ``ScrubInvariantViolation``, and the
  ``ScrubMetrics`` progress series — ``cluster.scrub``, after the fact.
- ``diff``:     two runs' series compared — emission counts and final
  numeric samples, largest relative deltas first (the plane-on/plane-off
  or before/after-regression A/B in one command).

Usage:
    python -m foundationdb_tpu_torch.tools.metrics_tool summary  trace.jsonl [more.jsonl ...]
    python -m foundationdb_tpu_torch.tools.metrics_tool lag      trace.jsonl [--series]
    python -m foundationdb_tpu_torch.tools.metrics_tool recovery trace.jsonl
    python -m foundationdb_tpu_torch.tools.metrics_tool scrub    trace.jsonl
    python -m foundationdb_tpu_torch.tools.metrics_tool diff     a.jsonl b.jsonl
    (any view: ``--json`` emits the full report as JSON; rolled ``.N``
    siblings of each path are included automatically)
"""

from __future__ import annotations

import argparse
import json
import sys

from .trace_tool import load_events, rolled_paths

def is_metrics_event(ev: dict) -> bool:
    t = ev.get("Type", "")
    return t.endswith("Metrics") or t.startswith("Histogram")


def series_key(ev: dict) -> str:
    id_ = ev.get("ID", "")
    return f"{ev['Type']}/{id_}" if id_ != "" else ev["Type"]


def extract_series(events: list[dict]) -> dict[str, list[dict]]:
    """{``Type/ID``: time-ordered metric emissions} — the raw flight
    record, one list per role instance."""
    out: dict[str, list[dict]] = {}
    for ev in events:
        if is_metrics_event(ev):
            out.setdefault(series_key(ev), []).append(ev)
    for rows in out.values():
        rows.sort(key=lambda e: e.get("Time", 0.0))
    return out


def _numeric_fields(ev: dict) -> dict[str, float]:
    skip = {"Time", "Severity"}
    return {k: v for k, v in ev.items()
            if k not in skip and isinstance(v, (int, float))
            and not isinstance(v, bool)}


def summarize(events: list[dict]) -> dict:
    """Per-series emission stats + last numeric sample."""
    series = extract_series(events)
    out: dict[str, dict] = {}
    for key, rows in sorted(series.items()):
        times = [r.get("Time", 0.0) for r in rows]
        gaps = [b - a for a, b in zip(times, times[1:])]
        out[key] = {
            "n": len(rows),
            "t0": round(times[0], 3),
            "t1": round(times[-1], 3),
            "cadence_mean_s": round(sum(gaps) / len(gaps), 3) if gaps
            else None,
            "cadence_max_s": round(max(gaps), 3) if gaps else None,
            "last": _numeric_fields(rows[-1]),
        }
    return {"series": out, "events": len(events),
            "metrics_events": sum(len(r) for r in series.values())}


# --- lag: the durability-lag time-series (acceptance: reconstructed
# from the trace file alone) ---


def lag_series(events: list[dict]) -> dict:
    """Per-storage-tag (Time, applied−durable, queue bytes, window
    occupancy) series plus per-TLog tip−popped series, straight off the
    recorded gauges."""
    storage: dict[str, list] = {}
    tlogs: dict[str, list] = {}
    for ev in events:
        t = ev.get("Time", 0.0)
        if ev.get("Type") == "StorageMetrics" \
                and "Version" in ev and "DurableVersion" in ev:
            if not ev.get("DurableEngine", 0):
                # engine-less storage never advances DurableVersion —
                # status.lag_rollup skips it (durable_engine filter) and
                # so must the replay, or a memory cluster reads as a
                # phantom full-history lag
                continue
            storage.setdefault(str(ev.get("ID", "")), []).append({
                "t": t,
                "lag_versions": ev["Version"] - ev["DurableVersion"],
                "queue_bytes": ev.get("QueueBytes", 0),
                "window_versions": ev.get("WindowVersions", 0),
            })
        elif ev.get("Type") == "TLogMetrics" and "Version" in ev:
            tlogs.setdefault(str(ev.get("ID", "")), []).append({
                "t": t,
                "tip_minus_popped":
                    ev["Version"] - ev.get("Popped", 0)
                    if ev.get("Popped", 0) > 0 else 0,
                "queue_bytes": ev.get("QueueBytes", 0),
            })
    for d in (storage, tlogs):
        for rows in d.values():
            rows.sort(key=lambda r: r["t"])
    return {"storage": storage, "tlogs": tlogs}


def lag_report(events: list[dict]) -> dict:
    s = lag_series(events)
    worst = {"tag": None, "lag_versions": 0, "t": None}
    for tag, rows in s["storage"].items():
        for r in rows:
            if r["lag_versions"] > worst["lag_versions"]:
                worst = {"tag": tag, "lag_versions": r["lag_versions"],
                         "t": r["t"]}
    return {
        "storage_series": {k: len(v) for k, v in s["storage"].items()},
        "tlog_series": {k: len(v) for k, v in s["tlogs"].items()},
        "worst_lag": worst,
        "series": s,
    }


# --- scrub: the replica-audit record ---


def scrub_report(events: list[dict]) -> dict:
    """The consistency-scrub record from the trace alone: every full
    pass (ScrubPassComplete), every key-exact divergence
    (ScrubMismatch), every frontier-invariant violation
    (ScrubInvariantViolation), and the ScrubMetrics progress series —
    the same numbers ``cluster.scrub`` serves live, replayable after
    the fact."""
    passes, mismatches, violations, progress = [], [], [], []
    for ev in events:
        t = ev.get("Type")
        if t == "ScrubPassComplete":
            passes.append({
                "t": ev.get("Time"),
                "pass": ev.get("Pass"),
                "version": ev.get("Version"),
                "pages": ev.get("Pages", 0),
                "rows": ev.get("Rows", 0),
                "duration_s": ev.get("DurationS", 0.0),
                "mismatch_rows": ev.get("MismatchRows", 0),
                "refusals": ev.get("Refusals", 0),
            })
        elif t == "ScrubMismatch":
            mismatches.append({
                "t": ev.get("Time"),
                "key": ev.get("Key"),
                "version": ev.get("Version"),
                "replicas": ev.get("Replicas"),
                "values": ev.get("Values"),
            })
        elif t == "ScrubInvariantViolation":
            violations.append({k: v for k, v in ev.items()
                               if k != "Severity"})
        elif t == "ScrubMetrics":
            progress.append({
                "t": ev.get("Time"),
                "pages": ev.get("PagesScrubbed", 0),
                "rows": ev.get("RowsScrubbed", 0),
                "mismatch_rows": ev.get("MismatchRows", 0),
                "refusals": ev.get("Refusals", 0),
                "passes": ev.get("PassesComplete", 0),
                "invariant_checks": ev.get("InvariantChecks", 0),
                "invariant_violations": ev.get("InvariantViolations", 0),
            })
    for rows in (passes, mismatches, progress):
        rows.sort(key=lambda r: r.get("t") or 0.0)
    last = progress[-1] if progress else {}
    last_pass = passes[-1] if passes else {}
    return {
        "passes": passes,
        "mismatches": mismatches,
        "violations": violations,
        "progress_samples": len(progress),
        "summary": {
            "passes_complete": len(passes),
            "last_pass_version": last_pass.get("version"),
            "last_pass_duration_s": last_pass.get("duration_s"),
            "pages_per_sec": round(
                last_pass["pages"] / last_pass["duration_s"], 3)
            if last_pass.get("duration_s") else 0.0,
            "pages_scrubbed": last.get("pages",
                                       last_pass.get("pages", 0)),
            "mismatch_rows": max(last.get("mismatch_rows", 0),
                                 last_pass.get("mismatch_rows", 0)),
            "invariant_violations": last.get("invariant_violations",
                                             len(violations)),
        },
    }


def layers_report(events: list[dict]) -> dict:
    """The layer-ecosystem record from the trace alone :
    every key-exact derived-state divergence (``LayerMismatch``), every
    checker refusal (``LayerCheckRefused``), feed lifecycle events
    (``LayerFeedDestroyed``/``LayerFeedReconnect``), and the
    ``Layer*Metrics`` progress series the registered layer roles emit —
    index frontier lag, cache hit rate, watch fire latency — the same
    numbers ``cluster.layers`` serves live, replayable after the fact."""
    mismatches, refusals, lifecycle = [], [], []
    series: dict[str, list[dict]] = {"feed": [], "index": [], "cache": [],
                                     "watch": [], "check": []}
    kind_of = {"LayerFeedMetrics": "feed", "LayerIndexMetrics": "index",
               "LayerCacheMetrics": "cache", "LayerWatchMetrics": "watch",
               "LayerCheckMetrics": "check"}
    for ev in events:
        t = ev.get("Type")
        if t == "LayerMismatch":
            mismatches.append({
                "t": ev.get("Time"),
                "layer": ev.get("Layer"),
                "key": ev.get("Key"),
                "version": ev.get("Version"),
                "expected": ev.get("Expected"),
                "actual": ev.get("Actual"),
            })
        elif t == "LayerCheckRefused":
            refusals.append({"t": ev.get("Time"),
                             "layer": ev.get("Layer"),
                             "why": ev.get("Why")})
        elif t in ("LayerFeedDestroyed", "LayerFeedReconnect"):
            lifecycle.append({"t": ev.get("Time"), "event": t,
                              "name": ev.get("Name"),
                              "frontier": ev.get("Frontier")})
        elif t in kind_of:
            row = {k: v for k, v in ev.items()
                   if k not in ("Severity", "Type")}
            row["t"] = row.pop("Time", None)
            series[kind_of[t]].append(row)
    for rows in series.values():
        rows.sort(key=lambda r: r.get("t") or 0.0)
    mismatches.sort(key=lambda r: r.get("t") or 0.0)

    def last(kind: str) -> dict:
        return series[kind][-1] if series[kind] else {}

    return {
        "mismatches": mismatches,
        "refusals": refusals,
        "lifecycle": lifecycle,
        "series": series,
        "progress_samples": sum(len(v) for v in series.values()),
        "summary": {
            "divergences": len(mismatches),
            "divergent_layers": sorted({m["layer"] for m in mismatches}),
            "refusals": len(refusals),
            "feed_frontier": last("feed").get("Frontier"),
            "index_frontier": last("index").get("FrontierVersion"),
            "cache_hit_rate": last("cache").get("HitRate"),
            "watch_fire_latency_ms":
                last("watch").get("FireLatencyMeanMs"),
            "checker_passes": last("check").get("Passes"),
        },
    }


# --- recovery: the version-cut audit trail ---


def recovery_report(events: list[dict]) -> list[dict]:
    """RecoveryState events grouped by epoch, steps in time order —
    each recovery's full cut sequence (locked tips, the chosen
    recovery version, durable-copy adoptions, the accept point)."""
    by_epoch: dict[int, list[dict]] = {}
    for ev in events:
        if ev.get("Type") != "RecoveryState":
            continue
        by_epoch.setdefault(int(ev.get("Epoch", 0)), []).append(ev)
    out = []
    for epoch in sorted(by_epoch):
        steps = sorted(by_epoch[epoch], key=lambda e: e.get("Time", 0.0))
        rv = next((s.get("RecoveryVersion") for s in steps
                   if "RecoveryVersion" in s), None)
        out.append({
            "epoch": epoch,
            "t0": steps[0].get("Time"),
            "t1": steps[-1].get("Time"),
            "recovery_version": rv,
            "completed": any(s.get("Step") == "accepting_commits"
                             for s in steps),
            "adoptions": [s for s in steps
                          if s.get("Step") in ("durable_copy_adopted",
                                               "storage_adopted")],
            "steps": [{k: v for k, v in s.items() if k != "Severity"}
                      for s in steps],
        })
    return out


# --- diff: two runs compared ---


def diff_report(events_a: list[dict], events_b: list[dict],
                top: int = 20) -> dict:
    sa, sb = summarize(events_a)["series"], summarize(events_b)["series"]
    # kind-level totals first: recruited roles carry random token ids,
    # so cross-PROCESS runs rarely share exact series keys — the
    # per-kind emission totals are the comparable surface
    kinds: dict[str, dict] = {}
    for side, s in (("a", sa), ("b", sb)):
        for key, row in s.items():
            kind = key.split("/")[0]
            e = kinds.setdefault(kind, {"a": 0, "b": 0,
                                        "series_a": 0, "series_b": 0})
            e[side] += row["n"]
            e[f"series_{side}"] += 1
    rows = []
    for key in sorted(set(sa) | set(sb)):
        a, b = sa.get(key), sb.get(key)
        if a is None or b is None:
            rows.append({"series": key, "only_in": "a" if b is None else "b",
                         "n_a": a["n"] if a else 0, "n_b": b["n"] if b else 0})
            continue
        deltas = {}
        for f in sorted(set(a["last"]) | set(b["last"])):
            va, vb = a["last"].get(f), b["last"].get(f)
            if va is None or vb is None or va == vb:
                continue
            rel = abs(vb - va) / max(abs(va), abs(vb), 1e-9)
            deltas[f] = {"a": va, "b": vb, "rel": round(rel, 4)}
        rows.append({"series": key, "n_a": a["n"], "n_b": b["n"],
                     "deltas": deltas,
                     "max_rel": max((d["rel"] for d in deltas.values()),
                                    default=0.0)})
    rows.sort(key=lambda r: -(r.get("max_rel") or 1.0
                              if "only_in" in r else r.get("max_rel", 0.0)))
    return {"series_a": len(sa), "series_b": len(sb),
            "kinds": {k: kinds[k] for k in sorted(kinds)},
            "rows": rows[:top]}


# --- CLI ---


def _load(paths: list[str]) -> list[dict]:
    found: list[str] = []
    for p in paths:
        rp = rolled_paths(p)
        if not rp:
            print(f"no such trace file: {p}", file=sys.stderr)
            raise SystemExit(1)
        found.extend(rp)
    return load_events(found)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("view", choices=("summary", "lag", "recovery", "scrub",
                                     "layers", "diff"))
    ap.add_argument("paths", nargs="+",
                    help="trace JSONL file(s); diff takes exactly two")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--series", action="store_true",
                    help="lag: print every sample, not just the summary")
    args = ap.parse_args(argv)

    if args.view == "diff":
        if len(args.paths) != 2:
            print("diff takes exactly two trace paths", file=sys.stderr)
            return 1
        rep = diff_report(_load(args.paths[:1]), _load(args.paths[1:]))
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        print(f"series: a={rep['series_a']} b={rep['series_b']}")
        print("per-kind emissions (a → b):")
        for kind, e in rep["kinds"].items():
            mark = "" if e["a"] == e["b"] else "   <-- differs"
            print(f"  {kind:<40} {e['a']} → {e['b']} "
                  f"({e['series_a']}/{e['series_b']} series){mark}")
        for r in rep["rows"]:
            if "only_in" in r:
                print(f"  {r['series']:<40} only in run "
                      f"{r['only_in']} (n_a={r['n_a']} n_b={r['n_b']})")
                continue
            worst = sorted(r["deltas"].items(),
                           key=lambda kv: -kv[1]["rel"])[:3]
            detail = " ".join(f"{f}:{d['a']}→{d['b']}" for f, d in worst)
            print(f"  {r['series']:<40} n {r['n_a']}→{r['n_b']}  {detail}")
        return 0

    events = _load(args.paths)
    if args.view == "summary":
        rep = summarize(events)
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        print(f"events={rep['events']} metrics={rep['metrics_events']} "
              f"series={len(rep['series'])}")
        for key, row in rep["series"].items():
            cad = f"{row['cadence_mean_s']}s" if row["cadence_mean_s"] \
                is not None else "-"
            print(f"  {key:<40} n={row['n']:<5} "
                  f"t=[{row['t0']}, {row['t1']}] cadence={cad}")
        return 0
    if args.view == "lag":
        rep = lag_report(events)
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        w = rep["worst_lag"]
        print(f"storage series: {rep['storage_series']}  "
              f"tlog series: {rep['tlog_series']}")
        print(f"worst durability lag: tag={w['tag']} "
              f"{w['lag_versions']} versions at t={w['t']}")
        if args.series:
            for tag, rows in sorted(rep["series"]["storage"].items()):
                print(f"  storage {tag}:")
                for r in rows:
                    print(f"    t={r['t']:<12} lag={r['lag_versions']:<10} "
                          f"queue={r['queue_bytes']:<10} "
                          f"window={r['window_versions']}")
        return 0
    if args.view == "scrub":
        rep = scrub_report(events)
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        s = rep["summary"]
        print(f"passes={s['passes_complete']} "
              f"last_version={s['last_pass_version']} "
              f"last_duration_s={s['last_pass_duration_s']} "
              f"pages_per_sec={s['pages_per_sec']}")
        print(f"pages={s['pages_scrubbed']} "
              f"mismatch_rows={s['mismatch_rows']} "
              f"invariant_violations={s['invariant_violations']}")
        for p in rep["passes"]:
            print(f"  pass {p['pass']}  t={p['t']}  v={p['version']}  "
                  f"pages={p['pages']} rows={p['rows']} "
                  f"dur={p['duration_s']}s refusals={p['refusals']}")
        for m in rep["mismatches"]:
            print(f"  MISMATCH key={m['key']} v={m['version']} "
                  f"replicas={m['replicas']}")
        for v in rep["violations"]:
            print(f"  VIOLATION {v.get('Invariant')}: "
                  + " ".join(f"{k}={v[k]}" for k in sorted(v)
                             if k not in ("Type", "Time", "Invariant")))
        return 0
    if args.view == "layers":
        rep = layers_report(events)
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        s = rep["summary"]
        print(f"divergences={s['divergences']} refusals={s['refusals']} "
              f"checker_passes={s['checker_passes']} "
              f"progress_samples={rep['progress_samples']}")
        print(f"feed_frontier={s['feed_frontier']} "
              f"index_frontier={s['index_frontier']} "
              f"cache_hit_rate={s['cache_hit_rate']} "
              f"watch_fire_latency_ms={s['watch_fire_latency_ms']}")
        for m in rep["mismatches"]:
            print(f"  MISMATCH layer={m['layer']} key={m['key']} "
                  f"v={m['version']} expected={m['expected']} "
                  f"actual={m['actual']}")
        for r in rep["refusals"]:
            print(f"  refused layer={r['layer']}: {r['why']}")
        for e in rep["lifecycle"]:
            print(f"  {e['event']} name={e['name']} "
                  f"frontier={e['frontier']}")
        return 0
    # recovery
    rep = recovery_report(events)
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
        return 0
    if not rep:
        print("no RecoveryState events in the trace")
        return 0
    for rec in rep:
        print(f"epoch {rec['epoch']}  t=[{rec['t0']}, {rec['t1']}]  "
              f"recovery_version={rec['recovery_version']}  "
              f"completed={rec['completed']}  "
              f"adoptions={len(rec['adoptions'])}")
        for s in rec["steps"]:
            extra = " ".join(
                f"{k}={s[k]}" for k in ("RecoveryVersion", "Tips",
                                        "GenerationEnd", "DeadLogs",
                                        "Tag", "Index", "Addr",
                                        "LiveWorkers", "RejoinPlanned",
                                        "ActiveTags")
                if k in s)
            print(f"  +{s.get('Time'):<12} {s.get('Step'):<22} "
                  f"{extra}".rstrip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
