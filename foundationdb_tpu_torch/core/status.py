"""Status aggregation — the ``status json`` document.

Reference: REF:fdbserver/Status.actor.cpp — the cluster controller
aggregates role health and metrics into one JSON document fdbcli and
monitoring consume.  Here the aggregator runs client-side: it reads the
published cluster state from the coordinators, probes every role address
(well-known PING token) and pulls role metrics over their RPC surface.
"""

from __future__ import annotations

import asyncio

from ..rpc.stubs import (CommitProxyClient, GrvProxyClient, RatekeeperClient,
                         ResolverClient, StorageClient, TLogClient)
from ..rpc.transport import Endpoint, NetworkAddress, Transport, WLTOKEN_PING
from ..runtime.knobs import Knobs
from .cluster_client import fetch_cluster_state
from .data import KeyRange


async def _probe(transport: Transport, addr: NetworkAddress,
                 timeout: float) -> bool:
    try:
        await asyncio.wait_for(
            transport.request(Endpoint(addr, WLTOKEN_PING), b"ping"),
            timeout=timeout)
        return True
    except Exception:       # noqa: BLE001 — any failure means unreachable
        return False


def lag_rollup(roles: list[dict], knobs: Knobs) -> dict:
    """``cluster.lag``: the version-frontier picture across
    every role, computed from the SAME metrics() surfaces the RPC
    pollers serve — and from the same gauges the MetricsRegistry
    records every interval, so a live status poll and a post-hoc
    ``metrics_tool lag`` replay of the trace file agree by
    construction.

    - ``worst_durability_lag_versions``: max(applied - durable) across
      durable storage — the ratekeeper's falloff input, now visible.
    - ``worst_storage_queue_bytes`` / ``worst_tlog_queue_bytes``: the
      depth halves of the same falloff.
    - ``window_occupancy``: worst (applied - oldest) / MVCC window —
      at ~1.0 reads at the window floor start dying TransactionTooOld.
    - ``frontier_skew_versions``: spread of applied tips across storage
      (one replica falling behind its peers — the gray-failure shape).
    - ``committed_minus_applied``: sequencer committed tip vs the
      laggiest storage applied tip (end-to-end pipeline lag).
    """
    sm = [r.get("metrics") for r in roles
          if r["role"] == "storage" and r.get("metrics")]
    tm = [r.get("metrics") for r in roles
          if r["role"] == "log" and r.get("metrics")]
    seq = next((r.get("metrics") for r in roles
                if r["role"] == "sequencer" and r.get("metrics")), None)
    durable = [m for m in sm if m.get("durable_engine")]
    versions = [m["version"] for m in sm if "version" in m]
    worst_lag = max((m["version"] - m["durable_version"]
                     for m in durable), default=0)
    occ = max(((m["version"] - m.get("oldest_version", m["version"]))
               / max(1, knobs.STORAGE_VERSION_WINDOW) for m in sm),
              default=0.0)
    committed = seq.get("committed") if seq else None
    if committed is None:
        committed = max((m.get("known_committed", 0) for m in tm),
                        default=0) or None
    return {
        "worst_durability_lag_versions": worst_lag,
        "worst_durability_lag_tag": next(
            (m["tag"] for m in durable
             if m["version"] - m["durable_version"] == worst_lag), None)
        if durable and worst_lag else None,
        "worst_storage_queue_bytes": max(
            (m.get("queue_bytes", 0) for m in sm), default=0),
        "worst_tlog_queue_bytes": max(
            (m.get("queue_bytes", 0) for m in tm), default=0),
        "window_occupancy": round(occ, 4),
        "frontier_skew_versions":
            (max(versions) - min(versions)) if versions else 0,
        "committed_version": committed,
        "committed_minus_applied":
            (committed - min(versions)) if committed is not None and versions
            else 0,
        "tlog_tip_minus_popped": max(
            (m["version"] - m.get("popped", 0) for m in tm
             if m.get("popped", 0) > 0), default=0),
        "storage_durable_floor": min(
            (m["durable_version"] for m in durable), default=0),
    }


def slow_task_rollup(roles: list[dict]) -> dict:
    """Event-loop stall rollup: every role's
    metrics() splats its hosting process's SlowTaskProfiler counters,
    grouped here by machine IP (one process per sim machine) — the
    r5-class loop-occupancy incident at one glance instead of a grep
    for SlowTask events."""
    by_ip: dict[str, dict] = {}
    for r in roles:
        m = r.get("metrics") or {}
        if "slow_task_stalls" not in m:
            continue
        ip = r["addr"][0]
        e = by_ip.setdefault(ip, {"ip": ip, "stalls": 0,
                                  "last_stall_ms": 0.0})
        e["stalls"] = max(e["stalls"], m["slow_task_stalls"])
        e["last_stall_ms"] = max(e["last_stall_ms"],
                                 m.get("slow_task_last_stall_ms", 0.0))
    procs = sorted(by_ip.values(), key=lambda e: -e["stalls"])
    return {
        "processes": procs,
        "total_stalls": sum(e["stalls"] for e in procs),
        "worst_stall_ms": max((e["last_stall_ms"] for e in procs),
                              default=0.0),
    }


async def cluster_status(knobs: Knobs, transport: Transport,
                         coordinators: list) -> dict:
    """Build the status document from the latest published cluster state."""
    state = await fetch_cluster_state(coordinators)
    t = knobs.FAILURE_TIMEOUT

    def addr(a) -> NetworkAddress:
        return NetworkAddress(a[0], a[1])

    roles: list[dict] = []
    roles.append({"role": "sequencer", "addr": list(state["sequencer"]["addr"]),
                  "token": state["sequencer"]["token"]})
    gen = state["log_cfg"][-1]
    for i, a in enumerate(gen["tlogs"]):
        roles.append({"role": "log", "addr": list(a),
                      "token": gen["token"][i], "index": i})
    for r in state["resolvers"]:
        roles.append({"role": "resolver", "addr": list(r["addr"]),
                      "token": r["token"],
                      "begin": r["begin"], "end": r["end"]})
    for s in state["storage"]:
        roles.append({"role": "storage", "addr": list(s["addr"]),
                      "token": s["token"], "tag": s["tag"],
                      "begin": s["begin"], "end": s["end"]})
    for p in state["commit_proxies"]:
        roles.append({"role": "commit_proxy", "addr": list(p["addr"]),
                      "token": p["token"]})
    for p in state["grv_proxies"]:
        roles.append({"role": "grv_proxy", "addr": list(p["addr"]),
                      "token": p["token"]})
    if state.get("ratekeeper"):
        roles.append({"role": "ratekeeper",
                      "addr": list(state["ratekeeper"]["addr"]),
                      "token": state["ratekeeper"]["token"]})

    # probe reachability concurrently
    alive = await asyncio.gather(
        *(_probe(transport, addr(r["addr"]), t) for r in roles))
    for r, ok in zip(roles, alive):
        r["reachable"] = ok

    # pull metrics from reachable metric-bearing roles
    async def enrich(r: dict) -> None:
        from ..rpc.stubs import SequencerClient
        try:
            if r["role"] == "sequencer":
                sq = SequencerClient(transport, addr(r["addr"]), r["token"])
                r["metrics"] = await asyncio.wait_for(sq.metrics(), timeout=t)
            elif r["role"] == "storage":
                sc = StorageClient(transport, addr(r["addr"]), r["token"],
                                   r["tag"], KeyRange(r["begin"], r["end"]))
                r["metrics"] = await asyncio.wait_for(sc.metrics(), timeout=t)
            elif r["role"] == "log":
                tc = TLogClient(transport, addr(r["addr"]), r["token"])
                r["metrics"] = await asyncio.wait_for(tc.metrics(), timeout=t)
            elif r["role"] == "resolver":
                rc2 = ResolverClient(transport, addr(r["addr"]), r["token"],
                                     KeyRange(r["begin"], r["end"]))
                r["metrics"] = await asyncio.wait_for(rc2.metrics(),
                                                      timeout=t)
            elif r["role"] == "grv_proxy":
                gc = GrvProxyClient(transport, addr(r["addr"]), r["token"])
                r["metrics"] = await asyncio.wait_for(gc.metrics(), timeout=t)
            elif r["role"] == "commit_proxy":
                cc = CommitProxyClient(transport, addr(r["addr"]), r["token"])
                r["metrics"] = await asyncio.wait_for(cc.metrics(), timeout=t)
            elif r["role"] == "ratekeeper":
                rc = RatekeeperClient(transport, addr(r["addr"]), r["token"])
                thr = await asyncio.wait_for(rc.get_throttle(), timeout=t)
                r["tps_limit"] = thr["tps_limit"]
                r["batch_tps_limit"] = thr["batch_tps_limit"]
                r["throttled_tags"] = thr["throttled_tags"]
                r["heat_throttled_tags"] = thr.get("heat_throttled_tags", {})
                r["heat_throttle_activations"] = \
                    thr.get("heat_throttle_activations", 0)
                r["limiting_reason"] = thr["reason"]
        except Exception:   # noqa: BLE001 — partial status beats none
            r["metrics_error"] = True

    await asyncio.gather(*(enrich(r) for r in roles if r["reachable"]))
    for r in roles:
        r.pop("begin", None)
        r.pop("end", None)

    healthy = all(r["reachable"] for r in roles)

    # cluster-wide apply-path rollup (the r5 bench collapse was an
    # apply-throughput regression no metric surfaced; status now carries
    # the storage roles' batched-apply counters so the next one is a
    # falling mutations_per_sec / rising apply_batch_max_ms, not a
    # timeout): sums over counters, max over worst-case latencies
    storage_metrics = [r.get("metrics") for r in roles
                       if r["role"] == "storage" and r.get("metrics")]
    apply_rollup = {
        "mutations_applied": sum(
            m.get("mutations_applied", 0) for m in storage_metrics),
        "mutations_per_sec": round(sum(
            m.get("mutations_per_sec", 0.0) for m in storage_metrics), 1),
        "index_merge_ms": round(sum(
            m.get("index_merge_ms", 0.0) for m in storage_metrics), 3),
        "apply_batch_max_ms": max(
            (m.get("apply_batch_max_ms", 0.0) for m in storage_metrics),
            default=0.0),
    }

    # lsm compaction rollup: write amplification, compaction
    # debt and commit-path stalls across the durable lsm engines — a
    # compactor falling behind shows up as rising debt bytes, a merge
    # leaking onto the commit path as a rising stall max, write amp
    # regressing toward the monolithic O(keyspace) shape as a rising
    # ratio — before any of them becomes a latency incident
    lsm_metrics = [m for m in storage_metrics if "lsm_runs" in m]
    ingest = sum(m.get("lsm_ingest_bytes", 0) for m in lsm_metrics)
    compacted = sum(m.get("lsm_compact_bytes", 0) for m in lsm_metrics)
    lsm_rollup = {
        "engines": len(lsm_metrics),
        "runs": sum(m.get("lsm_runs", 0) for m in lsm_metrics),
        "compactions": sum(m.get("lsm_compactions", 0)
                           for m in lsm_metrics),
        "ingest_bytes": ingest,
        "compact_bytes": compacted,
        "write_amp": round(compacted / max(1, ingest), 3),
        "compact_debt_bytes": sum(m.get("lsm_compact_debt_bytes", 0)
                                  for m in lsm_metrics),
        "compact_stall_ms": max(
            (m.get("lsm_compact_stall_ms", 0.0) for m in lsm_metrics),
            default=0.0),
    }

    # change-feed rollup: the storage roles' feed retention +
    # stream counters, so a stuck consumer shows up as rising
    # feed_mem/spilled bytes and a dead one as a flat streams count —
    # before the retention window becomes a memory incident
    feed_ids: set = set()
    for m in storage_metrics:
        feed_ids.update(bytes(i) for i in m.get("feed_ids") or [])
    feed_rollup = {
        # distinct ids across the fleet: max() would undercount feeds
        # living on disjoint servers, sum() would double-count replicas
        "active_feeds": len(feed_ids),
        "retained_entries": sum(
            m.get("feed_entries", 0) for m in storage_metrics),
        "retained_bytes": sum(
            m.get("feed_mem_bytes", 0) for m in storage_metrics),
        "spilled_bytes": sum(
            m.get("feed_spilled_bytes", 0) for m in storage_metrics),
        "streams_served": sum(
            m.get("feed_streams_served", 0) for m in storage_metrics),
        "mutations_captured": sum(
            m.get("feed_mutations_captured", 0) for m in storage_metrics),
    }

    # device-commit-pipeline rollup: the resolvers' DevicePipeline
    # queue/in-flight counters, so a slow commit's wait shows up as rising
    # queue depth (host-side backlog) vs dispatch/readback p99 (device-side
    # cost) without grepping role metrics — the status half of the
    # ResolverDevice.enqueue/dispatch/readback span events trace_tool joins
    resolver_metrics = [r.get("metrics") for r in roles
                        if r["role"] == "resolver" and r.get("metrics")]
    device_resolvers = [m for m in resolver_metrics
                        if m.get("device_pipeline")]
    resolver_device_rollup = {
        "pipelined_resolvers": len(device_resolvers),
        "enqueued": sum(m.get("device_enqueued", 0)
                        for m in device_resolvers),
        "dispatches": sum(m.get("device_dispatches", 0)
                          for m in device_resolvers),
        "queue_depth": sum(m.get("device_queue_depth", 0)
                           for m in device_resolvers),
        "queue_peak": max((m.get("device_queue_peak", 0)
                           for m in device_resolvers), default=0),
        "inflight": sum(m.get("device_inflight", 0)
                        for m in device_resolvers),
        "inflight_peak": max((m.get("device_inflight_peak", 0)
                              for m in device_resolvers), default=0),
        "dispatch_p99_ms": max((m.get("device_dispatch_p99_ms", 0.0)
                                for m in device_resolvers), default=0.0),
        "readback_p99_ms": max((m.get("device_readback_p99_ms", 0.0)
                                for m in device_resolvers), default=0.0),
        "overlap_ratio": round(
            sum(m.get("device_overlap_ratio", 0.0)
                for m in device_resolvers) / len(device_resolvers), 3)
        if device_resolvers else 0.0,
        "poisoned": sum(m.get("device_poisoned", 0)
                        for m in device_resolvers),
    }

    # device read serving rollup: how much of get_values'
    # missing-key traffic the PackedKeyIndex device mirror actually
    # answered vs fell back to the engine path (stale mirror / below
    # the batch threshold), plus the mirror re-upload volume
    device_reads_rollup = {
        "active_servers": sum(
            1 for m in storage_metrics if m.get("device_read_active")),
        "batches_served": sum(
            m.get("device_read_batches", 0) for m in storage_metrics),
        "keys_served": sum(
            m.get("device_read_keys", 0) for m in storage_metrics),
        "fallbacks": sum(
            m.get("device_read_fallbacks", 0) for m in storage_metrics),
        "mirror_uploads": sum(
            m.get("device_read_uploads", 0) for m in storage_metrics),
        # staleness gauge: worst-case versions any
        # server's mirror trails its engine tip — a sustained non-zero
        # here means refreshes aren't keeping up with the write rate
        "staleness_versions_max": max(
            (m.get("device_read_staleness_versions", 0)
             for m in storage_metrics), default=0),
        # sharded-mirror shape: per-chip shard
        # counts and the partial-refresh vs full-split traffic
        "shards": sum(
            m.get("device_read_shards", 0) for m in storage_metrics),
        "shard_refreshes": sum(
            m.get("device_read_shard_refreshes", 0)
            for m in storage_metrics),
        "full_splits": sum(
            m.get("device_read_full_splits", 0) for m in storage_metrics),
        "cross_shard_gathers": sum(
            m.get("device_read_gathers", 0) for m in storage_metrics),
    }

    # shard-heat rollup: the top-k hottest shards by decayed
    # read+write rate plus the active (heat-armed) tag throttles — the
    # first place a zipfian hotspot shows up, before it becomes an
    # abort-rate or tail-latency incident
    rk_rows = [r for r in roles if r["role"] == "ratekeeper"]
    rk = rk_rows[0] if rk_rows else {}
    # aggregate per SHARD, not per server: with replication >= 2 one hot
    # shard's replicas would otherwise occupy multiple top-k slots and
    # push the genuinely-next-hottest shard out of the rollup.  Reads
    # SUM over the team (the client spreads them), writes MAX (every
    # replica applies the full stream) — the DD merge discipline.
    by_shard: dict = {}
    for m in storage_metrics:
        key = (bytes(m.get("shard_begin") or b""),
               bytes(m.get("shard_end") or b""))
        e = by_shard.setdefault(key, {"tags": [], "reads_per_sec": 0.0,
                                      "writes_per_sec": 0.0})
        e["tags"].append(m["tag"])
        e["reads_per_sec"] = round(
            e["reads_per_sec"] + m.get("shard_reads_per_sec", 0.0), 3)
        e["writes_per_sec"] = max(
            e["writes_per_sec"], m.get("shard_writes_per_sec", 0.0))
    for e in by_shard.values():
        e["rw_per_sec"] = round(e["reads_per_sec"] + e["writes_per_sec"], 3)
    heat_ranked = sorted(by_shard.values(),
                         key=lambda e: -e["rw_per_sec"])
    shard_heat_rollup = {
        "top_shards": heat_ranked[:5],
        "tracked_servers": len(storage_metrics),
        "throttled_tags": rk.get("throttled_tags", {}),
        "heat_throttled_tags": rk.get("heat_throttled_tags", {}),
        "heat_throttle_activations": rk.get("heat_throttle_activations", 0),
    }

    # hot-move rollup: the data distributor's relocation
    # counters ride the published cluster state (dd_stats lands with
    # every flip publish), so heat splits/moves are visible without a
    # DD RPC surface; all-zero until the first relocation publishes
    dd_stats = state.get("dd_stats") or {}
    hot_moves_rollup = {
        "splits": dd_stats.get("splits", 0),
        "live_moves": dd_stats.get("live_moves", 0),
        "heat_splits": dd_stats.get("heat_splits", 0),
        "heat_moves": dd_stats.get("heat_moves", 0),
        "last_heat_rw_per_sec": dd_stats.get("last_heat_rw_per_sec", 0.0),
    }

    # backup rollup: each running feed-native backup agent
    # publishes \xff/backup/progress/<name> state transactions; read
    # them back through an ordinary snapshot transaction so status
    # reports snapshot/log frontiers, lag vs the committed version
    # (the GRV the read itself pinned), bytes written, and liveness —
    # without the agents needing an RPC surface.  Best-effort: a
    # cluster that cannot serve reads degrades to an empty rollup.
    backup_rollup: dict = {"agents": [], "active": 0}
    try:
        from ..rpc.wire import decode as _decode
        from .cluster_client import RecoveredClusterView, RefreshingDatabase
        from .system_data import BACKUP_PROGRESS_PREFIX
        view = RecoveredClusterView(knobs, transport, state)
        bdb = RefreshingDatabase(view, coordinators)
        tr = bdb.create_transaction()
        tr.lock_aware = True
        now_version = await asyncio.wait_for(tr.get_read_version(),
                                             timeout=t)
        rows = await asyncio.wait_for(
            tr.get_range(BACKUP_PROGRESS_PREFIX,
                         BACKUP_PROGRESS_PREFIX + b"\xff",
                         limit=100, snapshot=True), timeout=t)
        agents = []
        for k, v in rows:
            try:
                rec = _decode(bytes(v))
            except Exception:  # noqa: BLE001 — torn progress blob
                continue
            name = bytes(k)[len(BACKUP_PROGRESS_PREFIX):].decode(
                errors="replace")
            through = rec.get("log_through") or 0
            agents.append({
                "name": name,
                "snapshot_version": rec.get("snapshot_version"),
                "log_through": through,
                "lag_versions": max(0, now_version - through),
                "bytes_logged": rec.get("bytes_logged", 0),
                "bytes_snapshotted": rec.get("bytes_snapshotted", 0),
                "stopped": bool(rec.get("stopped", False)),
            })
        backup_rollup = {
            "agents": agents,
            "active": sum(1 for a in agents if not a["stopped"]),
        }
    except Exception:   # noqa: BLE001 — partial status beats none
        pass

    # layers rollup: every running LayerFeedConsumer
    # publishes \xff/layers/progress/<name> → encode(stats) on the
    # backup-progress discipline; read the rows back best-effort so
    # status shows each consumer's freshness frontier (and its lag vs
    # the committed version this read pinned) plus whatever per-layer
    # stats its sinks splat — index row counts, cache hit rate, watch
    # fire latency — without the layers needing an RPC surface.
    layers_rollup: dict = {"consumers": [], "active": 0}
    try:
        from ..rpc.wire import decode as _decode
        from .cluster_client import RecoveredClusterView, RefreshingDatabase
        from .system_data import LAYER_PROGRESS_PREFIX
        view = RecoveredClusterView(knobs, transport, state)
        ldb = RefreshingDatabase(view, coordinators)
        tr = ldb.create_transaction()
        tr.lock_aware = True
        now_version = await asyncio.wait_for(tr.get_read_version(),
                                             timeout=t)
        rows = await asyncio.wait_for(
            tr.get_range(LAYER_PROGRESS_PREFIX,
                         LAYER_PROGRESS_PREFIX + b"\xff",
                         limit=100, snapshot=True), timeout=t)
        consumers = []
        for k, v in rows:
            try:
                rec = _decode(bytes(v))
            except Exception:  # noqa: BLE001 — torn progress blob
                continue
            name = bytes(k)[len(LAYER_PROGRESS_PREFIX):].decode(
                errors="replace")
            frontier = rec.get("frontier") or 0
            consumers.append({
                "name": name,
                "frontier": frontier,
                "lag_versions": max(0, now_version - frontier),
                "entries_delivered": rec.get("entries", 0),
                "reconnects": rec.get("reconnects", 0),
                "destroyed": bool(rec.get("destroyed", False)),
                "sinks": rec.get("sinks", []),
            })
        layers_rollup = {
            "consumers": consumers,
            "active": sum(1 for c in consumers if not c["destroyed"]),
        }
    except Exception:   # noqa: BLE001 — partial status beats none
        pass

    # disk-degradation rollup (the gray-failure surface): any
    # disk-bearing role (durable storage, durable TLogs) publishes its
    # machine's decayed per-op disk latency + degraded flag through the
    # metrics it already serves; group by machine IP (one disk per sim
    # machine) taking the worst latency seen.  A slow-but-alive disk
    # shows up HERE — with its latency — long before it becomes a tail
    # -latency incident, and `count` > 0 is the one-glance cluster
    # health bit.
    by_ip: dict[str, dict] = {}
    for r in roles:
        m = r.get("metrics") or {}
        if "disk_latency_ms" not in m:
            continue
        ip = r["addr"][0]
        e = by_ip.setdefault(ip, {"ip": ip, "latency_ms": 0.0,
                                  "degraded": False, "roles": []})
        e["latency_ms"] = max(e["latency_ms"], m["disk_latency_ms"])
        e["degraded"] = e["degraded"] or bool(m.get("disk_degraded"))
        if r["role"] not in e["roles"]:
            e["roles"].append(r["role"])
    disks = sorted(by_ip.values(), key=lambda e: -e["latency_ms"])
    degraded_rollup = {
        "disks": disks,
        "count": sum(1 for e in disks if e["degraded"]),
    }

    # distributed-tracing rollup: every metric-bearing role
    # reports its span counters; sampled_txns comes from the GRV proxies
    # (where every sampled root first crosses the wire).  SERVER-side
    # sinks only: client NativeAPI.* events and wire-level RpcDebug
    # receives are counted in their own client processes, so the trace
    # file always holds MORE events than this rollup
    # — a deficit there is expected, not span loss.
    all_metrics = [r.get("metrics") for r in roles if r.get("metrics")]
    tracing_rollup = {
        "spans_emitted": sum(
            m.get("spans_emitted", 0) for m in all_metrics),
        "spans_dropped": sum(
            m.get("spans_dropped", 0) for m in all_metrics),
        "sampled_txns": sum(
            m.get("sampled_txns", 0) for m in all_metrics),
    }
    # process-wide trace-plane loss: every role
    # splats its process's span TOTALS + probe-eviction counters, so
    # dedupe by machine IP with max (one process per sim machine — the
    # slow-task discipline) then sum across processes.  Nonzero
    # ``probe_evictions``/``totals_spans_dropped`` is silent trace loss
    # that previously had no surface at all.
    by_proc: dict[str, dict] = {}
    for r in roles:
        m = r.get("metrics") or {}
        if "probe_evictions" not in m:
            continue
        ip = r["addr"][0]
        e = by_proc.setdefault(ip, {"probe_evictions": 0,
                                    "totals_spans_emitted": 0,
                                    "totals_spans_dropped": 0,
                                    "totals_sampled_txns": 0})
        e["probe_evictions"] = max(e["probe_evictions"],
                                   m["probe_evictions"])
        e["totals_spans_emitted"] = max(e["totals_spans_emitted"],
                                        m.get("span_totals_emitted", 0))
        e["totals_spans_dropped"] = max(e["totals_spans_dropped"],
                                        m.get("span_totals_dropped", 0))
        e["totals_sampled_txns"] = max(e["totals_sampled_txns"],
                                       m.get("span_sampled_txns", 0))
    for k in ("probe_evictions", "totals_spans_emitted",
              "totals_spans_dropped", "totals_sampled_txns"):
        tracing_rollup[k] = sum(e[k] for e in by_proc.values())

    # routed-mesh rollup: the
    # per-partition routing shape on the LIVE plane — routed sends and
    # empty-clip header-only replies summed over the commit proxies'
    # route_stats, plus each partition's fusion depth and conflict-
    # window occupancy off the resolvers' own metrics
    proxy_metrics = [r.get("metrics") for r in roles
                     if r["role"] == "commit_proxy" and r.get("metrics")]
    n_parts = max((len(m.get("route_stats", []))
                   for m in proxy_metrics), default=0)
    routed = [{"sends": 0, "header_only": 0, "txns_routed": 0}
              for _ in range(n_parts)]
    for m in proxy_metrics:
        for i, st in enumerate(m.get("route_stats", [])):
            for k in routed[i]:
                routed[i][k] += st.get(k, 0)
    mesh_partitions = [{
        "total_batches": m.get("total_batches", 0),
        "header_batches": m.get("total_header_batches", 0),
        "fused_group_mean": m.get("fused_group_mean", 0.0),
        "window_occupancy": m.get("window_occupancy", 0.0),
    } for m in resolver_metrics]
    resolver_mesh_rollup = {
        "partitions": len(resolver_metrics),
        "routed_sends": sum(st["sends"] for st in routed),
        "header_only_replies": sum(st["header_only"] for st in routed),
        "txns_routed": sum(st["txns_routed"] for st in routed),
        "per_partition_routing": routed,
        "per_partition": mesh_partitions,
    }

    # consistency-scrub rollup: the scrubber publishes
    # scrub_stats with the CC state at every pass end (the dd_stats
    # discipline — no scrubber RPC surface needed); all-zero until the
    # first full pass lands
    scrub_stats = state.get("scrub_stats") or {}
    scrub_rollup = {
        "enabled": bool(getattr(knobs, "SCRUB_ENABLED", False)),
        "pages_per_sec": scrub_stats.get("pages_per_sec", 0.0),
        "pages_scrubbed": scrub_stats.get("pages_scrubbed", 0),
        "rows_scrubbed": scrub_stats.get("rows_scrubbed", 0),
        "passes_complete": scrub_stats.get("passes_complete", 0),
        "last_pass_version": scrub_stats.get("last_pass_version", 0),
        "last_pass_duration_s": scrub_stats.get("last_pass_duration_s",
                                                0.0),
        "mismatch_pages": scrub_stats.get("mismatch_pages", 0),
        "mismatch_rows": scrub_stats.get("mismatch_rows", 0),
        "refusals": scrub_stats.get("refusals", 0),
        "ranges_skipped": scrub_stats.get("ranges_skipped", 0),
        "invariant_checks": scrub_stats.get("invariant_checks", 0),
        "invariant_violations": scrub_stats.get("invariant_violations",
                                                0),
    }

    return {
        "cluster": {
            "epoch": state["epoch"],
            "recovery_version": state["recovery_version"],
            "database_available": healthy,
            "degraded_roles": [
                {"role": r["role"], "addr": r["addr"]}
                for r in roles if not r["reachable"]],
            "storage_apply": apply_rollup,
            "lsm_compaction": lsm_rollup,
            "change_feeds": feed_rollup,
            "resolver_device": resolver_device_rollup,
            "device_reads": device_reads_rollup,
            "shard_heat": shard_heat_rollup,
            "hot_moves": hot_moves_rollup,
            "backup": backup_rollup,
            "layers": layers_rollup,
            "degraded": degraded_rollup,
            "tracing": tracing_rollup,
            "resolver_mesh": resolver_mesh_rollup,
            "scrub": scrub_rollup,
            # the version-frontier picture: computed from the
            # same registry-backed metrics the trace file records every
            # interval, so status-now and metrics_tool-replay agree
            "lag": lag_rollup(roles, knobs),
            "slow_tasks": slow_task_rollup(roles),
        },
        "roles": roles,
        "shards": {
            "boundaries": state["shard_boundaries"],
            "teams": state["shard_teams"],
        },
    }
