"""Online consistency scrubber.

The always-on half of the consistency story: the sim's
ConsistencyCheckWorkload proves replicas identical at workload END; this
role proves it CONTINUOUSLY on a live cluster (the consistency-scan
generalization of REF:fdbserver/workloads/ConsistencyCheck.actor.cpp).
A singleton rides the leading ClusterHost (the DataDistributor
recruitment shape, gated by ``SCRUB_ENABLED``) and walks the shard map
forever under a pages/sec budget: per chunk it pins a read version via
GRV, fans one ``scrub_page`` digest request to EVERY replica in the
shard's team — degraded replicas INCLUDED, auditing them is the point —
and compares the per-page (end_key, row_count, digest) triples.  A
mismatch bisects down to exact rows through the packed range-read path
and emits severity-40 ``ScrubMismatch`` events naming the key, the
pinned version, and the replica addresses: the key-exact evidence
stream that divergence triage needs.

Refusals are NEVER mismatches.  Every storage fence the normal read
path has (too-old version, future version, a moved/relinquished range)
refuses the scrub request WHOLESALE via the GV_* status byte, and the
scrubber answers by re-reading the published state and re-pinning a
fresh version — so shard moves, recoveries and lagging replicas cost
retries, not false positives.

A frontier invariant watchdog rides the same role: it samples the live
metrics plane (tlogs first, then storages, then a GRV) and asserts the
version-order invariants that hold at matching sample points —
per-storage ``oldest ≤ durable ≤ applied``, the tlog popped floor at or
below the storage durable floor, ``known_committed ≤`` the GRV taken
after, GRV monotone round over round, and each resolver's version chain
monotone within an epoch.  Violations emit severity-40
``ScrubInvariantViolation`` events.  (``applied ≤ committed`` is
deliberately NOT asserted: storage applies tlog entries ahead of the
known-committed watermark by design and rolls back above the recovery
version on rejoin.)

Scrub reads are read-only, pacing rides the loop clock, and the role
draws nothing from the global sim RNG — same-seed sim traces are
bit-identical with the knob either way.
"""

from __future__ import annotations

import asyncio

from ..rpc.stubs import GrvProxyClient, ResolverClient, StorageClient, \
    TLogClient
from ..rpc.transport import NetworkAddress, Transport
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from .data import GV_FOUND, KeyRange, ScrubPageRequest, Version, key_after
from .shard_map import ShardMap

# wall cap on one scrub/watchdog RPC round: a replica on a killed
# machine must cost a bounded retry, not a wedged pass
_RPC_TIMEOUT = 5.0
# consecutive refusals before a chunk is skipped (progress guarantee
# under sustained moves/recoveries; skips are counted, never silent)
_MAX_CHUNK_RETRIES = 8


def _addr(a) -> NetworkAddress:
    return NetworkAddress(a[0], a[1])


class ConsistencyScrubber:
    """CC-side singleton: continuous replica audit + frontier watchdog.

    Same lifecycle contract as the DataDistributor: constructed on the
    leading ClusterHost once recovery publishes a state, ``start()``ed
    behind ``SCRUB_ENABLED``, stopped when leadership moves.  Reads the
    controller's ``last_state`` directly (the DD discipline) and builds
    its own role stubs per chunk so live moves re-route mid-pass."""

    def __init__(self, knobs: Knobs, transport: Transport, cc) -> None:
        self.knobs = knobs
        self.transport = transport
        self.cc = cc                 # ClusterController (state + publish)
        self._scrub_task: asyncio.Task | None = None
        self._watch_task: asyncio.Task | None = None
        # audit counters (cumulative since recruitment)
        self.pages_scrubbed = 0
        self.rows_scrubbed = 0
        self.mismatch_pages = 0
        self.mismatch_rows = 0
        self.refusals = 0
        self.ranges_skipped = 0
        self.passes_complete = 0
        self.last_pass_version: Version = 0
        self.last_pass_duration = 0.0
        self.last_pass_pages = 0
        # watchdog counters + cross-round frontier memory
        self.invariant_checks = 0
        self.invariant_violations = 0
        self._last_grv: Version | None = None
        self._res_versions: dict[tuple, Version] = {}
        self._res_epoch = -1
        # deterministic server-side audit spans (namespace 5 — GRV=1,
        # storage=2, DD=3, backup=4 are taken)
        from ..runtime import span as span_mod
        self.spans = span_mod.SpanSink("Scrubber")
        self._span_sampler = span_mod.ServerSampler(namespace=5)
        self._msource = None

    # --- metrics / status surface ---

    def metrics_source(self):
        """Registration in the hosting worker's MetricsRegistry (the
        flight recorder): audit progress over time, so a mismatch
        burst is visible in the record even after the scrub_stats
        publish that carried it is superseded."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("Scrub")
            s.gauge("PagesScrubbed", lambda: self.pages_scrubbed)
            s.gauge("RowsScrubbed", lambda: self.rows_scrubbed)
            s.gauge("MismatchRows", lambda: self.mismatch_rows)
            s.gauge("Refusals", lambda: self.refusals)
            s.gauge("RangesSkipped", lambda: self.ranges_skipped)
            s.gauge("PassesComplete", lambda: self.passes_complete)
            s.gauge("LastPassVersion", lambda: self.last_pass_version)
            s.gauge("InvariantChecks", lambda: self.invariant_checks)
            s.gauge("InvariantViolations",
                    lambda: self.invariant_violations)
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        """The ``scrub_stats`` publish (the dd_stats discipline): rides
        the CC state at every pass end; status serves it RPC-free."""
        dur = self.last_pass_duration
        return {"pages_scrubbed": self.pages_scrubbed,
                "rows_scrubbed": self.rows_scrubbed,
                "mismatch_pages": self.mismatch_pages,
                "mismatch_rows": self.mismatch_rows,
                "refusals": self.refusals,
                "ranges_skipped": self.ranges_skipped,
                "passes_complete": self.passes_complete,
                "last_pass_version": self.last_pass_version,
                "last_pass_duration_s": round(dur, 3),
                "last_pass_pages": self.last_pass_pages,
                "pages_per_sec": round(self.last_pass_pages / dur, 3)
                if dur > 0 else 0.0,
                "invariant_checks": self.invariant_checks,
                "invariant_violations": self.invariant_violations}

    # --- lifecycle (the DataDistributor shape) ---

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._scrub_task = loop.create_task(self._scrub_loop(),
                                            name="scrubber")
        self._watch_task = loop.create_task(self._watch_loop(),
                                            name="scrub-watchdog")

    async def stop(self) -> None:
        for t in (self._scrub_task, self._watch_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        self._scrub_task = None
        self._watch_task = None

    # --- the continuous pass loop ---

    async def _scrub_loop(self) -> None:
        while True:
            await asyncio.sleep(self.knobs.SCRUB_PASS_INTERVAL)
            try:
                await self._pass()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the audit plane
                # must not die quietly; next round retries from scratch
                TraceEvent("ScrubPassFailed", severity=30) \
                    .detail("Error", repr(e)[:200]).log()

    def _snapshot(self) -> dict | None:
        state = getattr(self.cc, "last_state", None)
        if not state or self.cc.recovery_state != "ACCEPTING_COMMITS":
            return None
        return state

    async def _pass(self) -> None:
        """One full keyspace walk.  The shard map is re-read every
        chunk, so a pass spans live moves and recoveries; a pass only
        ABORTS (to restart clean) when the cluster has no accepting
        state at all."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        pages0, rows0 = self.pages_scrubbed, self.rows_scrubbed
        cursor = b""
        retries = 0
        last_version: Version = 0
        while True:
            state = self._snapshot()
            if state is None:
                return                      # mid-recovery: restart later
            shard_map = ShardMap(state["shard_boundaries"],
                                 state["shard_teams"])
            if cursor >= shard_map.keyspace_end:
                break
            rng = shard_map.shard_range(shard_map.shard_index(cursor))
            chunk = await self._scrub_chunk(state, shard_map, rng, cursor)
            if chunk is None:               # refusal / unreachable replica
                retries += 1
                self.refusals += 1
                if retries >= _MAX_CHUNK_RETRIES:
                    self.ranges_skipped += 1
                    TraceEvent("ScrubRangeSkipped", severity=30) \
                        .detail("Begin", cursor.hex()) \
                        .detail("End", rng.end.hex()).log()
                    cursor = rng.end
                    retries = 0
                else:
                    await asyncio.sleep(0.25)
                continue
            retries = 0
            cursor, n_pages, n_rows, version = chunk
            last_version = max(last_version, version)
            # the budget knob: pacing rides the loop clock (virtual
            # under simulation), never the wall clock
            if n_pages and self.knobs.SCRUB_PAGES_PER_SEC > 0:
                await asyncio.sleep(n_pages /
                                    self.knobs.SCRUB_PAGES_PER_SEC)
        self.passes_complete += 1
        self.last_pass_version = last_version
        self.last_pass_duration = loop.time() - t0
        self.last_pass_pages = self.pages_scrubbed - pages0
        TraceEvent("ScrubPassComplete") \
            .detail("Pass", self.passes_complete) \
            .detail("Version", last_version) \
            .detail("Pages", self.last_pass_pages) \
            .detail("Rows", self.rows_scrubbed - rows0) \
            .detail("DurationS", round(self.last_pass_duration, 3)) \
            .detail("MismatchRows", self.mismatch_rows) \
            .detail("Refusals", self.refusals).log()
        await self._publish_stats()

    async def _publish_stats(self) -> None:
        def mutate(s: dict) -> dict:
            s["scrub_stats"] = self.stats()
            return s
        try:
            await self.cc.publish_state(mutate)
        except Exception:  # noqa: BLE001 — a publish racing a
            # leadership change loses nothing: the next pass republishes
            pass

    def _team_clients(self, state: dict, rng: KeyRange,
                      tags: list) -> list[StorageClient] | None:
        """Stubs for EVERY replica of the team owning ``rng`` — the
        whole point is auditing degraded replicas too, so this bypasses
        ReplicaGroup's degraded-last read ranking entirely.  None when
        a team member is missing from the published state or does not
        (yet) cover the range — the caller retries off fresh state."""
        by_tag = {s["tag"]: s for s in state["storage"]}
        out = []
        for tg in tags:
            s = by_tag.get(tg)
            if s is None or s["begin"] > rng.begin or s["end"] < rng.end:
                return None
            out.append(StorageClient(self.transport, _addr(s["addr"]),
                                     s["token"], s["tag"],
                                     KeyRange(s["begin"], s["end"])))
        return out

    async def _pin_version(self, state: dict) -> Version:
        g = state["grv_proxies"][0]
        c = GrvProxyClient(self.transport, _addr(g["addr"]), g["token"])
        return await c.get_read_version()

    async def _scrub_chunk(self, state: dict, shard_map: ShardMap,
                           rng: KeyRange, cursor: bytes):
        """Audit one chunk (≤ SCRUB_MAX_PAGES_PER_REQUEST pages) of the
        shard containing ``cursor``: pin a version, fan the identical
        digest request to every replica, compare page triples, triage
        any divergence to exact rows.  Returns (next_cursor, pages,
        rows, version), or None on any refusal/unreachable replica —
        the caller re-reads state and retries (never a mismatch)."""
        tags = shard_map.shard_tags[shard_map.shard_index(cursor)]
        clients = self._team_clients(state, rng, tags)
        if not clients:
            return None
        begin = max(cursor, rng.begin)
        try:
            version = await asyncio.wait_for(self._pin_version(state),
                                             _RPC_TIMEOUT)
            req = ScrubPageRequest(
                begin, rng.end, version,
                max(1, self.knobs.SCRUB_PAGE_ROWS),
                max(1, self.knobs.SCRUB_MAX_PAGES_PER_REQUEST))
            replies = await asyncio.wait_for(
                asyncio.gather(*(c.scrub_page(req) for c in clients)),
                _RPC_TIMEOUT)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — dead/locked replica: retry
            return None
        if any(r.status != GV_FOUND for r in replies):
            return None
        page_lists = [r.pages() for r in replies]
        n_pages = max(map(len, page_lists))
        if n_pages == 0:
            return rng.end, 0, 0, version
        mismatch_at = None
        clean_rows = 0
        for i in range(n_pages):
            triples = {p[i] if i < len(p) else None for p in page_lists}
            if len(triples) != 1:
                mismatch_at = i
                break
            clean_rows += page_lists[0][i][1]
        if mismatch_at is None:
            # every replica produced identical pages; resume after the
            # common last end key (conservative ``more`` costs at most
            # one empty chunk, the range-read contract)
            more = any(r.more for r in replies)
            n = len(page_lists[0])
            next_cursor = key_after(page_lists[0][-1][0]) if more \
                else rng.end
            self.pages_scrubbed += n
            self.rows_scrubbed += clean_rows
            return min(next_cursor, rng.end) if more else rng.end, \
                n, clean_rows, version
        # divergence: bisect from the last agreed boundary through the
        # end of every replica's coverage, then row-diff key-exactly
        t_begin = begin if mismatch_at == 0 else \
            key_after(page_lists[0][mismatch_at - 1][0])
        t_end = rng.end
        if all(r.more for r in replies):
            t_end = min(rng.end, max(key_after(p[-1][0])
                                     for p in page_lists if p))
        ok = await self._triage(clients, t_begin, t_end, version)
        if not ok:
            return None
        self.mismatch_pages += max(map(len, page_lists)) - mismatch_at
        self.pages_scrubbed += mismatch_at
        self.rows_scrubbed += clean_rows
        return t_end, mismatch_at, clean_rows, version

    async def _triage(self, clients: list[StorageClient], begin: bytes,
                      end: bytes, version: Version) -> bool:
        """Key-exact divergence triage: re-read [begin, end) from every
        replica through the packed range path at the SAME pinned
        version, diff the row sets, and emit one severity-40
        ScrubMismatch per divergent key (capped by
        SCRUB_MAX_REPORTED_ROWS; the total still counts).  False means
        a replica refused mid-triage — caller retries, no verdict."""
        from .data import GetRangeRequest
        rows_by_replica: list[dict[bytes, bytes]] = []
        for c in clients:
            rows: dict[bytes, bytes] = {}
            b = begin
            while True:
                try:
                    reply = await asyncio.wait_for(
                        c.get_key_values_packed(
                            GetRangeRequest(b, end, version, 0, False, 0)),
                        _RPC_TIMEOUT)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — retry off fresh state
                    return False
                if reply.status != GV_FOUND:
                    return False
                page = reply.rows()
                for k, v in page:
                    rows[bytes(k)] = bytes(v)
                if not reply.more or not page:
                    break
                b = key_after(bytes(page[-1][0]))
            rows_by_replica.append(rows)
        every_key = sorted(set().union(*rows_by_replica))
        reported = 0
        found = 0
        ctx = self._span_sampler.root(1.0)
        for k in every_key:
            vals = [r.get(k) for r in rows_by_replica]
            if len(set(vals)) == 1:
                continue
            found += 1
            self.mismatch_rows += 1
            if reported >= self.knobs.SCRUB_MAX_REPORTED_ROWS:
                continue
            reported += 1
            ev = TraceEvent("ScrubMismatch", severity=40) \
                .detail("Key", k.hex()) \
                .detail("Version", version) \
                .detail("Replicas", ",".join(
                    f"{c._address.ip}:{c._address.port}/tag{c.tag}"
                    for c in clients)) \
                .detail("Values", ",".join(
                    "<missing>" if v is None else v[:64].hex()
                    for v in vals))
            ev.log()
        if ctx is not None:
            self.spans.event("ScrubDebug", ctx, "Scrubber.triage.Done",
                             Begin=begin.hex(), End=end.hex(),
                             Divergent=found)
        if found == 0:
            # digests disagreed but rows matched on re-read: the window
            # moved under the digest pass (e.g. a racing rollback) —
            # count a refusal-equivalent, not a mismatch
            self.refusals += 1
        return True

    # --- frontier invariant watchdog ---

    async def _watch_loop(self) -> None:
        while True:
            await asyncio.sleep(self.knobs.SCRUB_WATCHDOG_INTERVAL)
            try:
                await self._watch_round()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                TraceEvent("ScrubWatchdogFailed", severity=30) \
                    .detail("Error", repr(e)[:200]).log()

    def _violation(self, invariant: str, **details) -> None:
        self.invariant_violations += 1
        ev = TraceEvent("ScrubInvariantViolation", severity=40) \
            .detail("Invariant", invariant)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    async def _watch_round(self) -> None:
        """One assertion round over the live frontiers.  Sampling order
        is load-bearing: tlogs FIRST (their popped/known-committed
        floors only rise), storages second, the GRV LAST — every
        inequality below compares an earlier watermark against a later
        or same-sample one, so timing skew can only widen the slack,
        never fake a violation."""
        state = self._snapshot()
        if state is None:
            return
        epoch = state["epoch"]
        tlog_metrics = []
        gen = state["log_cfg"][-1]
        for i, a in enumerate(gen["tlogs"]):
            try:
                c = TLogClient(self.transport, _addr(a), gen["token"][i])
                tlog_metrics.append(await asyncio.wait_for(
                    c.metrics(), _RPC_TIMEOUT))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a dying log is a
                continue       # recovery in progress, not a violation
        storage_metrics = []
        for s in state["storage"]:
            try:
                c = StorageClient(self.transport, _addr(s["addr"]),
                                  s["token"], s["tag"],
                                  KeyRange(s["begin"], s["end"]))
                storage_metrics.append(await asyncio.wait_for(
                    c.metrics(), _RPC_TIMEOUT))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                continue
        resolver_metrics = []
        for r in state["resolvers"]:
            try:
                c = ResolverClient(self.transport, _addr(r["addr"]),
                                   r["token"],
                                   KeyRange(r["begin"], r["end"]))
                m = await asyncio.wait_for(c.metrics(), _RPC_TIMEOUT)
                resolver_metrics.append(((tuple(r["addr"]), r["token"]), m))
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                continue
        try:
            grv_after = await asyncio.wait_for(self._pin_version(state),
                                               _RPC_TIMEOUT)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            grv_after = None

        # (1) per-storage same-sample ordering: oldest ≤ durable ≤
        # applied.  Memory-only servers never advance durable_version
        # (nothing to persist; the TLog is their durability), so their
        # durable frontier IS the applied version — same substitution
        # check (2) makes.
        for m in storage_metrics:
            self.invariant_checks += 1
            durable = (m["durable_version"] if m.get("durable_engine")
                       else m["version"])
            if not (m["oldest_version"] <= durable <= m["version"]):
                self._violation("storage_version_order", Tag=m["tag"],
                                Oldest=m["oldest_version"],
                                Durable=durable,
                                Applied=m["version"])
        # (2) popped-at-or-below-durable, floor form: min popped over
        # the log set ≤ popped(argmin-durable tag) ≤ its durability
        # floor.  Only settled storages vote — a mid-fetch recruit's
        # frontiers are still forming.
        settled = [m for m in storage_metrics if m.get("fetch_done")]
        if tlog_metrics and settled:
            self.invariant_checks += 1
            popped_floor = min(m["popped"] for m in tlog_metrics)
            durable_floor = min(
                (m["durable_version"] if m.get("durable_engine")
                 else m["version"]) for m in settled)
            # pop(tag, v) declares "everything < v durable" — popped is
            # an EXCLUSIVE bound, so durable_floor + 1 is its legal max
            if popped_floor > durable_floor + 1:
                self._violation("popped_above_durable",
                                PoppedFloor=popped_floor,
                                DurableFloor=durable_floor)
        # (3) tlog known-committed (sampled BEFORE) ≤ the GRV after
        if tlog_metrics and grv_after is not None:
            self.invariant_checks += 1
            kc = max(m["known_committed"] for m in tlog_metrics)
            if kc > grv_after:
                self._violation("known_committed_above_grv",
                                KnownCommitted=kc, Grv=grv_after)
        # (4) GRV monotone round over round (committed versions never
        # run backwards, across recoveries included)
        if grv_after is not None:
            if self._last_grv is not None:
                self.invariant_checks += 1
                if grv_after < self._last_grv:
                    self._violation("grv_regressed",
                                    Previous=self._last_grv,
                                    Current=grv_after)
            self._last_grv = grv_after
        # (5) per-resolver version chain monotone within an epoch (a
        # new epoch rebuilds resolvers; identity resets with it)
        if epoch != self._res_epoch:
            self._res_versions.clear()
            self._res_epoch = epoch
        for key, m in resolver_metrics:
            v = m.get("version")
            if v is None:
                continue
            prev = self._res_versions.get(key)
            if prev is not None:
                self.invariant_checks += 1
                if v < prev:
                    self._violation("resolver_version_regressed",
                                    Resolver=f"{key[0][0]}:{key[0][1]}",
                                    Previous=prev, Current=v)
            self._res_versions[key] = v
