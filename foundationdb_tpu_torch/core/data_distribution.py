"""DataDistribution v2 — shard statistics, LIVE splits and moves.

Reference: REF:fdbserver/DataDistribution.actor.cpp (tracker/queue) +
REF:fdbserver/MoveKeys.actor.cpp (the relocation protocol).  The
distributor runs beside the elected cluster controller and relocates
shards WITHOUT a recovery, with the same three-phase protocol as the
reference:

1. **startMove** — a state transaction rewrites ``\\xff/keyServers/
   layout`` so the moving range's WRITE team is src+dest (dual tagging)
   and journals the move.  Every commit proxy applies the mutation at its
   exact commit version Vs (the ApplyMetadataMutation path), so all
   mutations > Vs reach both teams.  Reads keep routing to src: clients
   only see published cluster state, which does not change yet.
2. **fetch + catch-up** — destination storage servers are recruited with
   ``fetch_version = Vs``: they stream the range's snapshot AT Vs from a
   source replica while pulling their new tag from Vs+1 — an exact cut,
   because the startMove transaction is alone in its version.
3. **finishMove (flip)** — once destinations are caught up, another
   state transaction sets the write team to dest-only; the committing
   proxy emits PRIVATE_DROP_SHARD markers to the source tags at the flip
   version Vf, so sources refuse reads above Vf (wrong_shard_server →
   clients refresh).  The controller then publishes the updated cluster
   state (same epoch, seq+1) and a final transaction clears the journal.

A crash at any point is safe: recovery normalizes the layout journal —
moves still in phase 1–2 roll BACK to src (src holds everything, writes
were dual-tagged); flipped moves roll FORWARD (the journal carries the
destination server info so they rejoin).  See
``system_data.normalize_layout``.
"""

from __future__ import annotations

import asyncio

from ..rpc.stubs import StorageClient, TLogClient
from ..rpc.transport import NetworkAddress, Transport
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from .data import MAX_VERSION, KeyRange, Version
from .shard_map import ShardMap
from .system_data import LAYOUT_KEY, normalize_layout


def layout_of(state: dict) -> dict:
    return {"boundaries": [bytes(b) for b in state["shard_boundaries"]],
            "teams": [list(t) for t in state["shard_teams"]]}


def split_layout(layout: dict, shard_idx: int, split_key: bytes,
                 next_tag: int) -> tuple[dict, int]:
    """Split shard ``shard_idx`` at ``split_key``: left half keeps its
    team, right half gets ``len(team)`` fresh tags."""
    boundaries = list(layout["boundaries"])
    teams = [list(t) for t in layout["teams"]]
    team = teams[shard_idx]
    new_team = [next_tag + i for i in range(len(team))]
    boundaries.insert(shard_idx, split_key)
    teams.insert(shard_idx + 1, new_team)
    return ({"boundaries": boundaries, "teams": teams},
            next_tag + len(team))


def move_layout(layout: dict, shard_idx: int, next_tag: int) -> tuple[dict, int]:
    """Reassign shard ``shard_idx`` to an entirely fresh team (the manual
    ``move`` / excluded-server relocation case)."""
    teams = [list(t) for t in layout["teams"]]
    n = len(teams[shard_idx])
    teams[shard_idx] = [next_tag + i for i in range(n)]
    return ({"boundaries": list(layout["boundaries"]), "teams": teams},
            next_tag + n)


class MoveAborted(Exception):
    pass


class DataDistributor:
    """Runs with the elected controller; watches shard sizes and performs
    live relocations through the layout state-transaction path."""

    def __init__(self, knobs: Knobs, transport: Transport, cc,
                 database) -> None:
        self.knobs = knobs
        self.transport = transport
        self.cc = cc                 # ClusterController (workers + publish)
        self.db = database           # Database-like with .run + .view
        self._task: asyncio.Task | None = None
        self.splits_done = 0
        self.live_moves_done = 0
        self._worker_rr = 0
        # operator/workload-requested relocations (RandomMoveKeys): shard
        # indices to move onto fresh teams, drained one per round
        self._move_requests: list[int] = []
        # relocation spans: DD never runs inside a
        # sampled transaction, so each relocation roots its own
        # deterministic server-side span — trace_tool then shows a slow
        # move as one DataDistributor.relocate span bracketing the
        # destinations' fetchKeys spans
        from ..runtime import span as span_mod
        self.spans = span_mod.SpanSink("DataDistributor")
        self._span_sampler = span_mod.ServerSampler(namespace=3)
        # heat-driven relocation state: consecutive-hot-round
        # streaks per shard range (hysteresis), a post-relocation
        # cooldown deadline, and the counters the dd_stats publish
        # carries into status
        self._heat_streak: dict[tuple[bytes, bytes], int] = {}
        self._heat_cooldown_until = 0.0
        self.heat_splits_done = 0
        self.heat_moves_done = 0
        self.last_heat_rw_per_sec = 0.0
        # resolver-mesh boundary rebalance state: sustain
        # streak + cooldown mirror the shard-heat hysteresis; the counter
        # counts desired-boundary writes (applied at the NEXT epoch)
        self._res_streak = 0
        self._res_cooldown_until = 0.0
        self.resolver_rebalances = 0
        # gray-failure avoidance: destination picks that
        # skipped a disk-degraded worker
        self.degraded_avoided = 0
        self._msource = None

    def metrics_source(self):
        """DD's registration in the hosting worker's MetricsRegistry
       : relocation counters over time — a split/move burst
        is visible in the flight record even after the dd_stats publish
        that carried it is superseded."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("DataDistribution")
            s.gauge("Splits", lambda: self.splits_done)
            s.gauge("LiveMoves", lambda: self.live_moves_done)
            s.gauge("HeatSplits", lambda: self.heat_splits_done)
            s.gauge("HeatMoves", lambda: self.heat_moves_done)
            s.gauge("ResolverRebalances", lambda: self.resolver_rebalances)
            s.gauge("DegradedAvoided", lambda: self.degraded_avoided)
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        """Relocation counters (published with every flip; see
        cluster.hot_moves in status)."""
        return {"splits": self.splits_done,
                "live_moves": self.live_moves_done,
                "heat_splits": self.heat_splits_done,
                "heat_moves": self.heat_moves_done,
                "resolver_rebalances": self.resolver_rebalances,
                "last_heat_rw_per_sec": self.last_heat_rw_per_sec,
                "degraded_avoided": self.degraded_avoided}

    def request_relocation(self, shard_idx: int) -> None:
        """Queue a manual live move of shard ``shard_idx`` onto a fresh
        team (REF:fdbserver/workloads/RandomMoveKeys.actor.cpp drives
        moveKeys directly; here the request rides DD's own relocation
        machinery so journaling/rollback behave identically)."""
        self._move_requests.append(shard_idx)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._loop(), name="data-distributor")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.knobs.DD_INTERVAL)
            try:
                await self._round()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — DD must not die quietly
                TraceEvent("DDRoundFailed", severity=30) \
                    .detail("Error", repr(e)[:200]).log()

    # --- one relocation decision per round ---

    async def _round(self) -> None:
        state = getattr(self.cc, "last_state", None)
        if not state or self.cc.recovery_state != "ACCEPTING_COMMITS":
            return
        layout = await self._current_layout(state)
        if layout is None:
            return
        if layout.get("moves"):
            # Leftover journal from an interrupted move.  "in" entries
            # were rolled back (by recovery's normalization, or never
            # flipped); "flip" entries may have flipped WITHOUT the state
            # publish reaching the coordinators — re-publish from the
            # journal's dest_info first, or the destinations (holding
            # every post-flip write) would be orphaned.  Then write the
            # normalized layout so the durable blob matches.
            for mv in layout["moves"]:
                if mv.get("state") == "flip":
                    await self._publish_flip(mv, layout["boundaries"],
                                             layout["teams"])
            await self._commit_layout(normalize_layout(layout))
            TraceEvent("DDJournalReconciled").log()
            return
        by_tag = {s["tag"]: s for s in state["storage"]}
        shard_map = ShardMap([bytes(b) for b in layout["boundaries"]],
                             [list(t) for t in layout["teams"]])
        next_tag = max(by_tag, default=-1) + 1

        # --- engine migration: `configure storage_engine=X` makes every
        # shard whose replicas run a different engine relocate onto
        # freshly-recruited X-engine servers, one shard per round
        # (REF:fdbclient/ManagementAPI.actor.cpp changeStorageType →
        # DD gradually replaces wrong-store-type servers) ---
        # --- manual relocation requests first (RandomMoveKeys) ---
        while self._move_requests:
            idx = self._move_requests.pop(0)
            if 0 <= idx < len(layout["teams"]):
                await self._relocate(state, layout, idx, next_tag,
                                     split_key=None, engine=None)
                return
        desired = await self._desired_engine()
        if desired is not None:
            for idx, (rng, team) in enumerate(shard_map.ranges()):
                if any(by_tag[t].get("engine",
                                     self.knobs.STORAGE_ENGINE) != desired
                       for t in team if t in by_tag):
                    await self._relocate(state, layout, idx, next_tag,
                                         split_key=None, engine=desired)
                    return
            # all shards already on the desired engine: splits below must
            # also recruit on it or each split's suffix would live-move a
            # second time at the next mismatch scan

        for idx, (rng, team) in enumerate(shard_map.ranges()):
            sizes = []
            for tag in team:
                s = by_tag.get(tag)
                if s is None:
                    continue
                stub = self._storage_stub(s)
                try:
                    m = await asyncio.wait_for(
                        stub.metrics(), timeout=self.knobs.FAILURE_TIMEOUT)
                    sizes.append((m.get("logical_bytes", 0), s))
                except Exception:   # noqa: BLE001 — dead replica: skip
                    continue
            if not sizes:
                continue
            size, src = max(sizes, key=lambda x: x[0])
            if size < self.knobs.DD_SHARD_SPLIT_BYTES:
                continue
            split_key = await self._storage_stub(src).sample_split_key(
                rng.begin, rng.end)
            if not split_key:
                continue
            # the ranking snapshot can race a concurrent split (another
            # DD incarnation, or a relocation that landed between the
            # metrics read and here): RE-FETCH the winner's size before
            # committing, so a just-split shard's stale logical_bytes
            # cannot trigger an immediate re-split of the shrunk remnant
            try:
                m2 = await asyncio.wait_for(
                    self._storage_stub(src).metrics(),
                    timeout=self.knobs.FAILURE_TIMEOUT)
            except Exception:   # noqa: BLE001 — replica died: next round
                continue
            if m2.get("logical_bytes", 0) < self.knobs.DD_SHARD_SPLIT_BYTES:
                continue
            await self._relocate(state, layout, idx, next_tag,
                                 split_key=bytes(split_key), engine=desired)
            return                  # one relocation per round

        # --- heat policy: split/move shards by LOAD, not just
        # size.  Runs only when no size-driven relocation fired, behind
        # its own knob so the deterministic same-seed sims replay the
        # pre-heat behavior with the knob off. ---
        if self.knobs.DD_SHARD_HEAT_SPLITS:
            await self._heat_round(state, layout, shard_map, by_tag,
                                   next_tag, desired)

        # --- resolver-mesh boundary rebalance: roll the same
        # shard-heat reservoirs up into the RESOLVER partitions and write
        # a desired boundary list for the next epoch's recruitment ---
        if self.knobs.RESOLVER_REBALANCE \
                and self.knobs.RESOLVER_MESH_ROUTING:
            await self._resolver_rebalance_round(state, shard_map, by_tag)

    # --- heat-driven relocation ---

    async def _shard_heat(self, team: list[int], by_tag: dict) -> dict | None:
        """One shard's merged heat sample: reads SUM over the team (the
        client spreads them), writes/write-bytes MAX (every replica
        applies the full stream), reservoirs concatenated so the split
        midpoint sees every replica's sampled keys."""
        async def one(s: dict) -> dict | None:
            try:
                return await asyncio.wait_for(
                    self._storage_stub(s).shard_metrics(),
                    timeout=self.knobs.FAILURE_TIMEOUT)
            except Exception:   # noqa: BLE001 — dead replica: skip
                return None
        samples = [m for m in await asyncio.gather(
            *(one(by_tag[t]) for t in team if t in by_tag)) if m is not None]
        if not samples:
            return None
        # aggregate duplicate keys across replica reservoirs by MEAN
        # (every replica applies the full write stream, so a key both
        # replicas sampled would otherwise count twice — which would
        # both defeat weighted_split_key's single-key move-guard and
        # skew the midpoint toward doubly-sampled keys)
        merged: dict[bytes, list[float]] = {}
        for m in samples:
            for k, w in m.get("samples") or []:
                merged.setdefault(bytes(k), []).append(float(w))
        reads = sum(m["reads_per_sec"] for m in samples)
        writes = max(m["writes_per_sec"] for m in samples)
        return {"reads_per_sec": reads, "writes_per_sec": writes,
                "rw_per_sec": reads + writes,
                "samples": sorted((k, sum(ws) / len(ws))
                                  for k, ws in merged.items())}

    async def _heat_round(self, state: dict, layout: dict, shard_map,
                          by_tag: dict, next_tag: int,
                          engine: str | None) -> None:
        """At most one heat-driven relocation per round: the hottest
        shard sustaining DD_SHARD_HOT_RW_PER_SEC for
        DD_HEAT_SUSTAIN_ROUNDS consecutive rounds (hysteresis) splits at
        the reservoir's heat midpoint; when the heat straddles a single
        key it falls back to the byte-midpoint sample and, failing that,
        MOVES whole to a fresh team on other machines.  A cooldown after
        every heat relocation keeps oscillating load from thrashing
        fetchKeys."""
        now = asyncio.get_running_loop().time()
        if now < self._heat_cooldown_until:
            return
        k = self.knobs
        hottest: tuple[float, int, KeyRange, dict] | None = None
        live_keys: set[tuple[bytes, bytes]] = set()
        ranges = shard_map.ranges()
        # one concurrent sweep, not O(shards x replicas) serialized
        # round-trips — a serialized sweep on a wide cluster would
        # outlast DD_INTERVAL and stall the sustain-streak clock
        heats = await asyncio.gather(
            *(self._shard_heat(team, by_tag) for _rng, team in ranges))
        for idx, ((rng, team), h) in enumerate(zip(ranges, heats)):
            key = (rng.begin, rng.end)
            # the shard EXISTS, so its streak survives the prune below
            # even when this round's sample failed (a one-round RPC
            # timeout must not reset a 15-round sustain streak and
            # delay the needed split by another full sustain window)
            live_keys.add(key)
            if h is None:
                continue
            if h["rw_per_sec"] >= k.DD_SHARD_HOT_RW_PER_SEC:
                self._heat_streak[key] = self._heat_streak.get(key, 0) + 1
            else:
                self._heat_streak.pop(key, None)
            if self._heat_streak.get(key, 0) >= k.DD_HEAT_SUSTAIN_ROUNDS \
                    and (hottest is None or h["rw_per_sec"] > hottest[0]):
                hottest = (h["rw_per_sec"], idx, rng, h)
        # streaks of shards that no longer exist (post-split boundaries)
        self._heat_streak = {key: n for key, n in self._heat_streak.items()
                             if key in live_keys}
        if hottest is None:
            return
        rw, idx, rng, h = hottest
        self.last_heat_rw_per_sec = round(rw, 1)
        from .shard_load import weighted_split_key
        split = weighted_split_key(h["samples"], rng.begin, rng.end)
        src_entry = None
        if split is None:
            # heat concentrated on one key (or reservoir too thin): try
            # the byte midpoint so at least the COLD half escapes
            for tag in ranges[idx][1]:
                if tag in by_tag:
                    src_entry = by_tag[tag]
                    break
            if src_entry is not None:
                try:
                    split = await asyncio.wait_for(
                        self._storage_stub(src_entry).sample_split_key(
                            rng.begin, rng.end),
                        timeout=k.FAILURE_TIMEOUT)
                except Exception:   # noqa: BLE001 — move instead
                    split = None
        ev = "DDHotSplit" if split else "DDHotMove"
        TraceEvent(ev).detail("Begin", rng.begin).detail("End", rng.end) \
            .detail("TriggerRwPerSec", round(rw, 1)) \
            .detail("ReadsPerSec", round(h["reads_per_sec"], 1)) \
            .detail("WritesPerSec", round(h["writes_per_sec"], 1)) \
            .detail("SplitKey", bytes(split) if split else None) \
            .detail("Streak", self._heat_streak.get((rng.begin, rng.end))) \
            .log()
        before = self.live_moves_done
        await self._relocate(state, layout, idx, next_tag,
                             split_key=bytes(split) if split else None,
                             engine=engine,
                             heat="split" if split else "move")
        if self.live_moves_done > before:
            self._heat_cooldown_until = \
                asyncio.get_running_loop().time() + k.DD_HEAT_COOLDOWN_S
            # boundaries changed: every streak is stale
            self._heat_streak.clear()

    # --- resolver-mesh boundary rebalance ---

    async def _resolver_rebalance_round(self, state: dict, shard_map,
                                        by_tag: dict) -> None:
        """Detect a resolver partition carrying a disproportionate share
        of the routed load and write the remapped boundary list to
        ``\\xff/keyServers/resolverBoundaries`` — an ordinary state-txn
        system write.  The remap takes effect at the NEXT epoch
        boundary: recruitment reads the key and recruits the resolvers
        on the new ranges, each partition's conflict window rebuilding
        from the tlogs exactly as any recovery rebuilds it.  Same
        hysteresis shape as the shard-heat policy: a sustain streak
        plus a post-write cooldown."""
        k = self.knobs
        res = state.get("resolvers") or []
        if len(res) < 2:
            return
        now = asyncio.get_running_loop().time()
        if now < self._res_cooldown_until:
            return
        heats = await asyncio.gather(
            *(self._shard_heat(team, by_tag)
              for _rng, team in shard_map.ranges()))
        samples: list[tuple[bytes, float]] = []
        for h in heats:
            if h is not None:
                samples.extend(h["samples"])
        bounds = sorted(bytes(r["begin"]) for r in res if bytes(r["begin"]))
        from .shard_load import rebalance_resolver_boundaries
        new = rebalance_resolver_boundaries(
            samples, bounds, ratio=k.RESOLVER_REBALANCE_RATIO)
        if new is None:
            self._res_streak = 0
            return
        self._res_streak += 1
        if self._res_streak < k.RESOLVER_REBALANCE_SUSTAIN_ROUNDS:
            return
        from ..rpc.wire import encode
        from .system_data import RESOLVER_BOUNDARIES_KEY
        tr = self.db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                tr.set(RESOLVER_BOUNDARIES_KEY, encode(new))
                await tr.commit()
                break
            except Exception as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)
        TraceEvent("DDResolverRebalance") \
            .detail("OldBoundaries", bounds) \
            .detail("NewBoundaries", new).log()
        self.resolver_rebalances += 1
        self._res_streak = 0
        self._res_cooldown_until = now + k.DD_HEAT_COOLDOWN_S

    async def _desired_engine(self) -> str | None:
        from .system_data import conf_key
        try:
            raw = await self.db.get(conf_key("storage_engine"))
        except Exception:  # noqa: BLE001 — unreadable conf: skip this round
            return None
        if not raw:
            return None
        from ..storage import ENGINE_NAMES
        name = bytes(raw).decode(errors="replace")
        return name if name in ENGINE_NAMES else None

    async def _current_layout(self, state: dict) -> dict | None:
        from ..rpc.wire import decode
        try:
            raw = await self.db.get(LAYOUT_KEY)
        except Exception:  # noqa: BLE001 — unreadable metadata: skip round
            return None
        if raw:
            try:
                return decode(raw)
            except Exception:  # noqa: BLE001 — corrupt blob: fall through
                pass
        return layout_of(state)

    # --- the live relocation protocol ---

    async def _relocate(self, state: dict, layout: dict, idx: int,
                        next_tag: int, split_key: bytes | None = None,
                        engine: str | None = None,
                        heat: str | None = None) -> None:
        """Span wrapper around the relocation protocol: paired
        Before/After (or .Error) events plus the activated context, so
        the destinations' fetchKeys and the move's state transactions
        group into one timeline in the trace file."""
        from ..runtime import span as span_mod
        ctx = self._span_sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        before = self.live_moves_done
        self.spans.event("TransactionDebug", ctx,
                         "DataDistributor.relocate.Before",
                         Shard=idx, SplitKey=split_key, Heat=heat)
        try:
            with span_mod.child_scope(ctx):
                await self._relocate_inner(state, layout, idx, next_tag,
                                           split_key, engine, heat)
        except BaseException as e:
            self.spans.event("TransactionDebug", ctx,
                             "DataDistributor.relocate.Error",
                             Shard=idx, Error=type(e).__name__)
            raise
        self.spans.event("TransactionDebug", ctx,
                         "DataDistributor.relocate.After",
                         Shard=idx, Moved=self.live_moves_done > before)

    async def _relocate_inner(self, state: dict, layout: dict, idx: int,
                              next_tag: int, split_key: bytes | None = None,
                              engine: str | None = None,
                              heat: str | None = None) -> None:
        """Live-relocate shard ``idx``: with ``split_key`` the suffix
        [split_key, end) moves to a fresh team (a split); without, the
        WHOLE shard moves (manual move / engine migration).  ``engine``
        recruits the destinations on a specific IKeyValueStore type;
        ``heat`` ("split" | "move") attributes the relocation to the
        heat policy in the published dd_stats."""
        rng = ShardMap([bytes(b) for b in layout["boundaries"]],
                       [list(t) for t in layout["teams"]]).shard_range(idx)
        if split_key is not None and not rng.begin < split_key < rng.end:
            return
        src_team = list(layout["teams"][idx])
        dest_tags = [next_tag + i for i in range(len(src_team))]
        epoch0 = self.cc.epoch
        move_rng = (KeyRange(split_key, rng.end) if split_key is not None
                    else rng)
        # the index of the (possibly split-off) moving shard in the new
        # layout: a split inserts a boundary so the suffix is idx+1
        midx = idx + 1 if split_key is not None else idx

        # --- phase 1: startMove (dual-tagged write team) ---
        if split_key is not None:
            start_layout = {
                "boundaries": [*layout["boundaries"][:idx], split_key,
                               *layout["boundaries"][idx:]],
                "teams": [*(list(t) for t in layout["teams"][:idx]),
                          src_team, src_team + dest_tags,
                          *(list(t) for t in layout["teams"][idx + 1:])],
            }
        else:
            start_layout = {
                "boundaries": list(layout["boundaries"]),
                "teams": [list(t) for t in layout["teams"]],
            }
            start_layout["teams"][midx] = src_team + dest_tags
        start_layout["moves"] = [{"begin": move_rng.begin,
                                  "end": move_rng.end, "src": src_team,
                                  "dest": dest_tags, "state": "in"}]
        vs = await self._commit_layout(start_layout)
        TraceEvent("DDMoveStarted").detail("Begin", move_rng.begin) \
            .detail("End", move_rng.end).detail("Vs", vs) \
            .detail("DestTags", dest_tags).detail("Engine", engine).log()

        dest_info: list[dict] = []
        try:
            # --- phase 2: recruit destinations, fetch at Vs ---
            src_entry = self._live_src_entry(state, move_rng)
            wire_log_cfg = [self.cc._wire_gen(g) for g in state["log_cfg"]]
            chosen: set[str] = {src_entry["worker"][0]}
            src_by_tag = {s["tag"]: s for s in state["storage"]}
            for i_t, tag in enumerate(dest_tags):
                # region-preserving placement: each dest replaces
                # src_team[i_t] positionally, so a region-spanning team
                # keeps one replica per region across splits/migrations
                src_dc = (src_by_tag.get(src_team[i_t]) or {}).get("dcid")
                wa = self._pick_worker(avoid=chosen, dcid=src_dc)
                chosen.add(wa.ip)
                a, t = await self.cc._recruit(wa, "storage", {
                    "tag": tag, "shard_begin": move_rng.begin,
                    "shard_end": move_rng.end, "v0": vs,
                    "log_cfg": wire_log_cfg, "engine": engine,
                    "fetch_from": {"addr": src_entry["addr"],
                                   "token": src_entry["token"],
                                   "tag": src_entry["tag"],
                                   "begin": src_entry["begin"],
                                   "end": src_entry["end"]},
                    "fetch_version": vs})
                entry = {"worker": [wa.ip, wa.port], "addr": a,
                         "token": t, "tag": tag,
                         "engine": engine or self.knobs.STORAGE_ENGINE,
                         "begin": move_rng.begin, "end": move_rng.end}
                if src_dc is not None:
                    entry["dcid"] = src_dc
                dest_info.append(entry)
            await self._wait_caught_up(dest_info, vs, epoch0)
        except asyncio.CancelledError:
            # the distributor is being stopped (CC deposed / shutdown):
            # do NOT try to run the abort protocol against a cluster that
            # may already be dying — the "in" journal entry makes the
            # rollback safe at the next recovery or DD round
            raise
        except Exception as e:
            await self._abort_move(start_layout, midx, src_team, dest_info,
                                   epoch0)
            TraceEvent("DDMoveAborted", severity=30) \
                .detail("Error", repr(e)[:200]).log()
            return

        # --- phase 3: flip to dest + journal the dest info ---
        flip_layout = {
            "boundaries": list(start_layout["boundaries"]),
            "teams": [list(t) for t in start_layout["teams"]],
            "moves": [{"begin": move_rng.begin, "end": move_rng.end,
                       "src": src_team, "dest": dest_tags, "state": "flip",
                       "dest_info": dest_info}],
        }
        flip_layout["teams"][midx] = list(dest_tags)
        vf = await self._commit_layout(flip_layout)

        # the flip is durable: count the relocation BEFORE the publish so
        # the dd_stats riding the publish already include it
        if split_key is not None:
            self.splits_done += 1
        self.live_moves_done += 1
        if heat == "split":
            self.heat_splits_done += 1
        elif heat == "move":
            self.heat_moves_done += 1

        # --- publish so clients re-route reads, then clear the journal.
        # If anything here fails, the flip journal entry survives and the
        # next round's reconciliation re-publishes from it. ---
        await self._publish_flip(flip_layout["moves"][0],
                                 flip_layout["boundaries"],
                                 flip_layout["teams"])
        await self._commit_layout({
            "boundaries": list(flip_layout["boundaries"]),
            "teams": [list(t) for t in flip_layout["teams"]]})
        TraceEvent("DDMoveComplete").detail("Begin", move_rng.begin) \
            .detail("End", move_rng.end).detail("Vf", vf).log()
        await self._retire_emptied_sources(state, src_team, move_rng)

    async def _retire_emptied_sources(self, state: dict, src_team: list[int],
                                      rng: KeyRange) -> None:
        """After a WHOLE-shard move the source replicas serve nothing:
        their state entries were narrowed to empty by the flip publish.
        Stop the roles (destroy=True — the relinquished data must not be
        reported resident after a reboot) and pop their tags at infinity
        so they never pin a TLog queue.  Best-effort: a failure leaves an
        idle fenced replica behind, never a correctness problem
        (REF:fdbserver/DataDistribution.actor.cpp removeStorageServer)."""
        live = {s["tag"] for s in (self.cc.last_state or state)["storage"]}
        gone = []
        for s in state["storage"]:
            if s["tag"] in src_team and s["tag"] not in live \
                    and s["begin"] <= rng.begin and s["end"] >= rng.end:
                gone.append(s)
        for s in gone:
            try:
                wa = NetworkAddress(*s["worker"])
                w = self.cc.workers.get(wa)
                if w is not None:
                    await asyncio.wait_for(
                        w.stop_role(s["token"], True),
                        timeout=self.knobs.FAILURE_TIMEOUT)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                pass
        if gone:
            self._pop_tags_forever([s["tag"] for s in gone])
            self.cc.active_tags -= {s["tag"] for s in gone}

    async def _publish_flip(self, mv: dict, boundaries, teams) -> None:
        """Publish a flipped move's cluster state: the layout's boundaries
        and (dest) teams, source entries narrowed out of the moved range,
        and the journal's dest_info entries added.  Idempotent — re-run
        by journal reconciliation when a crash interrupted the original
        publish."""
        dest_info = [dict(d) for d in mv.get("dest_info", [])]
        src_team = list(mv["src"])
        b, e = bytes(mv["begin"]), bytes(mv["end"])
        dest_tags = {d["tag"] for d in dest_info}

        def mutate(s: dict) -> dict:
            s = dict(s)
            s["shard_boundaries"] = [bytes(x) for x in boundaries]
            s["shard_teams"] = [list(t) for t in teams]
            # relocation counters ride the published state so status can
            # roll them up (cluster.hot_moves) without a DD RPC surface;
            # counts cover THIS distributor's lifetime
            s["dd_stats"] = self.stats()
            storage = []
            for entry in s["storage"]:
                if entry["tag"] in dest_tags:
                    continue                 # re-added fresh below
                if entry["tag"] in src_team and entry["begin"] <= b \
                        and entry["end"] >= e:
                    entry = dict(entry)
                    if entry["begin"] == b:  # whole-entry move
                        entry["begin"] = entry["end"] = e
                    else:                    # suffix move (split)
                        entry["end"] = b
                storage.append(entry)
            s["storage"] = [x for x in storage
                            if x["begin"] < x["end"]] + dest_info
            return s
        await self.cc.publish_state(mutate)
        self.cc.active_tags.update(dest_tags)

    async def _wait_caught_up(self, dest_info: list[dict], vs: Version,
                              epoch0: int) -> None:
        deadline = asyncio.get_running_loop().time() + \
            self.knobs.DD_MOVE_TIMEOUT
        while True:
            if self.cc.epoch != epoch0 \
                    or self.cc.recovery_state != "ACCEPTING_COMMITS":
                raise MoveAborted("epoch changed mid-move")
            if asyncio.get_running_loop().time() > deadline:
                raise MoveAborted("destination catch-up timeout")
            ok = True
            for d in dest_info:
                m = await asyncio.wait_for(
                    self._storage_stub(d).metrics(),
                    timeout=self.knobs.FAILURE_TIMEOUT)
                if m.get("fetch_failed"):
                    raise MoveAborted("destination fetch failed (too old)")
                if not m.get("fetch_done") or m.get("version", 0) < vs:
                    ok = False
            if ok:
                return
            await asyncio.sleep(self.knobs.DD_INTERVAL / 4)

    async def _abort_move(self, start_layout: dict, midx: int,
                          src_team: list[int], dest_info: list[dict],
                          epoch0: int) -> None:
        """Roll a failed move back: write team reverts to src (the abort
        layout's team diff sends drop markers to the destinations), the
        destination roles stop, and their tags pop at infinity so they
        never pin a TLog queue.  ``midx`` is the moving shard's index in
        the start layout (suffix shard for a split, the shard itself for
        a whole-shard move)."""
        if self.cc.epoch != epoch0:
            return      # a recovery already normalized the journal
        abort_layout = {
            "boundaries": list(start_layout["boundaries"]),
            "teams": [list(t) for t in start_layout["teams"]]}
        abort_layout["teams"][midx] = list(src_team)
        try:
            # bounded: if the abort can't commit (pipeline already dead),
            # give up — the journal entry rolls the move back at recovery
            await asyncio.wait_for(self._commit_layout(abort_layout),
                                   timeout=self.knobs.DD_MOVE_TIMEOUT)
        except (Exception, asyncio.TimeoutError):  # noqa: BLE001
            return
        for d in dest_info:
            try:
                wa = NetworkAddress(*d["worker"])
                w = self.cc.workers.get(wa)
                if w is not None:
                    # destroy: an aborted destination's partial fetch must
                    # not be reported resident after a reboot
                    await asyncio.wait_for(
                        w.stop_role(d["token"], True),
                        timeout=self.knobs.FAILURE_TIMEOUT)
            except Exception:  # noqa: BLE001 — dead worker: nothing to stop
                pass
        self._pop_tags_forever([d["tag"] for d in dest_info])

    def _pop_tags_forever(self, tags: list[int]) -> None:
        state = self.cc.last_state or {}
        gen = (state.get("log_cfg") or [{}])[-1]
        targets = list(zip(gen.get("tlogs", []), gen.get("token", []))) + \
            list(zip(gen.get("satellites", []), gen.get("sat_token", [])))
        for (ip, port), tok in targets:
            stub = TLogClient(self.transport, NetworkAddress(ip, port), tok)
            for tag in tags:
                try:
                    stub.pop(tag, MAX_VERSION)
                except Exception:  # noqa: BLE001 — oneway best-effort
                    pass

    # --- helpers ---

    def _live_src_entry(self, state: dict, rng: KeyRange) -> dict:
        for s in state["storage"]:
            if s["begin"] <= rng.begin and s["end"] >= rng.end \
                    and self.cc.fm.is_available(NetworkAddress(*s["worker"])):
                return s
        raise MoveAborted("no live source replica for move range")

    def _pick_worker(self, avoid: set[str] | None = None,
                     dcid: str | None = None) -> NetworkAddress:
        """Round-robin over live workers, preferring machines not in
        ``avoid`` (the source and already-chosen team members) so one
        machine death cannot take out a whole replication team.  Falls
        back to any live worker when the fleet is too small to avoid.
        With ``dcid`` the pool is restricted to that datacenter — a
        region-spanning team must never silently lose its remote
        replica to a region-blind pick, so an empty DC aborts the move
        (the journal rolls it back) instead of degrading."""
        live = [a for a, _ in self.cc._live_workers()]
        if dcid is not None:
            live = [a for a in live
                    if (self.cc.locality.get(a) or {}).get("dcid") == dcid]
            if not live:
                raise MoveAborted(f"no live workers in dc {dcid}")
        # gray-failure avoidance: never pick a machine whose
        # disk the health poll marked degraded as a MOVE DESTINATION
        # while a healthy alternative exists — fetchKeys onto a stalling
        # disk drags the move AND the shard's post-move tail latency.
        # Falls back to the full pool when everything is degraded.
        healthy = [a for a in live if not self.cc.fm.is_degraded(a)]
        if healthy and len(healthy) < len(live):
            self.degraded_avoided += 1
            TraceEvent("DDAvoidDegraded") \
                .detail("Degraded",
                        [str(a) for a in live if a not in healthy]) \
                .detail("Healthy", len(healthy)).log()
            live = healthy
        preferred = [a for a in live if not avoid or a.ip not in avoid]
        pool = preferred or live
        if not pool:
            raise MoveAborted("no live workers for destination")
        self._worker_rr += 1
        return pool[self._worker_rr % len(pool)]

    def _storage_stub(self, s: dict) -> StorageClient:
        return StorageClient(self.transport, NetworkAddress(*s["addr"]),
                             s["token"], s["tag"],
                             KeyRange(bytes(s["begin"]), bytes(s["end"])))

    async def _commit_layout(self, layout: dict) -> Version:
        from ..rpc.wire import encode
        tr = self.db.create_transaction()
        # layout maintenance continues under a database lock (the
        # reference's MoveKeys transactions are lock-aware)
        tr.lock_aware = True
        while True:
            try:
                tr.set(LAYOUT_KEY, encode(layout))
                return await tr.commit()
            except Exception as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)
