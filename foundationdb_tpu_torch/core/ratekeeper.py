"""Ratekeeper — cluster-wide transaction admission control.

Reference: REF:fdbserver/Ratekeeper.actor.cpp — a singleton samples every
storage server's queue depths (bytes not yet durable, version lag) and
TLog queues, computes a cluster transaction-rate budget from the worst
offender, and GRV proxies spend that budget before handing out read
versions.  The effect: writers slow down *before* storage falls over.

The smoothing/PID subtleties of the reference are reduced to the core
proportional controller: full rate while queues are under target, then
linear falloff to a floor as the worst queue approaches its limit.

v2 adds the reference's two admission refinements:

- **Per-tag throttling** (REF:fdbserver/TagThrottler.actor.cpp): GRV
  demand is tracked per transaction tag (EWMA).  When the cluster is
  limited AND one tag dominates demand (share ≥ TAG_THROTTLE_DEMAND_
  SHARE), that tag alone is clamped to the computed budget through its
  own token bucket and the global rate stays open — a hot tenant slows
  down, cold tenants don't feel it.
- **Priority lanes** (REF: GRV batch priority): ``immediate`` skips
  admission entirely (system work), ``default`` spends the main budget,
  ``batch`` spends only what default demand leaves over — background
  work yields under pressure instead of competing.
"""

from __future__ import annotations

import asyncio

from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent

_EWMA = 0.3     # demand smoothing per update interval


class Ratekeeper:
    def __init__(self, knobs: Knobs, storage_servers, tlogs) -> None:
        self.knobs = knobs
        self.storage_servers = storage_servers
        self.tlogs = tlogs
        self.rate_tps: float = knobs.RATEKEEPER_MAX_TPS
        self.batch_rate_tps: float = knobs.RATEKEEPER_MAX_TPS
        self.tag_rates: dict[str, float] = {}     # throttled tags only
        # operator-set clamps (REF: TagThrottleApi manual throttles):
        # merged over the auto-detected set every update, never aged out
        self.manual_tag_rates: dict[str, float] = {}
        self._tokens: float = knobs.RATEKEEPER_MAX_TPS
        self._batch_tokens: float = 0.0
        self._tag_tokens: dict[str, tuple[float, float]] = {}  # tag->(tok,ts)
        self._admit_lock: asyncio.Lock | None = None
        self._batch_lock: asyncio.Lock | None = None
        self._last_refill: float | None = None
        self._batch_refill: float | None = None
        self._task: asyncio.Task | None = None
        self.limiting_reason = "unlimited"
        # demand accounting since the last recompute (+ smoothed)
        self._demand_window: dict[str, int] = {}
        self._default_window = 0
        self._tag_demand: dict[str, float] = {}
        self._default_demand = 0.0
        # shard-heat admission: tags clamped because one
        # shard's write rate alone would wedge its storage queue,
        # armed BEFORE the global falloff engages
        self.heat_tag_rates: dict[str, float] = {}
        self.heat_throttle_activations = 0
        self._heat_armed: set[str] = set()
        self._last_heat_budgets: dict[str, float] = {}   # blind-tick hold
        self.hot_shards: list[dict] = []      # per-shard heat rank (status)
        self._msource = None

    async def metrics(self) -> dict:
        """Admission picture for status pollers that speak the uniform
        metrics surface (get_throttle remains the richer legacy RPC)."""
        return {
            "tps_limit": self.rate_tps,
            "batch_tps_limit": self.batch_rate_tps,
            "throttled_tags": len(self.tag_rates),
            "heat_throttle_activations": self.heat_throttle_activations,
            "reason": self.limiting_reason,
        }

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry: the
        admission budget over time — a falling TPSLimit
        series with its LimitingReason IS the incident narrative the
        point-in-time status poll could never show."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("Ratekeeper")
            s.gauge("TPSLimit", lambda: round(self.rate_tps, 1))
            s.gauge("BatchTPSLimit", lambda: round(self.batch_rate_tps, 1))
            s.gauge("ThrottledTags", lambda: len(self.tag_rates))
            s.gauge("HeatThrottleActivations",
                    lambda: self.heat_throttle_activations)
            s.gauge("LimitingReason", lambda: self.limiting_reason)
            self._msource = s
        return self._msource

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._update_loop(), name="ratekeeper")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # --- rate computation (REF: updateRate) ---

    async def _update_loop(self) -> None:
        while True:
            await asyncio.sleep(self.knobs.RATEKEEPER_UPDATE_INTERVAL)
            await self._recompute()

    @staticmethod
    async def _sample_storage(ss) -> dict:
        """Metrics via RPC-able metrics() when present (recruited stubs),
        direct attributes otherwise (in-process objects and test fakes)."""
        m = getattr(ss, "metrics", None)
        if m is not None:
            return await m()
        return {"tag": ss.tag, "durable_engine": ss.engine is not None,
                "queue_bytes": ss.bytes_input - ss.bytes_durable,
                "version": ss.version, "durable_version": ss.durable_version}

    @staticmethod
    async def _sample_tlog(tl) -> dict:
        m = getattr(tl, "metrics", None)
        if m is not None:
            return await m()
        return {"queue_bytes": tl.queue.bytes_used if tl.queue is not None else 0}

    async def _recompute(self) -> None:
        k = self.knobs
        worst = 0.0
        reason = "unlimited"
        samples = await asyncio.gather(
            *(self._sample_storage(ss) for ss in self.storage_servers),
            *(self._sample_tlog(tl) for tl in self.tlogs),
            return_exceptions=True)
        n_ss = len(self.storage_servers)
        # shard heat rides the SAME metrics sweep (zero extra RPCs —
        # the reservoir payload only DD needs stays on shard_metrics);
        # servers that don't report heat scalars (bare test fakes, old
        # peers) simply don't contribute
        heat: list[dict] = []
        if k.RATEKEEPER_HEAT_THROTTLE:
            heat = [m for m in samples[:n_ss]
                    if not isinstance(m, BaseException)
                    and "shard_writes_per_sec" in m]
            # rank per SHARD for status: replicas merge on the shard
            # bounds (reads SUM — the client spreads them; writes MAX —
            # every replica applies the full stream), or one hot
            # shard's replicas would fill every top-k slot
            by_shard: dict = {}
            for m in heat:
                e = by_shard.setdefault(
                    (m.get("shard_begin"), m.get("shard_end")),
                    {"tags": [], "reads_per_sec": 0.0,
                     "writes_per_sec": 0.0})
                e["tags"].append(m["tag"])
                e["reads_per_sec"] = round(
                    e["reads_per_sec"] + m.get("shard_reads_per_sec", 0.0),
                    3)
                e["writes_per_sec"] = max(e["writes_per_sec"],
                                          m["shard_writes_per_sec"])
            for e in by_shard.values():
                e["rw_per_sec"] = round(
                    e["reads_per_sec"] + e["writes_per_sec"], 3)
            self.hot_shards = sorted(by_shard.values(),
                                     key=lambda e: -e["rw_per_sec"])[:3]
        for m in samples[:n_ss]:
            if isinstance(m, BaseException):
                continue       # unreachable replica: the CC handles failure
            if not m["durable_engine"]:
                continue       # memory-only: applied == effectively durable
            frac = m["queue_bytes"] / k.TARGET_STORAGE_QUEUE_BYTES
            if frac > worst:
                worst, reason = frac, f"storage_queue_tag_{m['tag']}"
            lag = m["version"] - m["durable_version"]
            lag_frac = lag / max(1, k.TARGET_DURABILITY_LAG_VERSIONS)
            if lag_frac > worst:
                worst, reason = lag_frac, f"durability_lag_tag_{m['tag']}"
        for i, m in enumerate(samples[n_ss:]):
            if isinstance(m, BaseException):
                continue
            frac = m["queue_bytes"] / k.TARGET_TLOG_QUEUE_BYTES
            if frac > worst:
                worst, reason = frac, f"tlog_queue_{i}"

        # fold this window's demand into the smoothed per-tag/default
        # view; tags ABSENT from the window decay toward zero — a tag
        # that went idle must not keep its old hot score and hijack a
        # later, unrelated overload
        for tag in set(self._tag_demand) | set(self._demand_window):
            prev = self._tag_demand.get(tag, 0.0)
            cur = self._demand_window.get(tag, 0)
            nxt = prev + _EWMA * (cur - prev)
            if nxt < 0.5 and tag not in self._demand_window:
                self._tag_demand.pop(tag, None)
            else:
                self._tag_demand[tag] = nxt
        self._default_demand += _EWMA * (self._default_window
                                         - self._default_demand)
        self._demand_window = {}
        self._default_window = 0

        if worst <= 0.5:
            rate = k.RATEKEEPER_MAX_TPS
            self.tag_rates = {}
        else:
            # linear falloff: 1.0 at 50% of target, floor at 100%
            scale = max(0.0, min(1.0, 2.0 * (1.0 - worst)))
            rate = max(k.RATEKEEPER_MIN_TPS, k.RATEKEEPER_MAX_TPS * scale)
            # tag attribution: when a single tag's smoothed demand share
            # dominates, clamp that TAG to the budget and leave the
            # global rate open — cold tags must not pay for a hot tenant
            total = self._default_demand
            hot = {t: d for t, d in self._tag_demand.items()
                   if total > 0
                   and d / total >= k.TAG_THROTTLE_DEMAND_SHARE}
            if hot:
                self.tag_rates = {t: rate for t in hot}
                reason = "tag_throttle_" + "_".join(sorted(hot))
                rate = k.RATEKEEPER_MAX_TPS
                TraceEvent("RkTagThrottled").detail("Tags", sorted(hot)) \
                    .detail("TagTPSLimit", round(min(
                        self.tag_rates.values()), 1)).log()
            else:
                self.tag_rates = {}
                TraceEvent("RkRateLimited").detail("Reason", reason) \
                    .detail("TPSLimit", round(rate, 1)).log()
        # --- heat-armed tag throttling: when ONE shard's
        # write-byte rate alone would fill the storage queue target
        # within RATEKEEPER_HEAT_WEDGE_S, clamp the dominant demand tag
        # BEFORE the global falloff engages — the hot tenant sheds at
        # GRV while the cluster-wide rate (and every cold tag) stays
        # open.  Arms only with a dominant tag: untagged workloads see
        # no behavior change.
        self.heat_tag_rates = {}
        armed_now: set[str] = set()
        if not heat and k.RATEKEEPER_HEAT_THROTTLE and self._heat_armed:
            # blind tick (every heat-bearing sample failed — recovery,
            # reboot, partition): HOLD the armed clamp instead of
            # releasing a one-interval burst mid-overload and
            # double-counting the activation on the next tick
            for t in self._heat_armed:
                if t not in self.tag_rates:
                    self.tag_rates[t] = self._last_heat_budgets.get(
                        t, k.RATEKEEPER_MIN_TPS)
                    self.heat_tag_rates[t] = self.tag_rates[t]
            armed_now = set(self._heat_armed)
        if heat:
            hot = max(heat, key=lambda h: h["shard_writes_per_sec"])
            wedge_bytes = hot.get("shard_write_bytes_per_sec", 0.0) \
                * k.RATEKEEPER_HEAT_WEDGE_S
            # disarm hysteresis: once armed, the clamp holds until the
            # rates fall below HALF the arm thresholds — without it a
            # clamped tag's decaying write rate oscillates around the
            # threshold and every disarm releases a burst that re-arms
            # it one tick later (arm/release thrash, the admission
            # analog of the DD streak hysteresis)
            hys = 0.5 if self._heat_armed else 1.0
            if (hot["shard_writes_per_sec"]
                    >= hys * k.RATEKEEPER_HOT_SHARD_WRITES_PER_SEC
                    and wedge_bytes >= hys * k.TARGET_STORAGE_QUEUE_BYTES):
                total = self._default_demand
                dominant = [t for t, d in self._tag_demand.items()
                            if total > 0
                            and d / total >= k.TAG_THROTTLE_DEMAND_SHARE]
                for t in dominant:
                    # a tag the queue-depth falloff already clamped still
                    # counts as ARMED: hysteresis and the activation
                    # counter must not reset just because the clamp
                    # migrated between mechanisms for a tick
                    armed_now.add(t)
                    if t in self.tag_rates:
                        budget = self.tag_rates[t]
                    else:
                        # budget: scale the tag's own demand rate down by
                        # the factor that stops the wedge (floor-guarded)
                        demand_tps = self._tag_demand[t] \
                            / max(k.RATEKEEPER_UPDATE_INTERVAL, 1e-6)
                        factor = k.TARGET_STORAGE_QUEUE_BYTES \
                            / max(wedge_bytes, 1e-9)
                        budget = max(k.RATEKEEPER_MIN_TPS,
                                     demand_tps * factor)
                        self.tag_rates[t] = budget
                        self.heat_tag_rates[t] = budget
                    if t not in self._heat_armed:
                        self.heat_throttle_activations += 1
                        TraceEvent("RkHeatTagThrottled") \
                            .detail("Tag", t) \
                            .detail("TagTPSLimit", round(budget, 1)) \
                            .detail("ShardTag", hot["tag"]) \
                            .detail("WritesPerSec", round(
                                hot["shard_writes_per_sec"], 1)) \
                            .detail("WriteBytesPerSec", round(
                                hot.get("shard_write_bytes_per_sec", 0.0),
                                1)) \
                            .log()
                if dominant and rate >= k.RATEKEEPER_MAX_TPS \
                        and self.heat_tag_rates:
                    reason = "heat_tag_throttle_" + "_".join(
                        sorted(self.heat_tag_rates))
        self._heat_armed = armed_now
        if self.heat_tag_rates:
            self._last_heat_budgets = dict(self.heat_tag_rates)
        if self.manual_tag_rates:
            self.tag_rates = {**self.tag_rates, **self.manual_tag_rates}
        self.rate_tps = rate
        # batch lane: background work gets what default demand leaves
        self.batch_rate_tps = max(
            k.RATEKEEPER_MIN_TPS, self.rate_tps - self._default_demand
            / max(k.RATEKEEPER_UPDATE_INTERVAL, 1e-6))
        # buckets of tags whose throttle lifted are garbage
        self._tag_tokens = {t: v for t, v in self._tag_tokens.items()
                            if t in self.tag_rates}
        self.limiting_reason = reason \
            if (rate < k.RATEKEEPER_MAX_TPS or self.tag_rates) \
            else "unlimited"

    async def set_tag_throttle(self, tag: str, rate: float | None) -> bool:
        """Manual tag clamp (REF: TagThrottleApi): rate in txns/s, None
        lifts it.  Takes effect immediately and survives auto updates."""
        if rate is None:
            self.manual_tag_rates.pop(tag, None)
            self.tag_rates.pop(tag, None)
        else:
            self.manual_tag_rates[tag] = float(rate)
            self.tag_rates[tag] = float(rate)
        return True

    async def get_rate(self) -> float:
        """Current budget (RPC surface for status/monitoring)."""
        return self.rate_tps

    async def get_throttle(self) -> dict:
        """Full admission picture for status json."""
        return {"tps_limit": self.rate_tps,
                "batch_tps_limit": self.batch_rate_tps,
                "throttled_tags": dict(self.tag_rates),
                "heat_throttled_tags": dict(self.heat_tag_rates),
                "heat_throttle_activations": self.heat_throttle_activations,
                "hot_shards": [dict(h) for h in self.hot_shards],
                "reason": self.limiting_reason}

    # --- admission (spent by GRV proxies) ---

    async def admit(self, n_txns: int, priority: str = "default",
                    tags: dict[str, int] | None = None) -> None:
        """Block until the lane's (and any throttled tags') token buckets
        cover n_txns.  ``priority``: "immediate" skips admission (system
        work must not deadlock behind the throttle it recovers),
        "default" spends the main budget, "batch" spends the leftover
        budget.  ``tags`` maps transaction tags to their txn counts
        within this batch; counts for currently-throttled tags drain the
        tag's own bucket FIRST, so a hot tag queues behind its clamp
        while untagged/cold work sails through the open global bucket.

        Admission is in installments: a batch larger than one second's
        rate budget drains whatever tokens exist and sleeps for the
        remainder, rather than waiting for the bucket (capped at the
        rate) to cover the whole batch at once — which would never
        happen for n_txns > rate and wedge every GRV proxy behind it.

        The lock makes admission FIFO across GRV proxies sharing this
        Ratekeeper: without it, a stream of small batches could drain
        every refill before a sleeping large batch wakes, starving it
        forever.  Tokens consumed by a batch that is cancelled
        mid-admission are refunded (main lane, where it matters).
        """
        if priority == "immediate" or n_txns <= 0:
            return
        if priority == "default":
            self._default_window += n_txns
            for tag, cnt in (tags or {}).items():
                self._demand_window[tag] = \
                    self._demand_window.get(tag, 0) + cnt
        if self._admit_lock is None:
            self._admit_lock = asyncio.Lock()
            self._batch_lock = asyncio.Lock()
        # throttled-tag drains run OUTSIDE the lane locks: a clamped hot
        # tag sleeping on its own bucket must not hold up cold work
        # queued on the main lane (each bucket's read-update step is
        # atomic between awaits, so interleaved drains stay correct —
        # at the cost of strict FIFO within one throttled tag)
        for tag, cnt in (tags or {}).items():
            await self._drain_tag(tag, cnt)
        if priority == "batch":
            async with self._batch_lock:
                await self._drain_batch(float(n_txns))
        else:
            async with self._admit_lock:
                await self._drain_main(float(n_txns))

    async def _drain_main(self, remaining: float) -> None:
        loop = asyncio.get_running_loop()
        n = remaining
        try:
            while True:
                now = loop.time()
                if self._last_refill is None:
                    self._last_refill = now
                cap = max(self.rate_tps, 1.0)
                self._tokens = min(
                    cap,
                    self._tokens + (now - self._last_refill) * self.rate_tps)
                self._last_refill = now
                take = min(self._tokens, remaining)
                self._tokens -= take
                remaining -= take
                if remaining <= 1e-9:
                    return
                # Sleep only long enough to earn one bucket-cap of tokens
                # — sleeping for the full remainder would let the cap clip
                # most of the refill and stretch admission quadratically.
                await asyncio.sleep(min(cap, remaining) / cap)
        except asyncio.CancelledError:
            self._tokens += n - remaining
            raise

    async def _drain_batch(self, remaining: float) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = loop.time()
            if self._batch_refill is None:
                self._batch_refill = now
            rate = max(self.batch_rate_tps, 1.0)
            self._batch_tokens = min(
                rate,
                self._batch_tokens + (now - self._batch_refill) * rate)
            self._batch_refill = now
            take = min(self._batch_tokens, remaining)
            self._batch_tokens -= take
            remaining -= take
            if remaining <= 1e-9:
                return
            await asyncio.sleep(min(rate, remaining) / rate)

    async def _drain_tag(self, tag: str, remaining: float) -> None:
        loop = asyncio.get_running_loop()
        while True:
            rate = self.tag_rates.get(tag)
            if rate is None:
                return          # (no longer) throttled: free
            rate = max(rate, 1.0)
            now = loop.time()
            tok, last = self._tag_tokens.get(tag, (rate, now))
            tok = min(rate, tok + (now - last) * rate)
            take = min(tok, remaining)
            self._tag_tokens[tag] = (tok - take, now)
            remaining -= take
            if remaining <= 1e-9:
                return
            await asyncio.sleep(min(rate, remaining) / rate)
