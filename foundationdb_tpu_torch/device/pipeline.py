"""The device commit pipeline — persistent on-device resolver state with
pipelined dispatch (SURVEY §7 hard part 3).

The resolver's conflict history lives on the card for the whole resolver
generation (``TorchConflictSet`` holds the lane-major ring as device
tensors), so a dispatch updates it on the device and the state NEVER
round-trips to the host.  This pipeline is a host-side queue in front of
the device that

- **enqueues** proxy batches as they arrive (strict version order —
  submission order is queue order, kept by the single FIFO pump task);
- **fuses** queued batches into one group dispatch per pump turn;
- **pipelines** a bounded number of dispatches: with depth 2, group
  N+1's encode+transfer runs on the host while group N's kernels run on
  the card and group N-1's verdicts read back on the sync worker thread
  — one CUDA stream serializes the device side, so chained states keep
  strict order for free;
- **compacts** the ring across batches: the MAX_WRITE_TRANSACTION_LIFE
  ``oldest_version`` floor advances between dispatches with the same
  one-group lag the serial path used (a floor update is itself a tiny
  device op on the same stream, so ordering is preserved);
- **drains or discards** at shutdown: ``close()`` awaits in-flight
  verdicts (benches and smokes drain; the production lifecycle —
  ``Resolver.stop()`` on role teardown — passes ``discard=True`` so
  queued batches fail with ResolverFailed instead of resolving against
  a ring the next generation won't trust, matching the reference's
  kill-the-role recovery discipline).

Verdict parity: the pipeline reorders NOTHING — batches reach
``resolve_group_begin`` in enqueue order and the fused group threads the
ring through the group per batch (per-batch too-old floors, see
ops/conflict_torch.resolve_many_core), so verdicts are bit-identical to
a chained serial resolve and to the deterministic CPU twin
(ops/conflict_np.py).

The pipeline works over ANY encoded backend: the numpy twin syncs
inline (and under SimEventLoop no thread is ever used — the sim
determinism gate), the torch backend takes the device path.  The exact
cpp baseline resolves host-side per batch and gains nothing from
queueing; the resolver keeps it on the direct path.
"""

from __future__ import annotations

import asyncio

from ..ops.backends import resolve_group_begin
from ..runtime.errors import ResolverFailed
from ..runtime.knobs import Knobs
from ..runtime.latency_probe import StageStats
from ..runtime.span import SpanSink


class _Item:
    __slots__ = ("txns", "version", "fut", "ctx", "barrier")

    def __init__(self, txns, version, fut, ctx, barrier):
        self.txns = txns
        self.version = version
        self.fut = fut
        self.ctx = ctx
        self.barrier = barrier


class GroupSizeStats:
    """Group-fusion depth as a real role metric: a MetricsRegistry ``Histogram`` replaces the ad-hoc capped list, so
    the distribution shows up in cluster.lag / ``metrics_tool summary``
    like every other role series.  The trace Histogram clears itself on
    every log interval, so the running count/total/max (which the
    FusedGroupMean gauge and the benches read) live here, outside it.
    A bounded sample buffer keeps the old list-ish read surface
    (iteration in benches and tests) alive."""

    _SAMPLE_CAP = 65536

    __slots__ = ("hist", "count", "total", "max", "samples")

    def __init__(self) -> None:
        from ..runtime.trace import Histogram
        self.hist = Histogram("ResolverDevice", "GroupSize", unit="batches")
        self.count = 0
        self.total = 0
        self.max = 0
        self.samples: list[int] = []

    def append(self, n: int) -> None:
        self.hist.sample(n)
        self.count += 1
        self.total += n
        if n > self.max:
            self.max = n
        if len(self.samples) < self._SAMPLE_CAP:
            self.samples.append(n)

    def clear(self) -> None:
        self.hist.clear()
        self.count = 0
        self.total = 0
        self.max = 0
        self.samples.clear()

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(self.samples)


def supports_pipeline(backend) -> bool:
    """True when ``backend`` can ride the pipeline (encoded backends with
    a group-submit path).  The cpp interval map resolves host-side per
    batch — queueing it adds latency for nothing — so it reports False
    and the resolver keeps the direct dispatch (graceful fallback)."""
    return hasattr(backend, "resolve_group_begin")


class DevicePipeline:
    """Host-side front of the device resolver: enqueue → fuse → dispatch
    → readback, a bounded number of dispatches in flight."""

    def __init__(self, backend, knobs: Knobs, on_poison=None,
                 epoch_begin_version: int = 0) -> None:
        assert supports_pipeline(backend)
        self.backend = backend
        self.knobs = knobs
        self.depth = max(1, knobs.RESOLVER_PIPELINE_DEPTH)
        self.group_max = max(1, knobs.RESOLVER_GROUP_MAX)
        self._window = knobs.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        self._on_poison = on_poison
        self._pending: list[_Item] = []
        self._pump_task: asyncio.Task | None = None
        self._inflight: list[asyncio.Task] = []
        self._last_version = epoch_begin_version
        self._poisoned: BaseException | None = None
        self._closed = False
        # --- observability (rolled up as cluster.resolver_device) ---
        self.spans = SpanSink("ResolverDevice")
        self.stages = StageStats("DevicePipeline", cap=4096)
        self.enqueued = 0          # batches accepted
        self.dispatches = 0        # fused device dispatches issued
        self.batches_dispatched = 0
        self.readbacks = 0         # dispatches whose verdicts synced back
        self.queue_peak = 0
        self.inflight_peak = 0
        self.group_sizes = GroupSizeStats()
        self._dispatch_s = 0.0     # host time in encode+transfer+dispatch
        self._overlap_s = 0.0      # ...of which with >= 1 dispatch in flight

    # --- submission ---

    def submit(self, txns, version: int, span_ctx=None,
               barrier: bool = False) -> asyncio.Future:
        """Enqueue one proxy batch; returns a future of its verdict list.
        ``barrier`` (state-txn batches) ends the fused group at this
        batch, so its verdicts never wait on later batches' kernels.
        The caller owns version ordering (the resolver's version chain
        gates submission); the pipeline preserves enqueue order."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if self._poisoned is not None or self._closed:
            fut.set_exception(ResolverFailed())
            return fut
        self._pending.append(_Item(txns, version, fut, span_ctx, barrier))
        self.enqueued += 1
        self.queue_peak = max(self.queue_peak, len(self._pending))
        self.spans.event("CommitDebug", span_ctx,
                         "ResolverDevice.enqueue",
                         Version=version, QueueDepth=len(self._pending))
        if self._pump_task is None or self._pump_task.done():
            from ..runtime.span import no_span
            # the pump outlives this request: mask its span so later
            # groups aren't attributed to this transaction
            with no_span():
                self._pump_task = loop.create_task(
                    self._pump(), name="resolver-device-pipeline")
        return fut

    async def resolve(self, txns, version: int) -> list[int]:
        """Submit one batch and await its verdicts (the serial
        convenience used by parity checks and latency probes)."""
        return await self.submit(txns, version)

    # --- the pump: one task, FIFO, bounded in-flight dispatches ---

    def _reap(self) -> None:
        """Drop completed readback tasks: _inflight must mean device work
        genuinely outstanding — the depth gate, the overlap accounting,
        and the metrics all key on it, and a done task lingering from an
        earlier burst would count a dispatch as overlapped against a
        kernel that already finished."""
        if any(t.done() for t in self._inflight):
            self._inflight = [t for t in self._inflight if not t.done()]

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        group: list[_Item] = []
        try:
            while self._pending:
                self._reap()
                while len(self._inflight) >= self.depth:
                    await asyncio.wait({self._inflight[0]})
                    self._reap()
                if self._poisoned is not None or not self._pending:
                    # a readback that failed while we were parked at the
                    # depth gate poisoned the pipeline and drained the
                    # queue — nothing left to dispatch
                    break
                group = []
                while self._pending and len(group) < self.group_max:
                    item = self._pending.pop(0)
                    group.append(item)
                    if item.barrier:
                        break
                # ring compaction: slide the too-old floor as of the
                # PREVIOUS dispatch (one-group lag, exactly the serial
                # path's discipline) — a device-side op on the same
                # stream, so it lands between kernels in order
                floor = self._last_version - self._window
                if floor > 0:
                    self.backend.set_oldest_version(floor)
                self._last_version = group[-1].version
                t0 = loop.time()
                overlapped = bool(self._inflight)
                finish = resolve_group_begin(
                    self.backend, [it.txns for it in group],
                    [it.version for it in group])
                dt = loop.time() - t0
                self.stages.record("dispatch", dt)
                self._dispatch_s += dt
                if overlapped:
                    self._overlap_s += dt
                self.dispatches += 1
                self.batches_dispatched += len(group)
                self.group_sizes.append(len(group))
                self.spans.event("CommitDebug", group[0].ctx,
                                 "ResolverDevice.dispatch",
                                 Version=group[-1].version,
                                 Batches=len(group),
                                 InFlight=len(self._inflight) + 1,
                                 Overlapped=overlapped)
                task = loop.create_task(self._readback(group, finish),
                                        name="resolver-device-readback")
                self._inflight.append(task)
                self.inflight_peak = max(self.inflight_peak,
                                         len(self._inflight))
                group = []
        except asyncio.CancelledError:
            for it in group:
                if not it.fut.done():
                    it.fut.set_exception(ResolverFailed())
            raise
        except BaseException as e:  # noqa: BLE001 — submission failure
            self._poison(e)
            for it in group:        # popped but not dispatched
                if not it.fut.done():
                    it.fut.set_exception(ResolverFailed())
            raise

    async def _readback(self, group: list[_Item], finish) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            rows = await finish
        except asyncio.CancelledError:
            for it in group:
                if not it.fut.done():
                    it.fut.set_exception(ResolverFailed())
            raise
        except BaseException as e:  # noqa: BLE001 — sync failure
            self._poison(e)
            for it in group:
                if not it.fut.done():
                    it.fut.set_exception(ResolverFailed())
            return
        self.stages.record("readback", loop.time() - t0)
        self.readbacks += 1
        self.spans.event("CommitDebug", group[0].ctx,
                         "ResolverDevice.readback",
                         Version=group[-1].version, Batches=len(group))
        for it, verdicts in zip(group, rows):
            if not it.fut.done():
                it.fut.set_result(verdicts)

    # --- lifecycle ---

    @property
    def poisoned(self) -> BaseException | None:
        return self._poisoned

    def _poison(self, e: BaseException) -> None:
        """Fail-stop: device history may be partially mutated (some group
        dispatched, some not) — no later verdict can be trusted.  Queued
        batches fail immediately instead of hanging; the owner (the
        resolver role) is told so it poisons its version chain too."""
        if self._poisoned is not None:
            return
        self._poisoned = e
        pending, self._pending = self._pending, []
        for it in pending:
            if not it.fut.done():
                it.fut.set_exception(ResolverFailed())
        if self._on_poison is not None:
            self._on_poison(e)

    async def drain(self) -> None:
        """Wait until every enqueued batch has verdicts (or failed)."""
        while self._pending or self._inflight \
                or (self._pump_task is not None
                    and not self._pump_task.done()):
            tasks = set(self._inflight)
            if self._pump_task is not None and not self._pump_task.done():
                tasks.add(self._pump_task)
            if not tasks:
                break
            try:
                await asyncio.wait(tasks)
            except asyncio.CancelledError:
                raise
            self._inflight = [t for t in self._inflight if not t.done()]

    async def close(self, discard: bool = False) -> None:
        """Generation end: drain in-flight work then stop accepting.
        ``discard`` skips the drain (rollback path — recovery replaces
        the role, so queued batches fail with ResolverFailed instead of
        being resolved against a ring the next generation won't trust)."""
        self._closed = True
        if discard:
            self._poison(ResolverFailed())
            for t in list(self._inflight):
                t.cancel()
        else:
            try:
                await self.drain()
            except asyncio.CancelledError:
                pass
        for t in [self._pump_task, *self._inflight]:
            if t is not None and not t.done():
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, ResolverFailed):
                    pass
                except BaseException:  # noqa: BLE001 — already poisoned
                    pass
        self._inflight = []
        self._pump_task = None

    # --- observability ---

    def reset_stats(self) -> None:
        """Zero the dispatch/overlap accounting (NOT the queue state):
        benches call this at measuring start so warmup compile stalls —
        which land inside the first dispatches' host time — don't skew
        the steady-state per-batch numbers."""
        self.stages = StageStats("DevicePipeline", cap=4096)
        self.enqueued = 0
        self.dispatches = 0
        self.batches_dispatched = 0
        self.readbacks = 0
        self._reap()
        self.queue_peak = len(self._pending)
        self.inflight_peak = len(self._inflight)
        self.group_sizes.clear()
        self._dispatch_s = 0.0
        self._overlap_s = 0.0
        if hasattr(self.backend, "readback_bytes"):
            self.backend.readback_bytes = 0
            self.backend.readback_txns = 0

    def metrics(self) -> dict:
        """Counters for the resolver's metrics() → cluster.resolver_device
        rollup: queue/in-flight depth, dispatch shape, and where dispatch
        host time went (overlap ratio ~1.0 = encode+transfer fully hidden
        behind in-flight kernels; ~0.0 = serial)."""
        self._reap()
        s = self.stages.summary()
        disp = s.get("dispatch", {})
        sync = s.get("readback", {})
        n = max(1, self.batches_dispatched)
        return {
            "device_pipeline": 1,
            "device_pipeline_depth": self.depth,
            "device_enqueued": self.enqueued,
            "device_dispatches": self.dispatches,
            "device_batches_dispatched": self.batches_dispatched,
            "device_readbacks": self.readbacks,
            "device_queue_depth": len(self._pending),
            "device_queue_peak": self.queue_peak,
            "device_inflight": len(self._inflight),
            "device_inflight_peak": self.inflight_peak,
            "device_group_mean": round(
                self.batches_dispatched / max(1, self.dispatches), 2),
            "device_group_max": self.group_sizes.max,
            # verdict readback volume: what the host actually
            # synced — the bitmask reduction's bytes/txn win reads here
            "device_readback_bytes": getattr(self.backend,
                                             "readback_bytes", 0),
            "device_readback_txns": getattr(self.backend,
                                            "readback_txns", 0),
            "device_dispatch_us_per_batch": round(
                self._dispatch_s / n * 1e6, 1),
            "device_dispatch_p99_ms": disp.get("p99_ms", 0.0),
            "device_readback_p99_ms": sync.get("p99_ms", 0.0),
            "device_overlap_ratio": round(
                self._overlap_s / self._dispatch_s, 3)
            if self._dispatch_s > 0 else 0.0,
            "device_poisoned": int(self._poisoned is not None),
            # namespaced: the resolver spreads this dict into ITS
            # metrics(), whose own SpanSink publishes the bare
            # spans_emitted/dropped keys — colliding would clobber the
            # role's span accounting in the cluster.tracing rollup
            **{"device_" + k: v for k, v in self.spans.counters().items()},
        }
