"""The GRV proxy role — batched GetReadVersion with rate admission.

Reference: REF:fdbserver/GrvProxyServer.actor.cpp — read-version requests
are batched over a small window, the Ratekeeper-issued transaction budget
is spent here (admission control), and one liveness round-trip to the
sequencer serves the whole batch the newest committed version.
"""

from __future__ import annotations

import asyncio

from ..runtime.knobs import Knobs
from ..runtime.span import ServerSampler, SpanSink, current_span, no_span
from .data import Version
from .sequencer import Sequencer


class GrvProxy:
    def __init__(self, knobs: Knobs, sequencer: Sequencer,
                 ratekeeper=None) -> None:
        self.knobs = knobs
        self.sequencer = sequencer
        self.ratekeeper = ratekeeper
        # (future, lock_aware, priority, tag, span_ctx)
        self._waiters: list[tuple] = []
        self._batch_task: asyncio.Task | None = None
        self.total_grvs = 0
        from ..runtime.latency_probe import StageStats
        # grv_wait: request arrival -> version handed back
        self.stages = StageStats("GrvProxy")
        # TransactionDebug span events for sampled requests (the
        # GrvProxyServer.queued/reply locations of the reference)
        self.spans = SpanSink("GrvProxy")
        self.sampled_txns = 0
        # deterministic 1-in-N SERVER-side roots for requests arriving
        # without a sampled client context:
        # a GRV/read-only-heavy workload whose client never samples —
        # old bindings, sidecar probes — still shows up in the trace
        # file with GrvProxyServer.queued/reply timelines
        self._server_sampler = ServerSampler(namespace=1)
        self._msource = None

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry: GRV
        throughput plus the waiter queue depth (a
        rising depth with flat TotalGrvs is admission wedging reads)."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("GrvProxy")
            s.gauge("TotalGrvs", lambda: self.total_grvs)
            s.gauge("SampledTxns", lambda: self.sampled_txns)
            s.gauge("WaiterDepth", lambda: len(self._waiters))
            self._msource = s
        return self._msource

    async def metrics(self) -> dict:
        """Role counters for status (span rollup + GRV load)."""
        from ..runtime.profiler import stall_metrics
        from ..runtime.span import process_counters
        return {
            "total_grvs": self.total_grvs,
            "sampled_txns": self.sampled_txns,
            **self.spans.counters(),
            **stall_metrics(),
            **process_counters(),
        }

    async def get_read_version(self, lock_aware: bool = False,
                               priority: str = "default",
                               tag: str | None = None) -> Version:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        ctx = current_span()
        if ctx is None:
            ctx = self._server_sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        if ctx is not None and ctx.sampled:
            self.sampled_txns += 1
            self.spans.event("TransactionDebug", ctx,
                             "GrvProxyServer.queued", Priority=priority)
        else:
            ctx = None
        self._waiters.append((fut, lock_aware, priority, tag, ctx))
        if self._batch_task is None or self._batch_task.done():
            # mask the request's span: this task outlives the request
            # (it drains every later batch), and its sequencer/ratekeeper
            # calls must not be attributed to whichever sampled txn
            # happened to spawn it
            with no_span():
                self._batch_task = loop.create_task(self._serve_batch(),
                                                    name="grv-batch")
        t0 = loop.time()
        try:
            return await fut
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # pair the .queued event when the batch fails the waiter
            self.spans.event("TransactionDebug", ctx,
                             "GrvProxyServer.Error", Error=type(e).__name__)
            raise
        finally:
            self.stages.record("grv_wait", loop.time() - t0)

    async def _serve_batch(self) -> None:
        from ..runtime.buggify import buggify
        await asyncio.sleep(self.knobs.GRV_BATCH_INTERVAL)
        if buggify("grv_slow_batch"):
            from ..runtime.rng import deterministic_random
            # a stalled GRV batch: read versions arrive late and stale-er
            await asyncio.sleep(deterministic_random().random() * 0.05)
        # Drain in a loop: requests arriving while we await the (possibly
        # remote) sequencer join the next round instead of being lost.
        # The final empty check and the task becoming done() are atomic in
        # one scheduler step, so get_read_version's done() gate is safe.
        while self._waiters:
            waiters, self._waiters = self._waiters, []
            # group by (priority, tag) and serve each lane INDEPENDENTLY:
            # an immediate (system) request must get its version while
            # the batch lane is still crawling through its leftover
            # budget, and an untagged default request must not wait out
            # a throttled hot tag's bucket drain just because they share
            # a batch — a single shared sequencer round after all
            # admissions would invert priorities (the reference batches
            # GRVs per priority for the same reason,
            # REF:fdbserver/GrvProxyServer.actor.cpp + TagThrottler)
            lanes: dict[tuple, list] = {}
            for w in waiters:
                lanes.setdefault((w[2], w[3]), []).append(w)
            await asyncio.gather(*(self._serve_lane(prio, tag, ws)
                                   for (prio, tag), ws in lanes.items()))

    async def _serve_lane(self, prio: str, tag: str | None,
                          waiters: list) -> None:
        try:
            if self.ratekeeper is not None:
                # positional args only: this may be an RPC stub.  Inside
                # the try: an unreachable ratekeeper must reject the
                # waiters (clients retry), not hang them.
                await self.ratekeeper.admit(
                    len(waiters), prio,
                    {tag: len(waiters)} if tag is not None else None)
            version, lock_uid = \
                await self.sequencer.get_live_committed_version()
            self.total_grvs += len(waiters)
            for fut, lock_aware, _prio, _tag, ctx in waiters:
                if fut.done():
                    continue
                if lock_uid is not None and not lock_aware:
                    # the read side of the database lock (REF:
                    # GetReadVersionReply.locked → NativeAPI throws):
                    # an application still pointed at a switched-over
                    # primary must hear about it, not read stale data
                    # (no reply span — get_read_version pairs .queued
                    # with the .Error its waiter raises)
                    from ..runtime.errors import DatabaseLocked
                    fut.set_exception(DatabaseLocked())
                else:
                    self.spans.event("TransactionDebug", ctx,
                                     "GrvProxyServer.reply", Version=version)
                    fut.set_result(version)
        except Exception as e:
            for fut, *_rest in waiters:
                if not fut.done():
                    fut.set_exception(e)
