"""Same-tick client read coalescing — the multiget batcher.

Reference: REF:fdbclient/NativeAPI.actor.cpp getValues +
REF:fdbserver/storageserver.actor.cpp getValueQ — the reference batches
point reads at the storage server; the client half here makes sure
batches actually FORM: every concurrent ``Transaction.get`` that lands
in the same event-loop tick — across transactions as well as within
one, since GRV batching hands concurrent transactions the same read
version — groups by owning shard and ships as ONE packed
``GetValuesRequest`` per (shard, read version) instead of one RPC per
key.

Discipline:

- RYW lookups and conflict-range bookkeeping happen in the Transaction
  BEFORE a key reaches this module, so snapshot and non-snapshot reads
  coalesce into the same wire batch while recording conflicts
  independently;
- single-flight per shard: while a batch is on the wire, later
  arrivals queue and ride the NEXT flush — a hot shard sees a steady
  stream of maximal batches, never a convoy of tiny ones;
- per-key failures come back as status codes in the reply and are
  re-raised per waiter, so one too-old key fails exactly the reads
  that asked for it;
- scheduling is deterministic: no RNG, no timers — the flush task is
  an ordinary ``create_task`` whose body runs one ready-queue
  iteration after the submissions that scheduled it (virtual-time sim
  loops included), which is the "deterministic batch boundary" the
  seeded sims rely on.
"""

from __future__ import annotations

import asyncio

from ..core.data import GetValuesRequest
from ..runtime import span as _span
from ..runtime.errors import error_from_code

__all__ = ["ReadCoalescer"]


class _ShardQueue:
    __slots__ = ("group", "items", "task")

    def __init__(self, group) -> None:
        self.group = group
        # (key, future, span ctx) in arrival order
        self.items: list = []
        self.task: asyncio.Task | None = None


class ReadCoalescer:
    """One per cluster view (attached lazily, like the TraceBatch):
    Transaction point reads funnel through ``submit``.

    Queues key on (shard team, read version): single-flight applies PER
    VERSION, so a batch parked in the storage future-version wait (a
    client racing ahead of a lagging replica) head-of-line-blocks only
    reads at that same stuck version — other transactions' immediately
    servable reads on the shard flush independently.  A drained queue
    deletes itself, so dead ReplicaGroups from shard splits and view
    rebuilds are never retained."""

    def __init__(self) -> None:
        self._queues: dict[tuple[int, int], _ShardQueue] = {}
        # observability: batch formation stats (status rollups and the
        # perf smoke read off these)
        self.batches = 0
        self.keys_batched = 0
        self.max_batch = 0

    def submit(self, group, key: bytes, version: int) -> asyncio.Future:
        """Enqueue one point read against ``group`` (the key's replica
        team); resolves to the value (or None) or raises the per-key
        error."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        qkey = (id(group), version)
        q = self._queues.get(qkey)
        if q is None or q.group is not group:
            # id() reuse after a view rebuild re-keys the slot; the
            # old queue object keeps draining its own in-flight batch
            q = self._queues[qkey] = _ShardQueue(group)
        # the submitter's active span (the txn's NativeAPI.get hop):
        # the flush task runs outside every submitter's context, so
        # wire propagation needs the context captured HERE
        q.items.append((key, fut, _span.current_span()))
        if q.task is None:
            q.task = loop.create_task(self._drain(qkey, q, version),
                                      name="multiget-flush")
        return fut

    async def _drain(self, qkey: tuple[int, int], q: _ShardQueue,
                     version: int) -> None:
        try:
            while q.items:
                items, q.items = q.items, []
                keymap: dict[bytes, list] = {}
                ctx = None
                for k, f, c in items:
                    keymap.setdefault(k, []).append(f)
                    if ctx is None and c is not None:
                        ctx = c
                await self._fetch(q.group, version, keymap, ctx)
        finally:
            # no await between the loop's emptiness check and this
            # cleanup, so a submit can never race into a dead task —
            # and the drained queue leaves the map (no growth across
            # view rebuilds / version churn)
            q.task = None
            if q.items:
                # the drain died mid-flight (cancellation): waiters
                # queued behind the in-flight batch must not hang
                # forever-pending on a task that no longer exists
                items, q.items = q.items, []
                for _k, f, _c in items:
                    if not f.done():
                        f.cancel()
            if self._queues.get(qkey) is q:
                del self._queues[qkey]

    async def _fetch(self, group, version: int, keymap: dict[bytes, list],
                     ctx=None) -> None:
        skeys = sorted(keymap)          # the wire contract: sorted keys
        self.batches += 1
        self.keys_batched += len(skeys)
        if len(skeys) > self.max_batch:
            self.max_batch = len(skeys)
        try:
            # re-activate the first sampled submitter's span around the
            # wire hop: a batch answers many transactions, but a trace
            # that follows ONE sampled read to its serving storage span
            # (the scalar path's behavior) beats attributing to nobody
            token = _span.activate(ctx) if ctx is not None else None
            try:
                reply = await group.get_values(
                    GetValuesRequest.from_keys(skeys, version))
            finally:
                if token is not None:
                    _span.deactivate(token)
        except BaseException as e:
            first = True
            for futs in keymap.values():
                for f in futs:
                    if f.done():
                        continue
                    # fresh instance per waiter past the first (same
                    # discipline as the per-key branch below): a shared
                    # exception object accretes every waiter's re-raise
                    # frames onto one traceback
                    if first:
                        err, first = e, False
                    else:
                        try:
                            err = type(e)(*e.args)
                            if "code" in e.__dict__:
                                err.code = e.code   # instance-level code
                        except Exception:  # noqa: BLE001 — exotic ctor
                            err = e
                    f.set_exception(err)
            if isinstance(e, asyncio.CancelledError):
                raise
            return
        for i, k in enumerate(skeys):
            err, value = reply.unpack(i)
            for f in keymap[k]:
                if f.done():
                    continue
                if err is not None:
                    # a fresh instance per waiter: shared exception
                    # objects accrete each other's tracebacks
                    f.set_exception(error_from_code(err))
                else:
                    f.set_result(value)

    def stats(self) -> dict:
        mean = (self.keys_batched / self.batches) if self.batches else 0.0
        return {"read_batches": self.batches,
                "read_keys_batched": self.keys_batched,
                "read_batch_mean": round(mean, 2),
                "read_batch_max": self.max_batch}
