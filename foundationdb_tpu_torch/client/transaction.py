"""Transaction: snapshot reads + RYW + OCC commit.

Reference: REF:fdbclient/NativeAPI.actor.cpp (Transaction::get/getRange/
commit/onError) and REF:fdbclient/ReadYourWrites.actor.cpp (merging
buffered writes into reads, conflict-range bookkeeping).  The lifecycle
and retry contract match the C API: use once, ``on_error`` decides
retryability and resets, commit makes the txn immutable until reset.
"""

from __future__ import annotations

import asyncio
import contextlib

from ..core.cluster import Cluster
from ..core.data import (CommitTransactionRequest, KeySelector, MutationType,
                         Version, key_after)
from ..runtime import span as _span
from ..runtime.errors import (CommitUnknownResult, FdbError, InvalidOption,
                              IoError as _IoError, KeyOutsideLegalRange,
                              KeyTooLarge, RequestMaybeDelivered,
                              TransactionCancelled, TransactionTooLarge,
                              TransactionReadOnly, UsedDuringCommit,
                              ValueTooLarge)
from ..runtime.rng import deterministic_random
from .writemap import WriteMap

# client-side span events for sampled transactions (the NativeAPI.*
# locations of the reference's debugTransaction)
_SPANS = _span.SpanSink("client")


@contextlib.contextmanager
def _hop(ctx: _span.SpanContext | None, evtype: str = "",
         base: str = "", **details):
    """Activate a child span of the txn's root for one client→role hop;
    the active context rides the RPC envelope (rpc/transport.py) so the
    serving role's span events key to this transaction.  With a
    ``base`` location, emits ``{base}.Before`` on entry and pairs it
    with ``{base}.Error`` if the hop raises (the success site emits its
    own ``.After`` with result details) — the analyzer's consecutive-
    pair stats need every Before closed."""
    with _span.child_scope(ctx) as child:
        if child is None:
            yield None
            return
        if base:
            _SPANS.event(evtype, child, base + ".Before", **details)
        try:
            yield child
        except BaseException as e:
            if base:
                _SPANS.event(evtype, child, base + ".Error",
                             Error=type(e).__name__)
            raise


class Transaction:
    def __init__(self, cluster: Cluster) -> None:
        self._cluster = cluster
        self._knobs = cluster.knobs
        # LOCK_AWARE survives reset/on_error like an upstream persistent
        # transaction option (REF:fdbclient/NativeAPI.actor.cpp
        # TransactionOptions held across resets by the retry loop).
        # priority ("default" | "batch" | "immediate") and throttle_tag
        # are the GRV admission options (PRIORITY_BATCH /
        # PRIORITY_SYSTEM_IMMEDIATE / AUTO_THROTTLE_TAG upstream) —
        # enforced by the Ratekeeper through the GRV proxies.
        self.lock_aware = False
        self.priority = "default"
        self.throttle_tag: str | None = None
        # the C API's bounded-failure trio (REF:fdbclient/NativeAPI.actor.cpp
        # TransactionOptions TIMEOUT /
        # RETRY_LIMIT / MAX_RETRY_DELAY): enforced in on_error and on
        # the blocking surfaces, so a degraded cluster surfaces a
        # bounded transaction_timed_out instead of an unbounded hang.
        # Persistent across reset/on_error like lock_aware; the timeout
        # covers the transaction INCLUDING retries (upstream semantics).
        self.timeout = self._knobs.DEFAULT_TIMEOUT          # seconds; 0 off
        self.retry_limit = self._knobs.DEFAULT_RETRY_LIMIT  # -1 unlimited
        self.max_retry_delay = self._knobs.DEFAULT_MAX_RETRY_DELAY
        self._deadline: float | None = None
        # SPECIAL_KEY_SPACE_ENABLE_WRITES (REF: the transaction option
        # gating management writes through \xff\xff)
        self.special_key_space_enable_writes = False
        # layer commit hooks: async fn(tr) callables run at
        # the start of every commit() attempt, BEFORE _committing flips
        # — so a hook can still read (the pre-write values whose derived
        # rows it must clear) and write (the replacement derived rows)
        # into the SAME commit.  Persistent across reset/on_error like
        # lock_aware: db.run's retry loop re-runs the body, the body
        # re-buffers its writes, and the hook re-derives from them.
        self._commit_hooks: list = []
        self.reset()

    # --- bounded-failure options (the C API trio) ---

    def set_timeout(self, seconds: float) -> None:
        """Whole-transaction deadline, retries included; 0 disables.
        Validated BEFORE mutating: a rejected value must leave any
        previously armed deadline untouched."""
        seconds = float(seconds)
        if seconds < 0:
            raise InvalidOption("timeout must be >= 0")
        self.timeout = seconds
        self._deadline = None
        if self.timeout > 0:
            try:
                self._deadline = asyncio.get_running_loop().time() \
                    + self.timeout
            except RuntimeError:
                pass            # armed lazily at first use

    def set_retry_limit(self, limit: int) -> None:
        """on_error retries allowed before the error is re-raised;
        -1 = unlimited, 0 = never retry."""
        self.retry_limit = int(limit)

    def set_max_retry_delay(self, seconds: float) -> None:
        if seconds <= 0:
            raise InvalidOption("max_retry_delay must be > 0")
        self.max_retry_delay = float(seconds)

    def _remaining(self) -> float | None:
        """Seconds until the deadline (None = no timeout armed)."""
        if self.timeout <= 0:
            return None
        loop = asyncio.get_running_loop()
        if self._deadline is None:
            self._deadline = loop.time() + self.timeout
        return self._deadline - loop.time()

    def _check_deadline(self) -> None:
        """Cheap entry-point check: an op issued past the deadline fails
        NOW with transaction_timed_out instead of dialing the cluster
        (the blocking awaits themselves are raced via ``_bounded``)."""
        if self.timeout > 0:
            rem = self._remaining()
            if rem is not None and rem <= 0:
                from ..runtime.errors import TransactionTimedOut
                raise TransactionTimedOut()

    async def _bounded(self, coro):
        """Race one blocking await against the transaction deadline —
        what turns a wedged read/commit on a degraded cluster into a
        bounded transaction_timed_out."""
        rem = self._remaining()
        if rem is None:
            return await coro
        if rem <= 0:
            if asyncio.iscoroutine(coro):
                coro.close()
            else:                   # a Future (e.g. the shielded GRV)
                coro.cancel()
            from ..runtime.errors import TransactionTimedOut
            raise TransactionTimedOut()
        try:
            return await asyncio.wait_for(coro, rem)
        except asyncio.TimeoutError:
            from ..runtime.errors import TransactionTimedOut
            raise TransactionTimedOut() from None

    # --- lifecycle ---

    def reset(self) -> None:
        # watches never armed (txn reset before a successful commit) fail
        # like upstream rather than leaving their awaiters hung
        for fut in getattr(self, "_watch_futures", ()):
            if not fut.done():
                fut.set_exception(TransactionCancelled())
        self._writes = WriteMap()
        self._read_conflicts: list[tuple[bytes, bytes]] = []
        self._write_conflicts: list[tuple[bytes, bytes]] = []
        self._read_version: Version | None = None
        old_grv = getattr(self, "_grv_task", None)
        if old_grv is not None and not old_grv.done():
            old_grv.cancel()
        self._grv_task: asyncio.Task | None = None
        self._committed_version: Version | None = None
        self._versionstamp: bytes | None = None
        self._committing = False
        self._retry_count = 0
        self._watches_pending: list[tuple[bytes, bytes | None]] = []
        self._watch_futures: list[asyncio.Future] = []
        tb = getattr(self._cluster, "trace_batch", None)
        if tb is not None and getattr(self, "_probe_id", None) is not None:
            tb.discard(self._probe_id)
        self._probe_id: int | None = None
        self._span: _span.SpanContext | None = None
        self._special_error: bytes | None = None

    def _check_mutable(self) -> None:
        if self._committing:
            raise UsedDuringCommit()

    # --- read version ---

    _probe_counter = 0      # class-wide txn ids for TraceBatch probes

    async def get_read_version(self) -> Version:
        if self._read_version is not None:
            return self._read_version
        # single-flight: concurrent first reads must share ONE snapshot —
        # two GRV fetches would split the transaction's read version and
        # commit-time conflict checking would miss writes between them
        if self._grv_task is None:
            self._grv_task = asyncio.get_running_loop().create_task(
                self._fetch_read_version(), name="txn-grv")
        # the shield keeps the shared GRV fetch alive when the deadline
        # cancels this waiter (a sibling read may still be inside it)
        return await self._bounded(asyncio.shield(self._grv_task))

    async def _fetch_read_version(self) -> Version:
        # TraceBatch latency probe (REF:flow/Trace.h TraceBatch): a
        # sampled fraction of transactions carry per-stage probes
        # from GRV through commit, flushed as one TransactionTrace.
        # The same counter-based sampling decision roots the distributed
        # span (no extra RNG draw: seeded sim streams are unperturbed)
        tb = getattr(self._cluster, "trace_batch", None)
        if tb is not None and self._probe_id is None:
            Transaction._probe_counter += 1
            if tb.attach(Transaction._probe_counter):
                self._probe_id = Transaction._probe_counter
                self._span = _span.new_root(Transaction._probe_counter)
        proxy = deterministic_random().choice(self._cluster.grv_proxies)
        with _hop(self._span, "TransactionDebug",
                  "NativeAPI.getReadVersion") as h:
            self._read_version = await proxy.get_read_version(
                self.lock_aware, self.priority, self.throttle_tag)
            _SPANS.event("TransactionDebug", h,
                         "NativeAPI.getReadVersion.After",
                         Version=self._read_version)
        if self._probe_id is not None and tb is not None:
            tb.event(self._probe_id, "grv")
        return self._read_version

    def set_read_version(self, version: Version) -> None:
        self._read_version = version

    # --- reads ---

    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        self._check_mutable()
        self._check_deadline()
        if key.startswith(b"\xff\xff"):
            return await self._special_key(key)
        self._check_key(key)
        kind, payload = self._writes.lookup(key)
        if kind == "value" and not snapshot:
            # fully determined by this txn's writes; reads of your own
            # writes add no read conflict (RYW semantics)
            return payload
        version = await self.get_read_version()
        if kind == "value":
            return payload
        if not snapshot:
            self._read_conflicts.append((key, key_after(key)))
        with _hop(self._span, "TransactionDebug", "NativeAPI.get") as h:
            base = await self._bounded(self._storage_read(key, version))
            _SPANS.event("TransactionDebug", h, "NativeAPI.get.After")
        if kind == "stack":
            return WriteMap.fold_with_base(payload, base)
        return base

    async def _storage_read(self, key: bytes, version: Version
                            ) -> bytes | None:
        """One storage point read.  With CLIENT_COALESCE_READS (the
        default) it rides the cluster's multiget batcher: every
        concurrent point read landing in the same event-loop tick —
        this transaction's or any other's at any read version — groups
        by owning shard into one packed GetValuesRequest
        (client/read_coalescer.py).  Off, it is the scalar pre-714
        one-RPC-per-key path the equivalence tests compare against."""
        group = self._cluster.storage_for_key(key)
        if not getattr(self._knobs, "CLIENT_COALESCE_READS", True):
            return await group.get_value(key, version)
        co = getattr(self._cluster, "_read_coalescer", None)
        if co is None:
            from .read_coalescer import ReadCoalescer
            co = ReadCoalescer()
            self._cluster._read_coalescer = co
        return await co.submit(group, key, version)

    async def get_multi(self, keys: list[bytes], snapshot: bool = False
                        ) -> list[bytes | None]:
        """Batched point reads: the values of ``keys`` in input order
        (the fdb_transaction_get_multi surface).  Per-key
        semantics are EXACTLY a ``get`` loop's — RYW overlays fold,
        non-snapshot reads record one read-conflict range per key,
        special keys answer client-side — but the storage half ships
        as one packed multiget per owning shard, fanned out and
        reassembled in key order."""
        self._check_mutable()
        self._check_deadline()
        results: list[bytes | None] = [None] * len(keys)
        fetch: list[tuple[int, bytes, str, object]] = []
        for i, key in enumerate(keys):
            if key.startswith(b"\xff\xff"):
                results[i] = await self._special_key(key)
                continue
            self._check_key(key)
            kind, payload = self._writes.lookup(key)
            if kind == "value" and not snapshot:
                results[i] = payload    # RYW: fully determined
                continue
            fetch.append((i, key, kind, payload))
        if not fetch:
            return results
        version = await self.get_read_version()
        # group by owning shard — ONE packed GetValuesRequest per shard,
        # fanned out concurrently, no per-key task/future (the per-key
        # async overhead is exactly what this path amortizes away)
        from ..core.data import GetValuesRequest
        from ..runtime.errors import error_from_code
        per_shard: dict[object, list[bytes]] = {}
        waits: list[tuple[int, str, object, bytes]] = []
        for i, key, kind, payload in fetch:
            if kind == "value":         # snapshot read of a buffered set
                results[i] = payload
                continue
            if not snapshot:
                self._read_conflicts.append((key, key_after(key)))
            g = self._cluster.storage_for_key(key)
            per_shard.setdefault(g, []).append(key)
            waits.append((i, kind, payload, key))
        if not waits:
            return results
        reqs = [(g, sorted(set(ks))) for g, ks in per_shard.items()]
        with _hop(self._span, "TransactionDebug", "NativeAPI.getValues",
                  Keys=len(waits), Shards=len(reqs)) as h:
            replies = await self._bounded(asyncio.gather(
                *(g.get_values(GetValuesRequest.from_keys(sk, version))
                  for g, sk in reqs),
                return_exceptions=True))
            err = next((r for r in replies if isinstance(r, BaseException)),
                       None)
            if err is not None:
                raise err
            valmap: dict[bytes, bytes | None] = {}
            errcode: int | None = None
            for (_g, sk), rep in zip(reqs, replies):
                for j, k in enumerate(sk):
                    ec, valmap[k] = rep.unpack(j)
                    if errcode is None and ec is not None:
                        errcode = ec
            if errcode is not None:
                # one bad key fails the call exactly as it would have
                # failed the scalar get() loop — the txn's retry loop
                # owns recovery
                raise error_from_code(errcode)
            _SPANS.event("TransactionDebug", h, "NativeAPI.getValues.After",
                         Keys=len(waits))
        for i, kind, payload, key in waits:
            base = valmap[key]
            results[i] = (WriteMap.fold_with_base(payload, base)
                          if kind == "stack" else base)
        return results

    async def _special_key(self, key: bytes) -> bytes | None:
        """The ``\\xff\\xff`` special-key space (REF:fdbclient/
        SpecialKeySpace.actor.cpp): module-backed reads answered by the
        client, not storage.  No read conflict is taken.  Dispatch lives
        in client/special_keys.py's module registry."""
        from .special_keys import SPECIAL_KEY_SPACE
        return await SPECIAL_KEY_SPACE.get(self, key)

    async def get_addresses_for_key(self, key: bytes) -> list[str]:
        from .locality import get_addresses_for_key
        return await get_addresses_for_key(self, key)

    async def get_range(self, begin, end, limit: int = 0,
                        reverse: bool = False, snapshot: bool = False
                        ) -> list[tuple[bytes, bytes]]:
        """begin/end: bytes or KeySelector.  Returns up to ``limit`` pairs."""
        self._check_mutable()
        self._check_deadline()
        if isinstance(begin, bytes) and begin.startswith(b"\xff\xff"):
            # special-key range read: module-backed, may span modules
            from .special_keys import SPECIAL_KEY_SPACE
            if not isinstance(end, bytes):
                from ..runtime.errors import ClientInvalidOperation
                raise ClientInvalidOperation(
                    "key selectors are not supported in the special-key "
                    "space; pass byte bounds")
            return await SPECIAL_KEY_SPACE.get_range(
                self, begin, end, limit=limit, reverse=reverse)
        if isinstance(begin, KeySelector):
            begin = await self.get_key(begin, snapshot=True)
        if isinstance(end, KeySelector):
            end = await self.get_key(end, snapshot=True)
        if begin >= end:
            return []
        with _hop(self._span, "TransactionDebug", "NativeAPI.getRange") as h:
            # deadline-bounded: a wedged shard fetch on a
            # degraded cluster surfaces transaction_timed_out instead
            # of hanging the scan unboundedly
            out = await self._bounded(
                self._merged_range(begin, end, limit, reverse))
            _SPANS.event("TransactionDebug", h, "NativeAPI.getRange.After",
                         Rows=len(out))
        if not snapshot:
            # conflict range covers what was actually observed: the whole
            # requested range if exhausted, else up to the last-seen key
            if limit and len(out) >= limit:
                if reverse:
                    self._read_conflicts.append((out[-1][0], end))
                else:
                    self._read_conflicts.append((begin, key_after(out[-1][0])))
            else:
                self._read_conflicts.append((begin, end))
        return out

    async def _snapshot_stream(self, begin: bytes, end: bytes,
                               version: Version, reverse: bool,
                               chunk: int | None = None):
        """Yield storage rows of [begin, end) in key order (or reverse),
        following each shard's 'more' flag — no row is ever silently
        dropped by a fetch limit.

        With CLIENT_PACKED_RANGE_READS (the default) every fetch rides
        the packed GetRangeRequest/Reply RPC; off, the scalar
        pre-715 tuple-list RPC — byte-identical rows either way
        (tested).  The per-fetch row limit starts at
        CLIENT_RANGE_CHUNK_ROWS and DOUBLES after every truncated reply
        (the iterator-mode growth of REF:fdbclient/NativeAPI.actor.cpp
        getRange), capped where the next reply would exceed
        CLIENT_RANGE_CHUNK_BYTES at the observed mean row size — a long
        scan converges to few large fetches without letting huge rows
        blow the reply budget."""
        if getattr(self._knobs, "CLIENT_PACKED_RANGE_READS", True):
            async for page in self._snapshot_stream_packed(
                    begin, end, version, reverse, chunk):
                for kv in page:
                    yield kv
            return
        if chunk is None:
            chunk = self._knobs.CLIENT_RANGE_CHUNK_ROWS
        budget = self._knobs.CLIENT_RANGE_CHUNK_BYTES
        servers = self._cluster.storages_for_range(begin, end)
        servers.sort(key=lambda ss: ss.shard.begin, reverse=reverse)
        for ss in servers:
            b = max(begin, ss.shard.begin)
            e = min(end, ss.shard.end)
            while b < e:
                # budget rides positionally: RPC stubs are *args-only
                kvs, more = await ss.get_key_values(b, e, version, chunk,
                                                    reverse, budget)
                for kv in kvs:
                    yield kv
                if not more:
                    break
                if reverse:
                    e = kvs[-1][0]            # exclusive end: continue below
                else:
                    b = key_after(kvs[-1][0])
                nbytes = sum(len(k) + len(v) for k, v in kvs)
                avg = max(1, nbytes // max(1, len(kvs)))
                chunk = max(chunk, min(chunk * 2, max(1, budget // avg)))

    async def _snapshot_stream_packed(self, begin: bytes, end: bytes,
                                      version: Version, reverse: bool,
                                      chunk: int | None = None):
        """Yield PackedRows PAGES of [begin, end) in scan order over the
        packed range RPC — the bulk twin of _snapshot_stream,
        one page per storage reply, same shard fan-out, continuation
        and adaptive chunk growth.  A refused chunk's status byte maps
        back to the error class the scalar path raised (after the
        replica group has already failed over lagging/compacted
        replicas), so every retry contract upstream is unchanged."""
        from ..core.data import GV_ERROR_CODES, GetRangeRequest
        from ..runtime.errors import error_from_code
        if chunk is None:
            chunk = self._knobs.CLIENT_RANGE_CHUNK_ROWS
        budget = self._knobs.CLIENT_RANGE_CHUNK_BYTES
        servers = self._cluster.storages_for_range(begin, end)
        servers.sort(key=lambda ss: ss.shard.begin, reverse=reverse)
        for ss in servers:
            b = max(begin, ss.shard.begin)
            e = min(end, ss.shard.end)
            while b < e:
                rep = await ss.get_key_values_packed(
                    GetRangeRequest(b, e, version, chunk, reverse, budget))
                if rep.status:
                    raise error_from_code(GV_ERROR_CODES[rep.status])
                page = rep.columns()
                n = len(page)
                if n:
                    yield page
                if not rep.more or not n:
                    break
                last = page.key(n - 1)
                if reverse:
                    e = last                  # exclusive end: continue below
                else:
                    b = key_after(last)
                avg = max(1, page.nbytes() // n)
                chunk = max(chunk, min(chunk * 2, max(1, budget // avg)))

    async def _merged_range(self, begin: bytes, end: bytes, limit: int,
                            reverse: bool) -> list[tuple[bytes, bytes]]:
        """Merge the snapshot stream with buffered writes (the RYWIterator
        analog, REF:fdbclient/RYWIterator.cpp): two sorted streams —
        storage rows (clears applied) and written keys — merged until
        ``limit`` rows are produced or both are exhausted."""
        version = await self.get_read_version()
        written = self._writes.written_keys_in(begin, end)
        if not written and not self._writes.clears_in(begin, end) \
                and getattr(self._knobs, "CLIENT_PACKED_RANGE_READS", True):
            # no buffered write touches the range: the merge is the
            # identity, so packed reply pages bulk-extend the result
            # instead of walking the per-row loop below (the scan-heavy
            # fast path)
            out = []
            async for page in self._snapshot_stream_packed(
                    begin, end, version, reverse):
                rows = page.rows()
                if limit and len(out) + len(rows) >= limit:
                    out.extend(rows[:limit - len(out)])
                    break
                out.extend(rows)
            return out
        if reverse:
            written = written[::-1]
        snap = self._snapshot_stream(begin, end, version, reverse)
        out: list[tuple[bytes, bytes]] = []
        wi = 0
        pending_snap: tuple[bytes, bytes] | None = None

        def before(a: bytes, b: bytes) -> bool:
            return a > b if reverse else a < b

        async def next_snap():
            async for k, v in snap:
                if not self._writes.range_cleared(k):
                    return (k, v)
            return None

        while not limit or len(out) < limit:
            if pending_snap is None:
                pending_snap = await next_snap()
            wkey = written[wi] if wi < len(written) else None
            if pending_snap is None and wkey is None:
                break
            use_write = wkey is not None and (
                pending_snap is None or not before(pending_snap[0], wkey))
            if use_write:
                base = None
                if pending_snap is not None and pending_snap[0] == wkey:
                    base = pending_snap[1]
                    pending_snap = None     # consumed as the fold base
                kind, payload = self._writes.lookup(wkey)
                v = (WriteMap.fold_with_base(payload, base)
                     if kind == "stack" else payload)
                if v is not None:
                    out.append((wkey, v))
                wi += 1
            else:
                out.append(pending_snap)
                pending_snap = None
        return out

    async def get_range_packed(self, begin: bytes, end: bytes,
                               limit: int = 0):
        """Columnar snapshot range read: up to ``limit`` rows of
        [begin, end) as ONE PackedRows — the reply pages' columns
        concatenated by blob join + vectorized bounds rebase, never a
        per-row tuple list.  Snapshot-only (no read conflict)
        and only legal while no buffered write overlaps the range: the
        RYW merge would force per-row re-materialization, which is
        exactly what this surface exists to delete.  The backup
        snapshot writer is the canonical consumer — its pages reach the
        ``.kvr`` frame byte-identical to the tuple path (tested)."""
        self._check_mutable()
        self._check_deadline()
        if self._writes.written_keys_in(begin, end) \
                or self._writes.clears_in(begin, end):
            from ..runtime.errors import ClientInvalidOperation
            raise ClientInvalidOperation(
                "get_range_packed on a range this transaction has "
                "buffered writes in — use get_range")
        from ..core.data import PackedRows
        version = await self.get_read_version()
        with _hop(self._span, "TransactionDebug", "NativeAPI.getRange") as h:
            parts: list[PackedRows] = []
            n = 0
            async for page in self._snapshot_stream_packed(
                    begin, end, version, False):
                if limit and n + len(page) >= limit:
                    parts.append(page.slice(0, limit - n))
                    n = limit
                    break
                parts.append(page)
                n += len(page)
            _SPANS.event("TransactionDebug", h, "NativeAPI.getRange.After",
                         Rows=n)
        return PackedRows.concat(parts)

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a KeySelector against the merged view
        (REF:fdbclient/NativeAPI.actor.cpp resolveKey).

        With no buffered write overlapping the probe span, resolution
        rides the packed ``get_key`` RPC (PROTOCOL_VERSION
        716): each shard answers with ONE key + a live-row count and
        the client walks shards carrying the residual offset — the
        legacy path row-probed up to ``offset`` full (key, value) rows
        through ``_merged_range``.  Resolved keys are identical by
        construction (the server locates rows with the same merged
        extraction the range read uses; equivalence tested on
        randomized selectors), and a transaction with overlapping RYW
        writes falls back to the legacy merge, which already handles
        them."""
        self._check_mutable()
        self._check_deadline()
        k, oe, off = selector.key, selector.or_equal, selector.offset
        if off > 0:
            # firstGreaterOrEqual(k)+n / firstGreaterThan(k)+n
            start = key_after(k) if oe else k
            result = await self._resolve_key(start, b"\xff", off,
                                             reverse=False)
            if result is None:
                result = b"\xff"  # off the end: clamp to keyspace end
        else:
            # lastLessOrEqual(k)-n / lastLessThan(k)-n
            stop = key_after(k) if oe else k
            result = await self._resolve_key(b"", stop, 1 - off,
                                             reverse=True)
            if result is None:
                result = b""
        if not snapshot:
            lo = min(result, k)
            hi = max(key_after(result), key_after(k) if oe else k)
            if lo < hi:
                self._read_conflicts.append((lo, hi))
        return result

    async def _resolve_key(self, begin: bytes, end: bytes, n: int,
                           reverse: bool) -> bytes | None:
        """The ``n``-th live key of [begin, end) in scan order (from
        the end when ``reverse``), or None when fewer than ``n`` rows
        exist.  Packed shard walk when no buffered write overlaps the
        span; the legacy ``_merged_range`` row-probe otherwise."""
        if self._writes.written_keys_in(begin, end) \
                or self._writes.clears_in(begin, end):
            rows = await self._merged_range(begin, end, n, reverse)
            return rows[n - 1][0] if len(rows) >= n else None
        from ..core.data import GV_ERROR_CODES, GetKeyRequest
        from ..runtime.errors import error_from_code
        version = await self.get_read_version()
        servers = self._cluster.storages_for_range(begin, end)
        servers.sort(key=lambda ss: ss.shard.begin, reverse=reverse)
        remaining = n
        for ss in servers:
            b = max(begin, ss.shard.begin)
            e = min(end, ss.shard.end)
            if b >= e:
                continue
            rep = await ss.get_key(
                GetKeyRequest(b, e, version, remaining, reverse))
            if rep.status:
                # every replica refused: surface the same error class
                # the legacy range fetch raised — retry discipline
                # upstream (on_error) is unchanged
                raise error_from_code(GV_ERROR_CODES[rep.status])
            if rep.count >= remaining:
                return bytes(rep.key)
            remaining -= rep.count
        return None

    # --- writes ---

    def set(self, key: bytes, value: bytes) -> None:
        self._check_mutable()
        if key.startswith(b"\xff\xff"):
            # special-key writes (REF: SpecialKeySpace RW modules) are
            # rewritten onto real system keys inside this txn; gated by
            # the SPECIAL_KEY_SPACE_ENABLE_WRITES option
            from .special_keys import SPECIAL_KEY_SPACE
            SPECIAL_KEY_SPACE.set(self, key, value)
            return
        self._check_key(key)
        if len(value) > self._knobs.VALUE_SIZE_LIMIT:
            raise ValueTooLarge()
        self._writes.set(key, value)
        self._write_conflicts.append((key, key_after(key)))

    def clear(self, key: bytes) -> None:
        self._check_mutable()
        if key.startswith(b"\xff\xff"):
            from .special_keys import SPECIAL_KEY_SPACE
            SPECIAL_KEY_SPACE.clear(self, key)
            return
        self._check_key(key)
        self._writes.clear_range(key, key_after(key))
        self._write_conflicts.append((key, key_after(key)))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._check_mutable()
        if begin >= end:
            return
        if begin.startswith(b"\xff\xff"):
            from .special_keys import SPECIAL_KEY_SPACE
            SPECIAL_KEY_SPACE.clear(self, begin, end)
            return
        # both endpoints validated like any written key (upstream's
        # clear_range raises key_too_large / key_outside_legal_range the
        # same way); ``\xff`` as the exclusive end is legal — it means
        # "to the end of the user keyspace"
        if len(begin) > self._knobs.KEY_SIZE_LIMIT \
                or len(end) > self._knobs.KEY_SIZE_LIMIT:
            raise KeyTooLarge()
        if end.startswith(b"\xff\xff"):
            raise KeyOutsideLegalRange()
        self._writes.clear_range(begin, end)
        self._write_conflicts.append((begin, end))

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes) -> None:
        self._check_mutable()
        self._check_key(key)
        self._writes.atomic(op, key, operand)
        self._write_conflicts.append((key, key_after(key)))

    # convenience named atomics (the C API's FDBMutationType surface)
    def add(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.ADD, key, operand)

    def bit_and(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.BIT_AND, key, operand)

    def bit_or(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.BIT_OR, key, operand)

    def bit_xor(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.BIT_XOR, key, operand)

    def max(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.MAX, key, operand)

    def min(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.MIN, key, operand)

    def byte_min(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.BYTE_MIN, key, operand)

    def byte_max(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.BYTE_MAX, key, operand)

    def append_if_fits(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.APPEND_IF_FITS, key, operand)

    def compare_and_clear(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(MutationType.COMPARE_AND_CLEAR, key, operand)

    def set_versionstamped_key(self, key: bytes, value: bytes) -> None:
        self.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY, key, value)

    def set_versionstamped_value(self, key: bytes, value: bytes) -> None:
        self.atomic_op(MutationType.SET_VERSIONSTAMPED_VALUE, key, value)

    # --- explicit conflict ranges ---

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        if begin < end:
            self._read_conflicts.append((begin, end))

    def add_read_conflict_key(self, key: bytes) -> None:
        self.add_read_conflict_range(key, key_after(key))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        if begin < end:
            self._write_conflicts.append((begin, end))

    def add_write_conflict_key(self, key: bytes) -> None:
        self.add_write_conflict_range(key, key_after(key))

    # --- layer commit hooks ---

    @property
    def write_map(self) -> WriteMap:
        """This transaction's buffered-write state, exposed read-only
        for commit hooks (layers/index.py walks written keys and
        cleared spans to derive index-row mutations)."""
        return self._writes

    def add_commit_hook(self, hook) -> None:
        """Register an async ``fn(tr)`` run at the start of every
        commit() attempt while the transaction still accepts reads and
        writes — the transactional secondary-index mode's atomicity
        point (layers/index.py is the canonical consumer).  Idempotent:
        re-adding the same callable is a no-op, so a hook installed
        inside a ``db.run`` body survives the retry loop without
        stacking."""
        if hook not in self._commit_hooks:
            self._commit_hooks.append(hook)

    async def get_prewrite_multi(self, keys: list[bytes],
                                 snapshot: bool = False
                                 ) -> list[bytes | None]:
        """The values of ``keys`` at this transaction's read version
        IGNORING buffered writes — the pre-transaction base a commit
        hook needs (RYW ``get`` would return the buffered value, hiding
        the derived rows that must be cleared).  Non-snapshot reads add
        per-key read conflicts, which is what makes hook-maintained
        derived state serializable: any concurrent writer of the same
        primary key conflicts here."""
        self._check_mutable()
        self._check_deadline()
        for k in keys:
            self._check_key(k)
        if not snapshot:
            for k in keys:
                self._read_conflicts.append((k, key_after(k)))
        version = await self.get_read_version()
        return list(await self._bounded(asyncio.gather(
            *(self._storage_read(k, version) for k in keys))))

    async def get_prewrite_range(self, begin: bytes, end: bytes,
                                 snapshot: bool = False
                                 ) -> list[tuple[bytes, bytes]]:
        """All rows of [begin, end) at the read version IGNORING
        buffered writes — what a commit hook scans to clear the derived
        rows of a buffered ``clear_range``.  Non-snapshot adds one read
        conflict over the whole range (a concurrent insert into the
        cleared span must conflict, or its derived row would leak)."""
        self._check_mutable()
        self._check_deadline()
        if not snapshot and begin < end:
            self._read_conflicts.append((begin, end))
        version = await self.get_read_version()
        out: list[tuple[bytes, bytes]] = []
        async for k, v in self._snapshot_stream(begin, end, version, False):
            out.append((bytes(k), bytes(v)))
        return out

    # --- watch ---

    async def watch(self, key: bytes) -> asyncio.Future:
        """Returns a future completing when key changes after commit
        (fdb_transaction_watch).  The watched baseline is the value at
        this txn's read version (snapshot; adds no conflict)."""
        value = await self.get(key, snapshot=True)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._watches_pending.append((key, value))
        self._watch_futures.append(fut)
        return fut

    # --- commit ---

    async def commit(self) -> Version:
        self._check_mutable()
        self._check_deadline()
        # layer commit hooks run while the txn is still mutable and only
        # when there is something to commit: a read-only txn derives
        # nothing, and hooking it would force a GRV onto the read-only
        # fast path below
        if self._commit_hooks and (self._writes or self._write_conflicts):
            for hook in list(self._commit_hooks):
                await hook(self)
        if not self._writes and not self._write_conflicts:
            # read-only txn commits trivially at its read version
            self._committed_version = self._read_version if self._read_version is not None else 0
            self._arm_watches(self._committed_version)
            if self._probe_id is not None:
                tb0 = getattr(self._cluster, "trace_batch", None)
                if tb0 is not None:
                    tb0.flush(self._probe_id, "read_only")
                _SPANS.event("CommitDebug", self._span,
                             "NativeAPI.commit.ReadOnly",
                             Version=self._committed_version)
                self._probe_id = None
                self._span = None
            return self._committed_version
        if self._writes.bytes > self._knobs.TRANSACTION_SIZE_LIMIT:
            raise TransactionTooLarge()
        read_snapshot = await self.get_read_version()
        tb = getattr(self._cluster, "trace_batch", None)
        if self._probe_id is not None and tb is not None:
            tb.event(self._probe_id, "commit_submit")
        req = CommitTransactionRequest(
            read_conflict_ranges=_coalesce(self._read_conflicts),
            write_conflict_ranges=_coalesce(self._write_conflicts),
            mutations=list(self._writes.mutations),
            read_snapshot=read_snapshot,
            lock_aware=self.lock_aware,
        )
        self._committing = True
        try:
            proxy = deterministic_random().choice(self._cluster.commit_proxies)
            with _hop(self._span, "CommitDebug", "NativeAPI.commit",
                      Mutations=len(req.mutations)) as h:
                # deadline-bounded: a commit cut off by the
                # transaction timeout surfaces transaction_timed_out —
                # like an unknown result, the commit MAY have landed;
                # on_error refuses to spin past the deadline either way
                result = await self._bounded(proxy.commit(req))
                _SPANS.event("CommitDebug", h, "NativeAPI.commit.After",
                             Version=result.version)
        except (RequestMaybeDelivered, _IoError):
            # the commit reached the proxy but its reply was lost — or a
            # server-side disk error surfaced AFTER the batch may have
            # landed on some logs (io_error is retryable for
            # idempotent ops, but a commit is not one): the outcome is
            # unknown and retrying blindly could double-commit
            if self._probe_id is not None and tb is not None:
                tb.event(self._probe_id, "commit_done")
                tb.flush(self._probe_id, "unknown_result")
                self._probe_id = None
            _SPANS.event("CommitDebug", self._span,
                         "NativeAPI.commit.UnknownResult")
            self._span = None
            raise CommitUnknownResult() from None
        except BaseException:
            if self._probe_id is not None and tb is not None:
                tb.event(self._probe_id, "commit_done")
                tb.flush(self._probe_id, "aborted")
                self._probe_id = None
            # no extra event: the _hop already paired the commit hop
            # with NativeAPI.commit.Error
            self._span = None
            raise
        finally:
            self._committing = False
        if self._probe_id is not None and tb is not None:
            tb.event(self._probe_id, "commit_done")
            tb.flush(self._probe_id, "committed")
            self._probe_id = None
        self._span = None
        self._committed_version = result.version
        self._versionstamp = result.versionstamp
        self._arm_watches(result.version)
        return result.version

    def _arm_watches(self, commit_version: Version) -> None:
        loop = asyncio.get_running_loop()
        for (key, value), fut in zip(self._watches_pending, self._watch_futures):
            ss = self._cluster.storage_for_key(key)

            async def run(ss=ss, key=key, value=value, fut=fut):
                try:
                    await ss.watch_value(key, value, commit_version)
                    if not fut.done():
                        fut.set_result(None)
                except Exception as e:
                    if not fut.done():
                        fut.set_exception(e)
            t = loop.create_task(run(), name="watch")
            fut.add_done_callback(lambda _f, t=t: None)  # keep task referenced
        self._watches_pending.clear()
        self._watch_futures.clear()

    def get_committed_version(self) -> Version:
        if self._committed_version is None:
            from ..runtime.errors import VersionInvalid
            raise VersionInvalid()
        return self._committed_version

    def get_versionstamp(self) -> bytes:
        if self._versionstamp is None:
            from ..runtime.errors import VersionInvalid
            raise VersionInvalid()
        return self._versionstamp

    # --- error handling / retry (REF: Transaction::onError) ---

    async def on_error(self, e: BaseException) -> None:
        # a NON-retryable error re-raises unchanged even past the
        # deadline: it carries a definite outcome (e.g. a too-large
        # commit provably never landed), and replacing it with
        # transaction_timed_out — which is maybe-committed — would
        # inflate a known result into ambiguity
        if not isinstance(e, FdbError) or not e.retryable:
            raise e
        # bounded failure (the C API trio): a transaction past
        # its deadline never RETRIES — the caller gets
        # transaction_timed_out now instead of an unbounded retry loop
        # against a degraded cluster
        rem = self._remaining() if self.timeout > 0 else None
        if rem is not None and rem <= 0:
            from ..runtime.errors import TransactionTimedOut
            raise TransactionTimedOut() from \
                (e if not isinstance(e, TransactionTimedOut) else None)
        self._retry_count += 1
        if self.retry_limit >= 0 and self._retry_count > self.retry_limit:
            raise e
        backoff = min(0.001 * (2 ** min(self._retry_count, 10)),
                      self.max_retry_delay)
        await asyncio.sleep(backoff * (0.5 + deterministic_random().random() * 0.5))
        retry_count = self._retry_count
        self.reset()
        self._retry_count = retry_count

    # --- helpers ---

    def _check_key(self, key: bytes) -> None:
        if len(key) > self._knobs.KEY_SIZE_LIMIT:
            raise KeyTooLarge()
        if key.startswith(b"\xff\xff"):
            # the special-key space is module-backed and never stored
            # (REF: keys at or above \xff\xff are outside the legal
            # range); writes here would be unreachable through get()
            raise KeyOutsideLegalRange()


def _coalesce(ranges: list[tuple[bytes, bytes]]) -> list[tuple[bytes, bytes]]:
    """Sort + merge overlapping conflict ranges (the reference coalesces in
    CommitTransactionRef::read_conflict_ranges construction)."""
    if not ranges:
        return []
    rs = sorted(ranges)
    out = [rs[0]]
    for b, e in rs[1:]:
        lb, le = out[-1]
        if b <= le:
            out[-1] = (lb, max(le, e))
        else:
            out.append((b, e))
    return out
