"""Secondary index maintenance — the canonical derived-state layer.

An index row is ``index_subspace.pack((ival, pkey)) -> b""`` where
``ival`` is one of the values the ``extractor(pkey, value)`` callback
derives from a primary row and ``pkey`` is the primary key itself — the
standard FDB index encoding (the tuple order makes ``lookup(ival)`` one
contiguous range read, and embedding ``pkey`` makes rows per-entry
unique so blind clears/sets are exact).

Two maintenance modes share the class:

**Transactional** (``LAYER_INDEX_TRANSACTIONAL``, the default): a
transaction commit hook (client/transaction.py ``add_commit_hook``)
translates the transaction's buffered primary-subspace writes into
index-row mutations inside the SAME commit.  The hook reads each
written key's pre-transaction value (``get_prewrite_multi`` — a
conflicted read, which is what serializes concurrent writers of the
same primary key against each other's index updates) to clear stale
rows, and scans buffered ``clear_range`` spans (``get_prewrite_range``)
to clear every covered row.  The index is never observably stale: rows
are bit-identical to a rebuild-from-scan at any pinned version.

**Async**: a feed sink applies mutations in version order against an
in-memory ``pkey -> ivals`` map (seeded by a one-time scan at start and
re-derivable from the index subspace itself on restart), flushing the
resulting index-row mutations in one transaction per cursor round.  The
layer exposes a **freshness frontier** — reads serve at-or-below it and
``lookup(..., at_least=V)`` falls back to a primary scan when the
frontier lags V.  After each flush the (frontier, flush commit version)
pair is a consistent **checkpoint**: the index subspace read at any
version in [commit, next flush) is exactly the rebuild-from-scan of the
primary at the frontier — the invariant the consistency checker pins.
"""

from __future__ import annotations

import asyncio

from ..client.subspace import Subspace
from ..client.writemap import WriteMap
from ..core.change_feed import WHOLE_DB_END
from ..core.data import MutationType, Version

__all__ = ["SecondaryIndex"]

# one flush transaction per chunk of this many index-row mutations: a
# cursor round folding a big backlog must not exceed the txn size limit
_FLUSH_CHUNK = 1000


def _default_extractor(key: bytes, value: bytes) -> list[bytes]:
    """Index primary rows by their full value (the simplest useful
    index: value -> keys holding it)."""
    return [value]


class SecondaryIndex:
    def __init__(self, db, index: Subspace, extractor=None,
                 primary_begin: bytes = b"",
                 primary_end: bytes = WHOLE_DB_END,
                 mode: str | None = None, name: str = "index",
                 consumer=None, knobs=None) -> None:
        self.db = db
        self.index = index
        self.extractor = extractor or _default_extractor
        self.primary_begin = primary_begin
        self.primary_end = primary_end
        self.knobs = knobs if knobs is not None else db.cluster.knobs
        if mode is None:
            mode = "transactional" if self.knobs.LAYER_INDEX_TRANSACTIONAL \
                else "async"
        if mode not in ("transactional", "async"):
            raise ValueError(f"unknown index mode {mode!r}")
        ib, ie = index.key(), index.range(())[1]
        if ib < primary_end and ie > primary_begin:
            # a self-feeding index would loop: its own rows re-enter the
            # maintenance path as primary mutations
            raise ValueError("index subspace overlaps the primary range")
        self.mode = mode
        self.name = name
        self.consumer = consumer
        # async-mode state
        self._map: dict[bytes, tuple] = {}      # pkey -> sorted ivals
        self._buffer: list[tuple] = []          # raw feed ops this round
        self._pending_ops: list[tuple] = []     # folded, not yet committed
        self._frontier: Version = 0             # applied-through version
        self._commit_version: Version = 0       # last flush's commit
        self._scan_version: Version = 0         # initial build's read version
        self._ready = False
        self._flushing = False
        # counters
        self.rows_set = 0
        self.rows_cleared = 0
        self.lookups = 0
        self.fallback_scans = 0
        self.resolve_fallbacks = 0
        self._msource = None

    # --- shared helpers ---

    def row_key(self, ival: bytes, pkey: bytes) -> bytes:
        return self.index.pack((ival, pkey))

    def _extract(self, key: bytes, value: bytes | None) -> set:
        if value is None:
            return set()
        return set(self.extractor(key, value))

    def _in_primary(self, key: bytes) -> bool:
        return self.primary_begin <= key < self.primary_end

    # --- transactional mode: the commit hook ---

    def install(self, tr) -> None:
        """Arm this index's commit hook on ``tr`` (idempotent)."""
        tr.add_commit_hook(self._commit_hook)

    async def run(self, fn):
        """``db.run`` with the hook armed on every attempt's txn."""
        async def body(tr):
            self.install(tr)
            return await fn(tr)
        return await self.db.run(body)

    async def _commit_hook(self, tr) -> None:
        wm = tr.write_map
        pb, pe = self.primary_begin, self.primary_end
        # buffered clear_range spans: every pre-txn row they cover loses
        # its index rows (the scan takes a read conflict over the span —
        # a concurrent insert into it must conflict or its row leaks)
        for cb, ce in wm.clears_in(pb, pe):
            for k, v in await tr.get_prewrite_range(cb, ce):
                for iv in sorted(self._extract(k, v)):
                    tr.clear(self.row_key(iv, k))
                    self.rows_cleared += 1
        written = wm.written_keys_in(pb, pe)
        need_old = [k for k in written if not wm.range_cleared(k)]
        olds = dict(zip(need_old, await tr.get_prewrite_multi(need_old))) \
            if need_old else {}
        for k in written:
            kind, payload = wm.lookup(k)
            old_v = olds.get(k)         # None: absent or range-cleared above
            new_v = WriteMap.fold_with_base(payload, old_v) \
                if kind == "stack" else payload
            old_ivals = self._extract(k, old_v)
            new_ivals = self._extract(k, new_v)
            for iv in sorted(old_ivals - new_ivals):
                tr.clear(self.row_key(iv, k))
                self.rows_cleared += 1
            for iv in sorted(new_ivals - old_ivals):
                tr.set(self.row_key(iv, k), b"")
                self.rows_set += 1

    # --- async mode: build + feed sink + flush ---

    async def start_async(self) -> None:
        """Register as a sink and build the initial map/rows by scanning
        the primary range.  The scan's read version may exceed the feed
        registration version; replaying the overlap through the map is
        convergent (old == new folds to a no-op), and the checkpoint is
        withheld until the frontier passes the scan version, so the
        checker never observes the catch-up window."""
        if self.mode != "async":
            raise ValueError("start_async on a transactional index")
        if self.consumer is None:
            raise ValueError("async index needs a LayerFeedConsumer")
        self.consumer.add_sink(self)
        page = self.knobs.LAYER_CHECK_PAGE_ROWS
        tr = self.db.create_transaction()
        scan_version = await tr.get_read_version()
        rows_buf: list[tuple[bytes, bytes]] = []
        cursor = self.primary_begin
        while True:
            rows = await tr.get_range(cursor, self.primary_end,
                                      limit=page, snapshot=True)
            for k, v in rows:
                ivals = sorted(self._extract(k, v))
                self._map[k] = tuple(ivals)
                rows_buf.extend((self.row_key(iv, k), b"") for iv in ivals)
            if len(rows) < page:
                break
            cursor = rows[-1][0] + b"\x00"
        tr.reset()
        for start in range(0, len(rows_buf), _FLUSH_CHUNK):
            chunk = [(rk, rv) for rk, rv in
                     rows_buf[start:start + _FLUSH_CHUNK]]
            self._commit_version = await self._commit_ops(chunk)
            self.rows_set += len(chunk)
        self._scan_version = scan_version
        self._ready = True

    async def _commit_ops(self, ops) -> Version:
        """Commit (row_key, b""|None) ops in one retried transaction and
        return the COMMIT VERSION (db.run returns fn's result, not the
        version — the checkpoint needs the version)."""
        tr = self.db.create_transaction()
        try:
            while True:
                try:
                    for rk, rv in ops:
                        if rv is None:
                            tr.clear(rk)
                        else:
                            tr.set(rk, rv)
                    return await tr.commit()
                except BaseException as e:
                    await tr.on_error(e)   # re-raises if not retryable
        finally:
            tr.reset()

    def on_mutations(self, version: Version, batch) -> None:
        # buffer raw ops; folding + flushing happens per cursor round in
        # on_frontier so one transaction carries the whole round
        for m in batch:
            t = int(m.type)
            if t == MutationType.CLEAR_RANGE:
                b = max(m.param1, self.primary_begin)
                e = min(m.param2, self.primary_end)
                if b < e:
                    self._buffer.append((t, b, e, version))
            elif self._in_primary(m.param1):
                self._buffer.append((t, m.param1, m.param2, version))

    async def on_frontier(self, frontier: Version) -> None:
        if self._buffer or self._pending_ops:
            # the checkpoint is withheld while a flush is in flight: a
            # multi-chunk flush commits incrementally, and a checker
            # reading between chunks would see a half-applied round
            self._flushing = True
            await self._flush(frontier)
        if self._ready and frontier >= self._scan_version:
            self._frontier = frontier
        self._flushing = False

    async def _flush(self, frontier: Version) -> None:
        """Fold this round's buffered ops and commit the row diffs.

        Failure-ordered for chaos: atomic operands are RESOLVED before
        any in-memory state changes (a resolution failure re-queues the
        untouched buffer and re-raises — the pull loop reconnects and a
        later round retries), the fold itself is synchronous (cannot
        fail mid-way), and folded-but-uncommitted ops persist in
        ``_pending_ops`` across a failed commit, with the checkpoint
        withheld (``_flushing``) until the drain completes."""
        # pass 1 (sync): which keys still carry an unresolved atomic
        # after this round's later sets/clears supersede earlier ops
        unresolved: dict[bytes, Version] = {}
        for t, p1, p2, v in self._buffer:
            if t == MutationType.SET_VALUE:
                unresolved.pop(p1, None)
            elif t == MutationType.CLEAR_RANGE:
                for k in [k for k in unresolved if p1 <= k < p2]:
                    del unresolved[k]
            else:
                # the feed carries the operand, not the folded value —
                # resolve by reading the key at the frontier below
                unresolved[p1] = v
        resolved: dict[bytes, bytes | None] = {}
        if unresolved:
            keys = sorted(unresolved)
            tr = self.db.create_transaction()
            try:
                tr.set_read_version(frontier)
                vals = await tr.get_multi(keys, snapshot=True)
            except Exception:  # noqa: BLE001 — frontier out of the MVCC
                # window (a long stall): read current instead; any
                # mutation between frontier and now is also in the feed
                # and will re-apply, so the map converges.  db.get rides
                # the full retry loop — a recovery mid-resolution waits
                # it out instead of losing the round.
                self.resolve_fallbacks += 1
                vals = await asyncio.gather(
                    *(self.db.get(k) for k in keys))
            finally:
                tr.reset()
            resolved = dict(zip(keys, vals))

        # pass 2 (sync, infallible): fold into the map, emit row diffs
        buffer, self._buffer = self._buffer, []
        ops = self._pending_ops

        def apply(k: bytes, new_ivals: set) -> None:
            old = set(self._map.get(k, ()))
            for iv in sorted(old - new_ivals):
                ops.append((self.row_key(iv, k), None))
                self.rows_cleared += 1
            for iv in sorted(new_ivals - old):
                ops.append((self.row_key(iv, k), b""))
                self.rows_set += 1
            if new_ivals:
                self._map[k] = tuple(sorted(new_ivals))
            else:
                self._map.pop(k, None)

        pending_atomics: set = set()
        for t, p1, p2, v in buffer:
            if t == MutationType.SET_VALUE:
                pending_atomics.discard(p1)
                apply(p1, self._extract(p1, p2))
            elif t == MutationType.CLEAR_RANGE:
                for k in [k for k in self._map if p1 <= k < p2]:
                    pending_atomics.discard(k)
                    apply(k, set())
            else:
                pending_atomics.add(p1)
        for k in sorted(pending_atomics):
            apply(k, self._extract(k, resolved.get(k)))

        # pass 3: drain; a failed chunk leaves the rest queued and the
        # checkpoint withheld — the next round resumes the drain
        while ops:
            chunk = ops[:_FLUSH_CHUNK]
            self._commit_version = await self._commit_ops(chunk)
            del ops[:len(chunk)]

    # --- read surface ---

    @property
    def frontier(self) -> Version:
        return self._frontier

    def checkpoint(self) -> tuple[Version, Version] | None:
        """(frontier, flush commit version) — None until the initial
        scan has been overtaken.  While no flush commits, the index
        subspace at any read version >= the commit version equals the
        rebuild-from-scan of the primary at the frontier."""
        if self.mode != "async" or not self._ready or self._flushing \
                or self._frontier < self._scan_version:
            return None
        return self._frontier, self._commit_version

    async def lookup(self, ival: bytes, at_least: Version | None = None
                     ) -> tuple[list[bytes], Version]:
        """Primary keys whose extracted values include ``ival``, plus
        the version the answer is fresh through.  Async mode serves the
        index subspace at its frontier — NEVER above it — and falls
        back to a primary scan when ``at_least`` outruns the frontier;
        transactional mode reads at the transaction's own version."""
        self.lookups += 1
        if self.mode == "async":
            ck = self.checkpoint()
            if ck is None or (at_least is not None and ck[0] < at_least):
                self.fallback_scans += 1
                return await self._scan_lookup(ival)
            frontier = ck[0]
            rows = await self.db.get_range(*self.index.range((ival,)))
            return [self.index.unpack(k)[1] for k, _ in rows], frontier
        tr = self.db.create_transaction()
        try:
            version = await tr.get_read_version()
            rows = await tr.get_range(*self.index.range((ival,)))
        finally:
            tr.reset()
        return [self.index.unpack(k)[1] for k, _ in rows], version

    async def _scan_lookup(self, ival: bytes
                           ) -> tuple[list[bytes], Version]:
        """The fallback: scan the primary range at a fresh read version
        and filter through the extractor."""
        page = self.knobs.LAYER_CHECK_PAGE_ROWS
        tr = self.db.create_transaction()
        try:
            version = await tr.get_read_version()
            out: list[bytes] = []
            cursor = self.primary_begin
            while True:
                rows = await tr.get_range(cursor, self.primary_end,
                                          limit=page, snapshot=True)
                for k, v in rows:
                    if ival in self._extract(k, v):
                        out.append(k)
                if len(rows) < page:
                    break
                cursor = rows[-1][0] + b"\x00"
        finally:
            tr.reset()
        return out, version

    # --- metrics / status surface ---

    def metrics_source(self):
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("LayerIndex", self.name)
            s.gauge("Mode", lambda: self.mode)
            s.gauge("FrontierVersion", lambda: self._frontier)
            s.gauge("RowsSet", lambda: self.rows_set)
            s.gauge("RowsCleared", lambda: self.rows_cleared)
            s.gauge("Lookups", lambda: self.lookups)
            s.gauge("FallbackScans", lambda: self.fallback_scans)
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        return {"kind": "index", "mode": self.mode,
                "frontier": self._frontier,
                "rows_set": self.rows_set,
                "rows_cleared": self.rows_cleared,
                "lookups": self.lookups,
                "fallback_scans": self.fallback_scans,
                "resolve_fallbacks": self.resolve_fallbacks}
