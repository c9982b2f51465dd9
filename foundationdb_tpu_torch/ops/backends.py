"""Resolver conflict-backend registry — the RESOLVER_CONFLICT_BACKEND knob.

The resolver role (core/resolver.py) picks its ConflictSet implementation
here, exactly as Resolver.actor.cpp would consult a server knob
(SURVEY.md §5.6, BASELINE.json north_star):

    cpp    — C++ interval-version map, exact byte keys (CPU baseline)
    numpy  — encoded-lane NumPy twin (deterministic; what simulation uses)
    cuda   — encoded-lane hand kernels with persistent device state
             (ops/conflict_torch.py); the counterpart of the JAX
             package's ``tpu`` kind

All backends share one semantic contract, tested against the brute-force
oracle.  The encoded backends are *conservative*: a verdict may flip
COMMITTED→CONFLICT (extra retry, safe) but never the reverse.

Shape discipline for the encoded backends:
- batches larger than B txns are chunked; chunks share the batch's commit
  version, which preserves intra-batch semantics exactly (later chunks see
  earlier chunks' writes in history at the same version);
- transactions with more than R conflict ranges get their ranges
  *coalesced* (adjacent ranges merged into covering ranges) — a
  conservative widening that keeps shapes static instead of falling off
  the device path.
"""

from __future__ import annotations

import asyncio
import queue
import threading

import numpy as np

from ..runtime.knobs import Knobs
from .batch import TxnRequest


async def _completed(value):
    return value


# NOTE on device->host sync cost: verdict copies are issued eagerly at
# dispatch time (conflict_torch._Readback, inside every
# resolve_*_submit — the single home of the policy), so the sync below
# only waits on a copy already in flight.


class _DeviceSyncWorker:
    """One daemon thread that performs blocking device→host syncs so the
    event loop never waits on the device.  A *daemon* thread rather than a
    ThreadPoolExecutor: executor threads are non-daemon and joined at
    interpreter exit, so one sync wedged on a dead device tunnel would hang
    process shutdown forever.  A single shared worker also serializes all
    device syncs."""

    _instance: "_DeviceSyncWorker | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="resolver-device-sync")
        self._t.start()

    @classmethod
    def shared(cls) -> "_DeviceSyncWorker":
        with cls._instance_lock:
            if cls._instance is None or not cls._instance._t.is_alive():
                cls._instance = cls()
            return cls._instance

    def _run(self) -> None:
        while True:
            loop, fut, fn, arg = self._q.get()
            try:
                result, err = fn(arg), None
            except BaseException as e:  # noqa: BLE001 — relayed to the future
                result, err = None, e
            try:
                loop.call_soon_threadsafe(self._finish, fut, result, err)
            except RuntimeError:
                pass    # loop already closed; nothing to deliver to

    @staticmethod
    def _finish(fut: asyncio.Future, result, err) -> None:
        if fut.cancelled():
            return
        if err is None:
            fut.set_result(result)
        else:
            fut.set_exception(err)

    async def run(self, fn, arg):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._q.put((loop, fut, fn, arg))
        return await fut


def resolve_begin(backend, txns: list[TxnRequest], commit_version: int):
    """Split-phase resolve over any backend: submit now, sync later.

    Returns an awaitable yielding the verdict list.  Backends with a
    ``resolve_begin`` method (the encoded device path) pipeline: device state
    is updated at submit time, so the caller may hand the version chain to
    the next batch before awaiting verdicts.  Plain CPU backends resolve
    synchronously and return a pre-completed awaitable."""
    begin = getattr(backend, "resolve_begin", None)
    if begin is not None:
        return begin(txns, commit_version)
    return _completed(backend.resolve(txns, commit_version))


def resolve_group_begin(backend, batches: list[list[TxnRequest]],
                        versions: list[int]):
    """Group-resolve over any backend: fused dispatches when supported,
    sequential sync resolves otherwise.  Awaitable of per-batch verdicts."""
    fn = getattr(backend, "resolve_group_begin", None)
    if fn is not None:
        return fn(batches, versions)
    return _completed([backend.resolve(t, v)
                       for t, v in zip(batches, versions)])


def resolve_group_wire_begin(backend, wires: list, versions: list[int]):
    """Group-resolve serialized WireBatches over any backend.  The
    encoded device backend takes its zero-walk dictionary path; a backend
    with resolve_wire (cpp) consumes the wire form directly; anything
    else deserializes and falls back to the TxnRequest group path."""
    fn = getattr(backend, "resolve_group_wire_begin", None)
    if fn is not None and getattr(backend, "_dict", None) is not None:
        return fn(wires, versions)
    rw = getattr(backend, "resolve_wire", None)
    if rw is not None:
        return _completed([rw(w, v) for w, v in zip(wires, versions)])
    from .batch import txns_from_wire
    return resolve_group_begin(backend, [txns_from_wire(w) for w in wires],
                               versions)


def coalesce_ranges(ranges: list[tuple[bytes, bytes]], max_n: int) -> list[tuple[bytes, bytes]]:
    """Merge sorted-adjacent ranges until len <= max_n (conservative)."""
    if len(ranges) <= max_n:
        return ranges
    rs = sorted(ranges)
    while len(rs) > max_n:
        merged = []
        i = 0
        while i < len(rs):
            if len(rs) - i + len(merged) > max_n and i + 1 < len(rs):
                a, b = rs[i], rs[i + 1]
                merged.append((a[0], max(a[1], b[1])))
                i += 2
            else:
                merged.append(rs[i])
                i += 1
        rs = merged
    return rs


class EncodedConflictBackend:
    """Wraps a lane-encoded conflict set (numpy or torch) behind the
    byte-string TxnRequest interface."""

    def __init__(self, conflict_set, batch_txns: int, ranges_per_txn: int,
                 width: int, dict_encoder=None,
                 exact_window: int = 5_000_000, group_bucket: int = 0):
        self.cs = conflict_set
        self.B = batch_txns
        self.R = ranges_per_txn
        self.width = width
        self._dict = dict_encoder       # DictEncoder when transfer-compressed
        # group dispatches that went through the dictionary, and groups
        # whose dictionary encode overflowed into the lanes path
        self.dict_dispatches = 0
        self.dict_fallbacks = 0
        self._exact_window = exact_window
        # pin group dispatches to one compiled K bucket (see the
        # RESOLVER_GROUP_BUCKET knob); groups larger than the pin use the
        # native buckets as before
        self._group_bucket = group_bucket
        # exact sidecar for FAT txns (more ranges than the kernel bucket):
        # coalescing them measured ~5x abort inflation on range-heavy
        # shapes (bench/abort_parity.py), so they are checked exactly
        # instead — lazily created on the first fat txn.  The sidecar is
        # only TRUSTED for snapshots >= _exact_since: it has seen every
        # committed write from that version on (it is created mid-stream
        # and wire-path resolves bypass it, so older history is
        # incomplete — a fat txn with an older snapshot falls back to
        # conservative coalescing instead of risking a missed conflict)
        self._exact = None
        self._exact_failed = False
        self._exact_since: int | None = None
        # device→host verdict readback accounting: bytes the
        # host actually synced and txns those syncs covered.  A
        # PackedVerdicts handle (the RESOLVER_VERDICT_BITMASK reduction)
        # records what its conditional two-stage sync moved in
        # ``synced_bytes``; raw arrays count their full nbytes.  The
        # devplane perf gate reads bytes/txn off these.
        self.readback_bytes = 0
        self.readback_txns = 0

    def _count_readback(self, v, host: np.ndarray, txns: int) -> None:
        synced = getattr(v, "synced_bytes", None)
        self.readback_bytes += host.nbytes if synced is None else synced
        self.readback_txns += txns

    def _fat(self, t: TxnRequest) -> bool:
        return len(t.read_ranges) > self.R or len(t.write_ranges) > self.R

    def _k_bucket(self, n: int) -> int:
        """Compiled K bucket for an n-chunk group, honoring the pin."""
        from .conflict_torch import GROUP_BUCKETS
        want = max(n, min(self._group_bucket, GROUP_BUCKETS[-1]))
        return next(b for b in GROUP_BUCKETS if b >= want)

    def _exact_sidecar(self):
        if self._exact is None and not self._exact_failed:
            try:
                from .conflict_cpp import CppConflictSet
                self._exact = CppConflictSet()
            except Exception:  # noqa: BLE001 — no native lib: coalesce
                self._exact_failed = True
        return self._exact

    def _prepare(self, txns: list[TxnRequest],
                 commit_version: int) -> tuple[list[TxnRequest], dict]:
        """Hybrid fat-txn routing (the abort-parity gate): a txn with
        more conflict ranges than the kernel bucket R is resolved
        EXACTLY against a C++ interval-map sidecar instead of having
        its ranges coalesced.  Returns (kernel-shaped txns, {txn index:
        final verdict} for the fat ones).

        The sidecar sees every txn in commit order: slim txns contribute
        their exact writes UNCONDITIONALLY (reads dropped, snapshot
        pinned at the commit version so they always insert — counting a
        kernel-aborted slim txn's writes only over-approximates history,
        which can only flip a fat verdict COMMITTED→CONFLICT: safe);
        fat txns are checked with their exact reads and insert their
        exact writes iff the sidecar commits them.  The kernel still
        carries each fat txn's coalesced WRITES (later kernel checks
        must see them — widened: safe) but no reads (its verdict is the
        sidecar's, not the kernel's).  Without the native lib the old
        conservative coalescing applies to reads too."""
        fat_idx = [i for i, t in enumerate(txns) if self._fat(t)]
        if not fat_idx and self._exact is None:
            return txns, {}     # pure-slim workload: zero sidecar cost
        side = self._exact_sidecar()
        if side is not None and self._exact_since is None:
            self._exact_since = commit_version
        # a fat txn rides the sidecar only when the sidecar's history
        # covers everything its check needs: every write in
        # (snapshot, commit_version] must have been fed, i.e. snapshot
        # >= _exact_since.  Older snapshots (including the creation
        # batch's own fat txns) coalesce conservatively.
        routable = set() if side is None else \
            {i for i in fat_idx
             if txns[i].read_snapshot >= self._exact_since}
        if side is not None:
            # feed EVERY batch: slim txns contribute exact writes
            # unconditionally; routable fat txns check exact reads
            shadow = [t if i in routable
                      else TxnRequest([], t.write_ranges, commit_version)
                      for i, t in enumerate(txns)]
            side.set_oldest_version(
                max(side.oldest_version,
                    commit_version - self._exact_window))
            verdicts = side.resolve_batch(shadow, commit_version)
            fat_map = {i: int(verdicts[i]) for i in routable}
        else:
            fat_map = {}
        fat = set(fat_idx)
        kernel_txns = [
            t if i not in fat else
            (TxnRequest([], coalesce_ranges(t.write_ranges, self.R),
                        t.read_snapshot) if i in routable else
             TxnRequest(coalesce_ranges(t.read_ranges, self.R),
                        coalesce_ranges(t.write_ranges, self.R),
                        t.read_snapshot))
            for i, t in enumerate(txns)]
        return kernel_txns, fat_map

    def _invalidate_sidecar(self, version: int) -> None:
        """Wire-path resolves bypass the sidecar: its history is
        incomplete from ``version`` on, so fat routing re-arms only for
        snapshots at or above it."""
        if self._exact is not None and self._exact_since is not None:
            self._exact_since = max(self._exact_since, version)

    def _chunk_txns(self, txns: list[TxnRequest]) -> list[list[TxnRequest]]:
        """Split a PREPARED (kernel-shaped) batch into B-txn chunks."""
        return [txns[start:start + self.B]
                for start in range(0, len(txns), self.B)]

    def _submit_chunks(self, txns: list[TxnRequest], commit_version: int):
        """Prepare + encode + dispatch every chunk; returns
        ([(n_txns, verdicts)], fat_map) where verdicts is a readback
        handle (torch cs) or host ndarray (numpy cs) and fat_map carries the
        exact-path verdict overrides.  Multi-chunk batches go through
        the fused group dispatch when the conflict set supports it (one
        device round trip instead of K)."""
        from .batch import encode_batch
        ktxns, fat_map = self._prepare(txns, commit_version)
        ebs = [encode_batch(c, self.B, self.R, self.width)
               for c in self._chunk_txns(ktxns)]
        group = getattr(self.cs, "resolve_group_submit", None)
        if group is not None and len(ebs) > 1:
            # counts as a list marks a grouped [K,B] verdict array
            return [([e.count for e in ebs],
                     group(ebs, [commit_version] * len(ebs)))], fat_map
        submit = getattr(self.cs, "resolve_encoded_submit", self.cs.resolve_encoded)
        return [(eb.count, submit(eb, commit_version))
                for eb in ebs], fat_map

    @staticmethod
    def _extract(n, host: np.ndarray) -> list[int]:
        if isinstance(n, list):            # grouped [K,B] rows
            return [int(x) for k, cnt in enumerate(n) for x in host[k][:cnt]]
        return [int(x) for x in host[:n]]

    def resolve(self, txns: list[TxnRequest], commit_version: int) -> list[int]:
        pending, fat_map = self._submit_chunks(txns, commit_version)
        out: list[int] = []
        for n, v in pending:
            host = np.asarray(v)
            self._count_readback(v, host, sum(n) if isinstance(n, list) else n)
            out.extend(self._extract(n, host))
        for i, code in fat_map.items():
            out[i] = code
        return out

    def resolve_begin(self, txns: list[TxnRequest], commit_version: int):
        """Submit the whole batch to the conflict set now (state is updated
        before this returns) and hand back an awaitable that syncs the
        verdicts.  On a real event loop the sync runs in a dedicated
        single thread so device waits never block the loop; under the
        virtual-time simulator (where executors are forbidden and the
        backend is CPU-deterministic anyway) it syncs inline."""
        pending, fat_map = self._submit_chunks(txns, commit_version)

        async def finish() -> list[int]:
            from ..runtime.simloop import SimEventLoop
            loop = asyncio.get_running_loop()
            out: list[int] = []
            for n, v in pending:
                if isinstance(v, np.ndarray) or isinstance(loop, SimEventLoop):
                    # Already host data (numpy backend), or under the
                    # virtual-time simulator where threads are forbidden
                    # and the device is host CPU anyway: sync inline.
                    host = np.asarray(v)
                else:
                    host = await _DeviceSyncWorker.shared().run(np.asarray, v)
                self._count_readback(v, host,
                                     sum(n) if isinstance(n, list) else n)
                out.extend(self._extract(n, host))
            for i, code in fat_map.items():
                out[i] = code
            return out

        return finish()

    def resolve_group_begin(self, batches: list[list[TxnRequest]],
                            versions: list[int]):
        """Fuse several distinct proxy batches (each with its own commit
        version) into as few device dispatches as possible; returns an
        awaitable yielding one verdict list per input batch.  Bit-identical
        to sequential resolve_begin calls — the fused kernel threads the
        ring through the group in order.

        Encode + dispatch happen EAGERLY on the calling task, exactly like
        ``resolve_begin`` (submit now, sync later): a returned-but-unawaited
        coroutine never runs, so deferring the dispatch into the awaitable
        silently serialized every caller that queued groups before awaiting
        them — the device sat idle while groups waited their turn to even
        be submitted.  Eager dispatch also makes device order = call order
        by construction (no turnstile needed)."""
        group = getattr(self.cs, "resolve_group_submit", None)
        if group is None:
            results = [self.resolve(txns, v)
                       for txns, v in zip(batches, versions)]

            async def done():
                return results
            return done()

        from .batch import encode_batch
        from .conflict_torch import GROUP_BUCKETS
        max_k = GROUP_BUCKETS[-1]
        chunks: list[list[TxnRequest]] = []
        flat_cvs: list[int] = []
        spans: list[tuple[int, int]] = []   # (start, n_chunks) per batch
        fat_maps: list[dict] = []           # exact-path overrides per batch
        for txns, v in zip(batches, versions):
            ktxns, fmap = self._prepare(txns, v)
            fat_maps.append(fmap)
            cs_ = self._chunk_txns(ktxns)
            spans.append((len(chunks), len(cs_)))
            chunks.extend(cs_)
            flat_cvs.extend([v] * len(cs_))
        counts = [len(c) for c in chunks]
        use_dict = self._dict is not None \
            and hasattr(self.cs, "resolve_group_submit_ids")
        pending = []                        # (n_chunks, verdict handle)
        for start in range(0, len(chunks), max_k):
            sub = chunks[start:start + max_k]
            subv = flat_cvs[start:start + max_k]
            if use_dict:
                d = self._dict
                from .conflict_torch import UPD_BUCKETS
                K = self._k_bucket(len(sub))
                enc = d.encode_group(sub, self.B, self.R, K)
                if enc is not None and d.n_upd <= UPD_BUCKETS[-1]:
                    ids, snaps, _counts, compact = enc
                    self.dict_dispatches += 1
                    pending.append((len(sub), self.cs.resolve_group_submit_ids(
                        ids, snaps, (K, self.B, self.R), subv,
                        d.upd_slots, d.upd_lanes, d.n_upd, compact)))
                    continue
                # update-buffer (or bucket) overflow: the inserted
                # endpoints are real table state — ship them, then
                # lanes-path this sub-group
                self.dict_fallbacks += 1
                self.cs.apply_dict_updates(d.upd_slots, d.upd_lanes, d.n_upd)
            ebs = [encode_batch(c, self.B, self.R, self.width) for c in sub]
            pending.append((len(sub),
                            group(ebs, subv, k_pad=self._k_bucket(len(sub)))))

        async def finish() -> list[list[int]]:
            from ..runtime.simloop import SimEventLoop
            loop = asyncio.get_running_loop()
            sim = isinstance(loop, SimEventLoop)
            rows = []
            ci = 0
            for dn, v in pending:
                if sim:
                    host = np.asarray(v)
                else:
                    host = await _DeviceSyncWorker.shared().run(np.asarray, v)
                self._count_readback(v, host, sum(counts[ci:ci + dn]))
                ci += dn
                rows.extend(host[i] for i in range(dn))
            out = []
            for bi, (start, n_chunks) in enumerate(spans):
                verdicts: list[int] = []
                for c in range(n_chunks):
                    verdicts.extend(int(x)
                                    for x in rows[start + c][:counts[start + c]])
                for i, code in fat_maps[bi].items():
                    verdicts[i] = code
                out.append(verdicts)
            return out

        return finish()

    def resolve_group_wire_begin(self, wires: list, versions: list[int]):
        """Group resolve over serialized WireBatches (dictionary path):
        no Python txn walk — ONE native group-encoder call assembles ids,
        snapshots and versions into a single fused buffer, shipped in a
        single upload per sub-group.  Requires the dict encoder; callers
        fall back to resolve_group_begin on TxnRequests otherwise."""
        if self._dict is None \
                or not hasattr(self.cs, "resolve_group_submit_fused"):
            raise ValueError("the wire path needs the endpoint dictionary")
        # wire batches bypass the exact sidecar: fat routing must re-arm
        self._invalidate_sidecar(max(versions) if versions else 0)
        from .conflict_torch import FUSED_UPD_BUCKETS, GROUP_BUCKETS
        max_k = GROUP_BUCKETS[-1]
        d = self._dict
        pending = []                        # (counts, verdict handle)
        for start in range(0, len(wires), max_k):
            sub = wires[start:start + max_k]
            subv = versions[start:start + max_k]
            K = self._k_bucket(len(sub))
            self.dict_dispatches += 1
            enc = d.encode_group_fused(sub, self.B, self.R, K, subv)
            if enc is None:
                # buffer overflow can't happen with a worst-case-sized
                # buffer; the partial insertions are real regardless
                self.cs.apply_dict_updates(d.upd_slots, d.upd_lanes, d.n_upd)
                raise ValueError("update buffer overflow on wire path")
            fused, counts, compact, off_pi, n_upd = enc
            # the fused buffer's update region is sized to min(max_upd,
            # largest bucket); a bucket past that capacity must ship
            # out-of-band instead of overrunning
            u_cap = min(d.max_upd, FUSED_UPD_BUCKETS[-1])
            U = next((b for b in FUSED_UPD_BUCKETS if b >= n_upd), None)
            if U is None or U > u_cap:
                self.cs.apply_dict_updates(d.upd_slots, d.upd_lanes, n_upd)
                U = 0
            total = d.pack_updates_into(fused, off_pi, K, self.B, U)
            pending.append((counts, self.cs.resolve_group_submit_fused(
                fused[:total], (K, self.B, self.R), compact, U, subv)))

        async def finish() -> list[list[int]]:
            from ..runtime.simloop import SimEventLoop
            loop = asyncio.get_running_loop()
            sim = isinstance(loop, SimEventLoop)
            out = []
            for counts, v in pending:
                if sim:
                    host = np.asarray(v)
                else:
                    host = await _DeviceSyncWorker.shared().run(np.asarray, v)
                self._count_readback(v, host, sum(counts))
                for k, cnt in enumerate(counts):
                    out.append(host[k][:cnt].tolist())
            return out

        return finish()

    def reset_ring(self, oldest_version: int = 0) -> bool:
        """Clear conflict history (fresh-backend verdict semantics) while
        keeping the transfer dictionary warm; False if unsupported."""
        fn = getattr(self.cs, "reset_ring", None)
        if fn is None:
            return False
        fn(oldest_version)
        # fresh-backend semantics include the exact sidecar: stale fat
        # history must not outlive the ring
        self._exact = None
        self._exact_since = None
        return True

    def set_oldest_version(self, v: int) -> None:
        self.cs.set_oldest_version(v)
        if self._exact is not None:
            self._exact.set_oldest_version(v)

    @property
    def oldest_version(self) -> int:
        return self.cs.oldest_version


def make_conflict_backend(knobs: Knobs, device=None):
    """Instantiate the backend the RESOLVER_CONFLICT_BACKEND knob names.
    For ``cuda`` a ``device`` of None means the CUDA card, and without
    one this raises: the CPU runs only when asked for."""
    kind = knobs.RESOLVER_CONFLICT_BACKEND
    if kind == "cpp":
        from .conflict_cpp import CppConflictSet
        return CppConflictSet()
    dict_encoder = None
    if kind == "numpy":
        from .conflict_np import NumpyConflictSet
        cs = NumpyConflictSet(knobs.CONFLICT_RING_CAPACITY, knobs.KEY_ENCODE_BYTES)
    elif kind == "cuda":
        from .conflict_torch import GROUP_BUCKETS, TorchConflictSet
        dict_slots = knobs.CONFLICT_DICT_SLOTS
        # the allocator must always find an unstamped slot: require room
        # for two full worst-case dispatch groups, else ship lanes
        if dict_slots and dict_slots < 8 * knobs.RESOLVER_RANGES_PER_TXN \
                * knobs.RESOLVER_BATCH_TXNS * 64:
            dict_slots = 0
        cs = TorchConflictSet(knobs.CONFLICT_RING_CAPACITY,
                              knobs.KEY_ENCODE_BYTES, device=device,
                              window=knobs.CONFLICT_WINDOW_SLOTS,
                              dict_slots=dict_slots,
                              ring_inplace=knobs.RESOLVER_RING_INPLACE,
                              pack_verdicts=knobs.RESOLVER_VERDICT_BITMASK)
        if dict_slots:
            from .batch import DictEncoder
            # update buffer sized to one dispatch's worst case (every
            # endpoint of every range new): overflow is impossible and
            # the lanes fallback exists anyway.  A codec that does not
            # build raises here.
            dict_encoder = DictEncoder(
                dict_slots, knobs.KEY_ENCODE_BYTES,
                max_upd=4 * knobs.RESOLVER_RANGES_PER_TXN
                * knobs.RESOLVER_BATCH_TXNS * GROUP_BUCKETS[-1],
                take=cs.staging.take)
    else:
        raise ValueError(f"unknown RESOLVER_CONFLICT_BACKEND {kind!r}")
    return EncodedConflictBackend(
        cs, knobs.RESOLVER_BATCH_TXNS,
        knobs.RESOLVER_RANGES_PER_TXN,
        knobs.KEY_ENCODE_BYTES,
        dict_encoder=dict_encoder,
        group_bucket=knobs.RESOLVER_GROUP_BUCKET,
        # the sidecar's self-imposed floor must track the TXN-LIFE window
        # (the same floor the resolver applies to the whole backend) —
        # never the storage MVCC window: a smaller floor than the
        # kernel's TooOld-s fat txns whose snapshots are perfectly
        # admissible, which livelocks any fat-txn retry loop whose GRV
        # lags by more than the window
        exact_window=knobs.MAX_WRITE_TRANSACTION_LIFE_VERSIONS)
