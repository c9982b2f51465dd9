"""API-correctness workloads: randomized ops vs. an exact model,
causal-consistency sideband checking, and invariant-sum bank transfers.

Reference: REF:fdbserver/workloads/ApiCorrectness.actor.cpp (random API
calls shadowed by an in-memory model store), Sideband.actor.cpp
(external-consistency: a commit announced out-of-band must be visible
to any later read version), and the DDBalance/bank-style invariant
workloads — the sum over a family of keys is conserved by every
transaction, so any snapshot that reads a different total caught a
non-serializable read.
"""

from __future__ import annotations

import asyncio
import bisect

from ..core.data import KeySelector, MutationType, apply_atomic
from ..runtime.errors import FdbError
from .workload import TestWorkload, register_workload


@register_workload
class ApiCorrectnessWorkload(TestWorkload):
    """Random set/clear/clear_range/atomics/get/get_range/get_key against
    a per-client key region, shadowed by an exact in-memory model.  Every
    read inside a transaction must match the model's merged (RYW) view;
    after quiescence the database region must equal the model exactly.
    Unknown commit results are settled with a per-transaction sentinel
    key, the reference workload's trick for keeping the model exact
    through commit_unknown_result."""

    name = "ApiCorrectness"

    MUTATIONS = ("set", "clear", "clear_range", "add", "byte_min",
                 "byte_max", "compare_and_clear")
    READS = ("get", "get_range", "get_key")

    def __init__(self, ctx):
        super().__init__(ctx)
        self.prefix = b"api/%02d/" % ctx.client_id
        self.keyspace = int(self.opt("keyCount", 32))
        self.txns = int(self.opt("transactionsPerClient", 25))
        self.ops_per_txn = int(self.opt("opsPerTransaction", 8))
        self.model: dict[bytes, bytes] = {}
        self.committed = 0
        self.reads_checked = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    def _rand_key(self) -> bytes:
        return self._key(self.rng.random_int(0, self.keyspace))

    def _rand_val(self) -> bytes:
        return b"v%016x" % self.rng.next_u64()

    def _gen_ops(self) -> list[tuple]:
        ops = []
        for _ in range(self.ops_per_txn):
            if self.rng.random() < 0.55:
                kind = self.MUTATIONS[self.rng.random_int(
                    0, len(self.MUTATIONS))]
            else:
                kind = self.READS[self.rng.random_int(0, len(self.READS))]
            if kind == "clear_range":
                a, b = sorted((self._rand_key(), self._rand_key()))
                ops.append((kind, a, b))
            elif kind == "get_range":
                a, b = sorted((self._rand_key(), self._rand_key()))
                ops.append((kind, a, b, self.rng.random_int(0, 10)))
            elif kind == "get_key":
                ops.append((kind, self._rand_key(),
                            self.rng.random() < 0.5,
                            self.rng.random_int(-3, 4)))
            elif kind in ("add", "byte_min", "byte_max",
                          "compare_and_clear"):
                ops.append((kind, self._rand_key(),
                            self.rng.next_u64().to_bytes(8, "little")))
            elif kind == "set":
                ops.append((kind, self._rand_key(), self._rand_val()))
            else:   # clear
                ops.append((kind, self._rand_key()))
        return ops

    async def _apply(self, tr, shadow: dict[bytes, bytes],
                     op: tuple) -> None:
        kind = op[0]
        if kind in self.MUTATIONS:
            self._mutate_model(shadow, op)
        if kind == "set":
            _, k, v = op
            tr.set(k, v)
        elif kind == "clear":
            _, k = op
            tr.clear(k)
        elif kind == "clear_range":
            _, a, b = op
            tr.clear_range(a, b)
        elif kind in ("add", "byte_min", "byte_max", "compare_and_clear"):
            _, k, operand = op
            tr.atomic_op(self._MT[kind], k, operand)
        elif kind == "get":
            _, k = op
            got = await tr.get(k)
            assert got == shadow.get(k), \
                f"get({k!r}) = {got!r}, model {shadow.get(k)!r}"
            self.reads_checked += 1
        elif kind == "get_range":
            _, a, b, limit = op
            got = [(bytes(k), bytes(v))
                   for k, v in await tr.get_range(a, b, limit=limit)]
            want = sorted((k, v) for k, v in shadow.items() if a <= k < b)
            if limit:
                want = want[:limit]
            assert got == want, \
                f"get_range({a!r},{b!r},{limit}) diverged from model"
            self.reads_checked += 1
        else:   # get_key
            _, anchor, or_equal, offset = op
            got = await tr.get_key(KeySelector(anchor, or_equal, offset))
            want = self._model_selector(shadow, anchor, or_equal, offset)
            if want is not None:
                assert got == want, (
                    f"get_key({anchor!r},{or_equal},{offset}) = {got!r}, "
                    f"model {want!r}")
                self.reads_checked += 1

    _MT = {"add": MutationType.ADD,
           "byte_min": MutationType.BYTE_MIN,
           "byte_max": MutationType.BYTE_MAX,
           "compare_and_clear": MutationType.COMPARE_AND_CLEAR}

    def _mutate_model(self, shadow: dict[bytes, bytes], op: tuple) -> None:
        """Apply a mutation op to the model only — also used to REPLAY a
        landed-but-unknown transaction's ops into the adopted shadow
        (the database applied them; a model that skips them diverges
        forever)."""
        kind = op[0]
        if kind == "set":
            _, k, v = op
            shadow[k] = v
        elif kind == "clear":
            _, k = op
            shadow.pop(k, None)
        elif kind == "clear_range":
            _, a, b = op
            for k in [k for k in shadow if a <= k < b]:
                del shadow[k]
        elif kind in self._MT:
            _, k, operand = op
            new = apply_atomic(self._MT[kind], shadow.get(k), operand)
            if new is None:
                shadow.pop(k, None)
            else:
                shadow[k] = new

    def _model_selector(self, shadow: dict[bytes, bytes], anchor: bytes,
                        or_equal: bool, offset: int) -> bytes | None:
        """Resolve the selector against the model, or None when the
        resolution steps outside this client's region (foreign keys
        would then decide the answer — unverifiable from here).  Mirrors
        Transaction.get_key's forward/backward split exactly."""
        from ..core.data import key_after
        keys = sorted(shadow)
        if offset > 0:
            start = key_after(anchor) if or_equal else anchor
            cands = keys[bisect.bisect_left(keys, start):]
            if len(cands) < offset:
                return None                      # runs past our region
            return cands[offset - 1]
        stop = key_after(anchor) if or_equal else anchor
        cands = keys[:bisect.bisect_left(keys, stop)]
        n = 1 - offset
        if len(cands) < n:
            return None                          # runs before our region
        return cands[-n]

    async def start(self) -> None:
        sentinel = self.prefix + b"~txn"         # sorts after data keys
        try:
            await self._run_txns(sentinel)
        finally:
            # only client 0's check() runs (tester convention), so every
            # client publishes its final model through the shared options
            self.ctx.options.setdefault("_api_models", {})[
                self.ctx.client_id] = (self.prefix, self.model)

    async def _run_txns(self, sentinel: bytes) -> None:
        for txn_id in range(self.txns):
            ops = self._gen_ops()
            marker = b"%d" % txn_id
            tr = self.db.create_transaction()
            while True:
                shadow = dict(self.model)
                shadow[sentinel] = marker
                try:
                    # settle INSIDE the transaction: reading the sentinel
                    # both detects an earlier unknown-result attempt that
                    # landed AND serializes against one still in flight —
                    # if that attempt commits after this read, this retry
                    # conflicts at the resolver instead of double-applying
                    # the non-idempotent atomics (the reference
                    # ApiCorrectness trick; a bare db.get() settle races
                    # the proxy's repair path)
                    if await tr.get(sentinel) == marker:
                        # the earlier attempt landed: the database holds
                        # its mutations, so the adopted shadow must too
                        for op in ops:
                            self._mutate_model(shadow, op)
                        self.model = shadow
                        self.committed += 1
                        break
                    tr.set(sentinel, marker)
                    for op in ops:
                        await self._apply(tr, shadow, op)
                    await tr.commit()
                    self.model = shadow
                    self.committed += 1
                    break
                except FdbError as e:
                    if e.maybe_committed:
                        tr = self.db.create_transaction()
                        continue
                    await tr.on_error(e)   # re-raises if not retryable

    async def check(self) -> bool:
        # every client's region must equal its final model (published by
        # each client at the end of start())
        if self.ctx.client_id != 0:
            return True
        models = self.ctx.options.setdefault("_api_models", {})
        assert len(models) == self.ctx.client_count, \
            f"only {len(models)}/{self.ctx.client_count} models published"
        for cid in range(self.ctx.client_count):
            prefix, model = models.get(cid, (None, None))
            if prefix is None:
                continue
            tr = self.db.create_transaction()
            while True:
                try:
                    rows = await tr.get_range(prefix, prefix + b"\xff",
                                              limit=0)
                    break
                except FdbError as e:
                    await tr.on_error(e)
            got = {bytes(k): bytes(v) for k, v in rows}
            assert got == model, (
                f"client {cid}: db has {len(got)} rows vs model "
                f"{len(model)} — divergent keys "
                f"{sorted(set(got) ^ set(model))[:5]}")
        return True

    def metrics(self):
        return {"committed": self.committed,
                "reads_checked": self.reads_checked}


@register_workload
class SidebandWorkload(TestWorkload):
    """External consistency: client 1 commits a key, then announces it
    over a side channel that bypasses the database.  Client 0, upon
    hearing the announcement, takes a FRESH read version — which must be
    >= the announced commit version and must see the key.  Any GRV that
    could run behind an already-acknowledged commit breaks strict
    serializability (REF:fdbserver/workloads/Sideband.actor.cpp)."""

    name = "Sideband"
    PREFIX = b"sideband/"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n = int(self.opt("messages", 20))
        self.checked = 0

    def _q(self) -> asyncio.Queue:
        q = self.ctx.options.get("_sideband_q")
        if q is None:
            q = self.ctx.options["_sideband_q"] = asyncio.Queue()
        return q

    async def start(self) -> None:
        if self.ctx.client_count < 2:
            return          # needs a producer and a checker
        q = self._q()
        if self.ctx.client_id == 1:
            for i in range(self.n):
                key, val = self.PREFIX + b"%06d" % i, b"m%d" % i
                committed_version = None
                while committed_version is None:
                    tr = self.db.create_transaction()
                    unknown = False
                    while True:
                        try:
                            tr.set(key, val)
                            await tr.commit()
                            committed_version = tr.get_committed_version()
                            break
                        except FdbError as e:
                            if e.maybe_committed:
                                unknown = True
                                break
                            await tr.on_error(e)
                    if unknown:
                        # settle before announcing: an announcement for a
                        # commit that never landed is a false alarm, not
                        # an external-consistency violation
                        if await self.db.get(key) == val:
                            committed_version = 0   # landed, version unknown
                await q.put((i, committed_version))
            await q.put(None)
        elif self.ctx.client_id == 0:
            while True:
                msg = await q.get()
                if msg is None:
                    return
                i, commit_version = msg
                tr = self.db.create_transaction()
                while True:
                    try:
                        rv = await tr.get_read_version()
                        got = await tr.get(self.PREFIX + b"%06d" % i)
                        break
                    except FdbError as e:
                        await tr.on_error(e)
                assert rv >= commit_version, (
                    f"GRV {rv} ran behind announced commit "
                    f"{commit_version}")
                assert got == b"m%d" % i, (
                    f"announced key {i} invisible at version {rv}")
                self.checked += 1

    def metrics(self):
        return {"causally_checked": self.checked}


@register_workload
class BankTransferWorkload(TestWorkload):
    """Contended read-modify-write transfers over a shared account pool:
    every transaction conserves the total, so a whole-pool scan inside
    one transaction must always read the exact initial sum, and no
    account may go negative.  High inter-client contention makes this a
    resolver workout; the mid-run scans make it a snapshot-isolation
    detector."""

    name = "BankTransfer"
    PREFIX = b"bank/"
    INITIAL = 100

    def __init__(self, ctx):
        super().__init__(ctx)
        self.accounts = int(self.opt("accounts", 12))
        self.txns = int(self.opt("transfersPerClient", 20))
        self.scan_every = int(self.opt("scanEvery", 5))
        self.transfers = 0
        self.scans = 0
        self.retries = 0

    def _key(self, i: int) -> bytes:
        return self.PREFIX + b"%04d" % i

    async def setup(self) -> None:
        if self.ctx.client_id != 0:
            return

        async def fill(tr):
            for i in range(self.accounts):
                tr.set(self._key(i), b"%d" % self.INITIAL)
        await self.db.run(fill)

    async def _scan_total(self) -> None:
        """Chunked whole-pool read inside ONE transaction (single read
        version): the sum must be exact."""
        tr = self.db.create_transaction()
        while True:
            try:
                total, count = 0, 0
                cursor = self.PREFIX
                while True:
                    rows = await tr.get_range(cursor, self.PREFIX + b"\xff",
                                              limit=5)
                    if not rows:
                        break
                    for k, v in rows:
                        total += int(v)
                        count += 1
                    cursor = bytes(rows[-1][0]) + b"\x00"
                break
            except FdbError as e:
                await tr.on_error(e)
        assert count == self.accounts, \
            f"scan saw {count} accounts, expected {self.accounts}"
        assert total == self.accounts * self.INITIAL, (
            f"sum {total} != conserved {self.accounts * self.INITIAL} — "
            f"non-serializable snapshot")
        self.scans += 1

    async def start(self) -> None:
        for t in range(self.txns):
            a = self.rng.random_int(0, self.accounts)
            b = self.rng.random_int(0, self.accounts)
            if a == b:
                b = (b + 1) % self.accounts
            amount = self.rng.random_int(1, 20)
            tr = self.db.create_transaction()
            while True:
                try:
                    va = int(await tr.get(self._key(a)))
                    vb = int(await tr.get(self._key(b)))
                    moved = min(amount, va)    # never go negative
                    tr.set(self._key(a), b"%d" % (va - moved))
                    tr.set(self._key(b), b"%d" % (vb + moved))
                    await tr.commit()
                    break
                except FdbError as e:
                    self.retries += 1
                    await tr.on_error(e)
            self.transfers += 1
            if (t + 1) % self.scan_every == 0:
                await self._scan_total()

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        await self._scan_total()
        rows = await self.db.get_range(self.PREFIX, self.PREFIX + b"\xff")
        assert all(int(v) >= 0 for _, v in rows), "negative balance"
        return True

    def metrics(self):
        return {"transfers": self.transfers, "scans": self.scans,
                "retries": self.retries}
