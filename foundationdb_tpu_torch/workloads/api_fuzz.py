"""API-semantics workloads: WriteDuringRead, FuzzApiCorrectness,
SelectorCorrectness, Storefront, SpecialKeySpaceCorrectness.

Reference: REF:fdbserver/workloads/{WriteDuringRead,FuzzApiCorrectness,
SelectorCorrectness,Storefront,SpecialKeySpaceCorrectness}.actor.cpp —
each fuzzes one API contract against a local model; all run under the
chaos mix like every other workload.
"""

from __future__ import annotations

import asyncio

from ..core.data import KeySelector
from ..runtime.errors import (ClientInvalidOperation, FdbError,
                              InvertedRange, KeyOutsideLegalRange,
                              KeyTooLarge, ValueTooLarge)
from .workload import TestWorkload, register_workload


@register_workload
class WriteDuringReadWorkload(TestWorkload):
    """Random interleavings of reads and writes INSIDE one transaction,
    checked against an in-txn RYW model: a read must always see this
    transaction's own writes layered over the initial snapshot
    (REF:fdbserver/workloads/WriteDuringRead.actor.cpp)."""

    name = "WriteDuringRead"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.rounds = int(self.opt("rounds", 10))
        self.ops = int(self.opt("opsPerRound", 30))
        self.nkeys = int(self.opt("keys", 12))
        self.checked = 0

    def _key(self, i: int) -> bytes:
        return b"wdr/%02d/%03d" % (self.ctx.client_id, i)

    async def start(self) -> None:
        for _ in range(self.rounds):
            tr = self.db.create_transaction()
            try:
                # snapshot baseline for the model
                base: dict[bytes, bytes | None] = {}
                for i in range(self.nkeys):
                    base[self._key(i)] = await tr.get(self._key(i))
                model = dict(base)
                for _ in range(self.ops):
                    i = self.rng.random_int(0, self.nkeys)
                    k = self._key(i)
                    op = self.rng.random_int(0, 4)
                    if op == 0:
                        v = b"v%d" % self.rng.random_int(0, 1_000_000)
                        tr.set(k, v)
                        model[k] = v
                    elif op == 1:
                        tr.clear(k)
                        model[k] = None
                    elif op == 2:
                        got = await tr.get(k)
                        assert got == model[k], \
                            f"RYW violated: {k} -> {got} != {model[k]}"
                        self.checked += 1
                    else:
                        lo = self.rng.random_int(0, self.nkeys)
                        hi = self.rng.random_int(lo, self.nkeys + 1)
                        rows = await tr.get_range(self._key(lo),
                                                  self._key(hi))
                        want = [(self._key(j), model[self._key(j)])
                                for j in range(lo, hi)
                                if model[self._key(j)] is not None]
                        assert rows == want, \
                            f"RYW range violated: {rows} != {want}"
                        self.checked += 1
                if self.rng.coinflip(0.7):
                    await tr.commit()
                tr.reset()
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    tr.reset()

    async def check(self) -> bool:
        return self.checked > 0

    def metrics(self):
        return {"ryw_checks": self.checked}


@register_workload
class FuzzApiCorrectnessWorkload(TestWorkload):
    """Random API calls with random (often invalid) arguments: every
    call must either behave or raise a TYPED FdbError — never crash,
    hang, or corrupt unrelated keys
    (REF:fdbserver/workloads/FuzzApiCorrectness.actor.cpp)."""

    name = "FuzzApiCorrectness"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.calls = int(self.opt("calls", 120))
        self.errors_seen = 0
        self.ok_calls = 0

    def _rand_key(self) -> bytes:
        n = self.rng.random_int(0, 40)
        choice = self.rng.random_int(0, 10)
        if choice == 0:
            return b""
        if choice == 1:
            return b"\xff" * self.rng.random_int(1, 4)
        if choice == 2:
            return b"\xff\xff/" + bytes(
                self.rng.random_int(97, 123) for _ in range(4))
        if choice == 3:
            return b"k" * 12000              # over KEY_SIZE_LIMIT
        return b"fuzz/" + bytes(self.rng.random_int(0, 256)
                                for _ in range(n))

    def _rand_mut_key(self) -> bytes:
        """Keys for MUTATIONS: either invalid (rejected with a typed
        error — that's the point) or scoped under fuzz/ — a committed
        random clear over the shared keyspace would destroy the other
        workloads' data (the reference's fuzzer scopes writes the same
        way)."""
        choice = self.rng.random_int(0, 10)
        if choice == 0:
            # special keyspace: rejected (ungated special-key write);
            # bare \xff system keys are deliberately NOT fuzzed — direct
            # system mutations are legal for management code and a
            # committed random one would corrupt the cluster config
            return b"\xff\xff/" + bytes(
                self.rng.random_int(97, 123) for _ in range(4))
        if choice == 1:
            return b"k" * 12000              # over KEY_SIZE_LIMIT
        return b"fuzz/" + bytes(self.rng.random_int(0, 256)
                                for _ in range(self.rng.random_int(0, 40)))

    async def start(self) -> None:
        sentinel = b"fuzzsentinel/%d" % self.ctx.client_id
        async def put_sentinel(tr):
            tr.set(sentinel, b"alive")
        await self.db.run(put_sentinel)
        tr = self.db.create_transaction()
        for _ in range(self.calls):
            op = self.rng.random_int(0, 7)
            try:
                if op == 0:
                    await tr.get(self._rand_key())
                elif op == 1:
                    tr.set(self._rand_mut_key(),
                           b"v" * self.rng.random_int(0, 64))
                elif op == 2:
                    tr.clear(self._rand_mut_key())
                elif op == 3:
                    a, b = self._rand_key(), self._rand_key()
                    await tr.get_range(a, b, limit=10)
                elif op == 4:
                    tr.clear_range(self._rand_mut_key(),
                                   self._rand_mut_key())
                elif op == 5:
                    await tr.get_key(KeySelector(
                        self._rand_key(), self.rng.coinflip(0.5),
                        self.rng.random_int(-3, 4)))
                else:
                    await tr.commit()
                    tr.reset()
                self.ok_calls += 1
            except (ClientInvalidOperation, KeyOutsideLegalRange,
                    KeyTooLarge, ValueTooLarge, InvertedRange):
                self.errors_seen += 1      # typed rejections are correct
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    tr.reset()

    async def check(self) -> bool:
        # the database survived the fuzz: unrelated data intact
        async def rd(tr):
            return await tr.get(b"fuzzsentinel/%d" % self.ctx.client_id)
        return (await self.db.run(rd)) == b"alive"

    def metrics(self):
        return {"fuzz_calls_ok": self.ok_calls,
                "fuzz_typed_errors": self.errors_seen}


@register_workload
class SelectorCorrectnessWorkload(TestWorkload):
    """KeySelector semantics vs a local model over a known key set
    (REF:fdbserver/workloads/SelectorCorrectness.actor.cpp)."""

    name = "SelectorCorrectness"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n = int(self.opt("keys", 20))
        self.probes = int(self.opt("probes", 60))
        self.checked = 0

    def _key(self, i: int) -> bytes:
        return b"sel/%03d" % i

    async def setup(self) -> None:
        async def do(tr):
            for i in range(self.n):
                tr.set(self._key(i), b"v%03d" % i)
        await self.db.run(do)

    async def start(self) -> None:
        keys = [self._key(i) for i in range(self.n)]
        tr = self.db.create_transaction()
        for _ in range(self.probes):
            i = self.rng.random_int(0, self.n)
            or_equal = self.rng.coinflip(0.5)
            offset = self.rng.random_int(-2, 3)
            sel = KeySelector(keys[i], or_equal, offset)
            # model: resolve against the sorted key list exactly like the
            # reference defines selectors (REF:fdbclient/NativeAPI
            # getKey): start from the first key > (>=) anchor, then step
            base = i + (1 if or_equal else 0) + (offset - 1)
            try:
                got = await tr.get_key(sel)
            except FdbError as e:
                try:
                    await tr.on_error(e)
                    continue
                except FdbError:
                    tr.reset()
                    continue
            if 0 <= base < self.n:
                want = keys[base]
                if got == want:
                    self.checked += 1
                else:
                    # another client's writes may sit between our keys;
                    # only same-prefix mismatches are real violations
                    assert not got.startswith(b"sel/"), \
                        f"selector {sel} -> {got}, want {want}"
            else:
                self.checked += 1   # out-of-set resolution: edge keys ok
        tr.reset()

    async def check(self) -> bool:
        return self.checked > 0

    def metrics(self):
        return {"selector_checks": self.checked}


@register_workload
class StorefrontWorkload(TestWorkload):
    """Multi-key order transactions: each order decrements item stock
    and records itself atomically; at check time stock + orders must
    reconcile exactly (REF:fdbserver/workloads/Storefront.actor.cpp)."""

    name = "Storefront"

    ITEMS = 8
    STOCK = 1_000_000

    def __init__(self, ctx):
        super().__init__(ctx)
        self.orders = int(self.opt("orders", 25))
        self.placed = 0

    def _stock_key(self, i: int) -> bytes:
        return b"store/stock/%02d" % i

    async def setup(self) -> None:
        async def do(tr):
            for i in range(self.ITEMS):
                tr.set(self._stock_key(i), str(self.STOCK).encode())
        await self.db.run(do)

    async def start(self) -> None:
        for n in range(self.orders):
            item = self.rng.random_int(0, self.ITEMS)
            qty = self.rng.random_int(1, 5)
            okey = b"store/order/%02d/%04d" % (self.ctx.client_id, n)

            async def do(tr, item=item, qty=qty, okey=okey):
                cur = int(await tr.get(self._stock_key(item)))
                if cur < qty:
                    return False
                tr.set(self._stock_key(item), str(cur - qty).encode())
                tr.set(okey, b"%d:%d" % (item, qty))
                return True
            if await self.db.run(do):
                self.placed += 1

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True

        async def do(tr):
            stock = await tr.get_range(b"store/stock/", b"store/stock0")
            orders = await tr.get_range(b"store/order/", b"store/order0")
            return stock, orders
        stock, orders = await self.db.run(do)
        sold = [0] * self.ITEMS
        for _k, v in orders:
            item, qty = v.split(b":")
            sold[int(item)] += int(qty)
        for i, (_k, v) in enumerate(sorted(stock)):
            assert int(v) + sold[i] == self.STOCK, \
                f"item {i}: stock {int(v)} + sold {sold[i]} != {self.STOCK}"
        return True

    def metrics(self):
        return {"orders_placed": self.placed}


@register_workload
class SpecialKeySpaceCorrectnessWorkload(TestWorkload):
    """The \\xff\\xff module registry under load: module reads,
    cross-module ranges, write gating, exclusion round-trip
    (REF:fdbserver/workloads/SpecialKeySpaceCorrectness.actor.cpp)."""

    name = "SpecialKeySpaceCorrectness"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.rounds = int(self.opt("rounds", 5))
        self.checks = 0

    async def start(self) -> None:
        from ..client.special_keys import ExcludedServersModule
        pfx = ExcludedServersModule.prefix
        addr = b"198.51.100.%d:4500" % self.ctx.client_id
        for _ in range(self.rounds):
            tr = self.db.create_transaction()
            try:
                # write gating: without the option, writes refuse and
                # the reason is readable at error_message
                try:
                    tr.set(pfx + addr, b"1")
                    raise AssertionError("ungated special-key write")
                except ClientInvalidOperation:
                    pass
                msg = await tr.get(b"\xff\xff/error_message")
                assert msg and b"SPECIAL_KEY_SPACE" in msg
                # exclusion round-trip through one txn
                tr.reset()
                tr.special_key_space_enable_writes = True
                tr.set(pfx + addr, b"1")
                await tr.commit()
                tr.reset()
                got = await tr.get(pfx + addr)
                assert got == b"1", f"exclusion not visible: {got}"
                # cross-module range read stays sorted and prefixed
                rows = await tr.get_range(b"\xff\xff/", b"\xff\xff0")
                keys = [k for k, _ in rows]
                assert keys == sorted(keys)
                assert all(k.startswith(b"\xff\xff") for k in keys)
                # clean up (include) for the next round
                tr.reset()
                tr.special_key_space_enable_writes = True
                tr.clear(pfx + addr)
                await tr.commit()
                tr.reset()
                self.checks += 1
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    tr.reset()

    async def check(self) -> bool:
        return self.checks > 0

    def metrics(self):
        return {"skx_rounds": self.checks}
