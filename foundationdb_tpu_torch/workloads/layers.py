"""Layer-ecosystem drivers: the zipf read tier + index churn.

Two workloads exercise the layers package under the sim's fault mix:

- ``LayerReadTier`` — the millions-of-users shape: zipf-skewed point
  reads through a :class:`~..layers.cache.ReadThroughCache`, with a
  configurable writer fraction committing invalidating updates.  The
  check phase asserts the cache never went stale past the feed frontier
  (every workload-observed value is re-verified against a pinned read).
- ``LayerIndexChurn`` — sustained primary churn (sets, overwrites,
  deletes, occasional ``clear_range``) under a maintained
  :class:`~..layers.index.SecondaryIndex`; the layer consistency
  checker (driven by the test, not this workload) owns the verdict.

Layer objects are passed through workload ``options`` (they are live
client-side objects, not names) so a test builds the layer stack once
and lets several workload clients drive it concurrently.
"""

from __future__ import annotations

from .workload import TestWorkload, register_workload


def zipf_cdf(n: int, s: float) -> list[float]:
    """Cumulative zipf(s) distribution over ranks 1..n."""
    weights = [1.0 / (i ** s) for i in range(1, n + 1)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def zipf_pick(cdf: list[float], u: float) -> int:
    """Rank (0-based) for uniform draw ``u`` via binary search."""
    lo, hi = 0, len(cdf) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cdf[mid] < u:
            lo = mid + 1
        else:
            hi = mid
    return lo


@register_workload
class LayerReadTierWorkload(TestWorkload):
    name = "LayerReadTier"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.cache = self.opt("cache", None)
        self.n_keys = int(self.opt("nodeCount", 500))
        self.ops = int(self.opt("opsPerClient", 200))
        self.write_fraction = float(self.opt("writeFraction", 0.1))
        self.zipf_s = float(self.opt("zipfS", 0.99))
        self.prefix = bytes(self.opt("prefix", b"tier/"))
        self._cdf = zipf_cdf(self.n_keys, self.zipf_s)
        self.reads = 0
        self.writes = 0
        self.stale_reads = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%08d" % i

    async def setup(self) -> None:
        BATCH = 250
        for start in range(0, self.n_keys, BATCH):
            async def fill(tr, start=start):
                for i in range(start, min(start + BATCH, self.n_keys)):
                    tr.set(self._key(i), b"v0-%08d" % i)
            await self.db.run(fill)

    async def start(self) -> None:
        assert self.cache is not None, "pass the ReadThroughCache in options"
        gen = 0
        for _ in range(self.ops):
            i = zipf_pick(self._cdf, self.rng.random())
            key = self._key(i)
            if self.rng.coinflip(self.write_fraction):
                gen += 1
                value = b"v%d-c%d-%08d" % (gen, self.ctx.client_id, i)

                async def body(tr, key=key, value=value):
                    tr.set(key, value)
                await self.db.run(body)
                self.writes += 1
            else:
                value, valid_through = await self.cache.get_versioned(key)
                self.reads += 1
                # the staleness proof, inline while the claimed version
                # is still inside the MVCC window: the cache says the
                # value is valid through ``valid_through``, so the
                # authoritative read pinned there must byte-match
                tr = self.db.create_transaction()
                try:
                    tr.set_read_version(valid_through)
                    truth = await tr.get(key, snapshot=True)
                    if truth != value:
                        self.stale_reads += 1
                except Exception:  # noqa: BLE001 — aged out mid-probe:
                    pass           # unverifiable, not stale
                finally:
                    tr.reset()

    async def check(self) -> bool:
        return self.stale_reads == 0

    def metrics(self):
        return {"reads": self.reads, "writes": self.writes,
                "stale_reads": self.stale_reads,
                "hit_rate": self.cache.hit_rate if self.cache else 0.0}


@register_workload
class LayerIndexChurnWorkload(TestWorkload):
    name = "LayerIndexChurn"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.index = self.opt("index", None)
        self.n_keys = int(self.opt("nodeCount", 300))
        self.ops = int(self.opt("opsPerClient", 100))
        self.clear_fraction = float(self.opt("clearFraction", 0.05))
        self.delete_fraction = float(self.opt("deleteFraction", 0.15))
        self.prefix = bytes(self.opt("prefix", b"churn/"))
        self.committed = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%08d" % i

    def _value(self, i: int) -> bytes:
        # a small value population so index entries collide across keys
        # (the interesting shape for (ival, pkey) row maintenance)
        return b"bucket-%02d" % (i % 17)

    async def setup(self) -> None:
        async def fill(tr):
            for i in range(0, self.n_keys, 3):
                tr.set(self._key(i), self._value(i))
        await self._run(fill)

    async def _run(self, fn) -> None:
        if self.index is not None and self.index.mode == "transactional":
            await self.index.run(fn)
        else:
            await self.db.run(fn)
        self.committed += 1

    async def start(self) -> None:
        for n in range(self.ops):
            i = self.rng.random_int(0, self.n_keys - 1)
            if self.rng.coinflip(self.clear_fraction):
                b = self._key(i)
                e = self._key(min(self.n_keys, i + 8))

                async def body(tr, b=b, e=e):
                    tr.clear_range(b, e)
                await self._run(body)
            elif self.rng.coinflip(self.delete_fraction):
                async def body(tr, key=self._key(i)):
                    tr.clear(key)
                await self._run(body)
            else:
                v = self._value(self.rng.random_int(0, 10_000))

                async def body(tr, key=self._key(i), v=v):
                    tr.set(key, v)
                await self._run(body)

    async def check(self) -> bool:
        return True      # the LayerConsistencyChecker owns the verdict

    def metrics(self):
        return {"committed": self.committed}
