"""The port's layers and client API-version gate against the JAX
package's.

Each scenario of the reference's own tests (tests/test_layers.py and
the two multiversion tests of tests/test_tuple_bindingtester.py) runs
twice under its own seed: as written against the reference (``numpy``
backend), and with its imports pointed at the port, whose clusters run
the ``cuda`` backend on ``torch.device("cpu")`` so the kernels' plain
versions answer.  Both runs make the reference's own assertions.  Then
what each showed is held equal, exactly: every read, read version and
commit version, every result of the feed consumer, the secondary index
(its rows, frontier and checkpoint), the cache, the watches and the
consistency checker (its verdicts), the LayerMismatch events traced, and
the bytes of every simulated disk.

tests/test_layers_chaos.py drives its layer stack with each package's
fault and traffic workloads (``workloads/``); tests/test_torch_sim.py
runs it as written on both.  ``layers_under_chaos`` below is the same
scenario written by hand against either package's public surface,
without ``workloads/``: the same cluster, layer stack, read tier with
its inline staleness probe, index churn, machine attrition, a swizzle,
random clogging and hostile disks under BUGGIFY, then the checker's
verdict and the canary.  It stays as a second check of the layers that
does not lean on the workload modules.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, captured_trace,
                          hold_to_reference, one_torch_thread, patch_port,
                          plain, reference_cases, run_reference_test)

CASES = {
    "test_layers.py": [
        "test_feed_consumer_frontier_proves_delivery",
        "test_cursor_raises_typed_feed_destroyed_mid_drain",
        "test_consumer_goes_terminal_on_destroyed_feed",
        "test_transactional_index_bit_identical_to_rebuild",
        "test_transactional_index_concurrent_writers_conflict",
        "test_async_index_frontier_and_fallback",
        "test_async_index_clear_range_and_atomics_converge",
        "test_cache_invalidation_never_serves_stale",
        "test_cache_clear_range_invalidates_and_lru_bounds",
        "test_watch_fires_on_first_mutation_at_or_after_version",
        "test_watch_fires_when_key_clear_ranged",
        "test_watch_registered_past_mutation_fires_immediately",
        "test_watch_survives_live_shard_split_mid_wait",
        "test_watch_checker_clean_and_limit"],
    "test_tuple_bindingtester.py": [
        "test_multiversion_api_gating",
        "test_multiversion_versionstamp_gate"],
}


@pytest.mark.parametrize("file,test", reference_cases(CASES))
def test_scenario_matches_reference(file, test, monkeypatch):
    hold_to_reference(file, test, monkeypatch)


# --------------------------------------------------------------------------
# the layer stack under chaos (tests/test_layers_chaos.py's scenario)

WAIT_S = 240.0          # virtual-clock ceiling per wait phase


def _zipf_cdf(n: int, s: float) -> list[float]:
    w = [1.0 / (i ** s) for i in range(1, n + 1)]
    total, acc, cdf = sum(w), 0.0, []
    for x in w:
        acc += x / total
        cdf.append(acc)
    return cdf


def _zipf_pick(cdf: list[float], u: float) -> int:
    lo, hi = 0, len(cdf) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cdf[mid] < u:
            lo = mid + 1
        else:
            hi = mid
    return lo


def layers_under_chaos(name: str):
    """The chaos scenario's main coroutine for package ``name``: a
    7-machine durable simulated cluster with DD and BUGGIFY; one
    whole-database feed consumer driving an async secondary index, a
    read-through cache and watches, audited by the consistency checker;
    two read-tier clients (zipf reads through the cache, each byte
    compared with a read pinned at the version the cache claimed, and
    10% writes), two index-churn clients (sets, clears, range clears),
    one machine attrition round, one swizzle, random clogging and
    hostile disks.  Then the feed catches up, a checker pass must find
    no divergence, and one index row corrupted behind the maintainer's
    back must be the next pass's only divergence."""
    def m(path):
        return importlib.import_module(f"{name}.{path}")
    Knobs = m("runtime.knobs").Knobs
    DeterministicRandom = m("runtime.rng").DeterministicRandom
    deterministic_random = m("runtime.rng").deterministic_random
    ClusterConfigSpec = m("core.cluster_controller").ClusterConfigSpec
    SimulatedCluster = m("sim.cluster_sim").SimulatedCluster
    Subspace = m("client.subspace").Subspace
    L = m("layers")

    async def main() -> dict:
        knobs = Knobs().override(DD_ENABLED=True, BUGGIFY_ENABLED=True,
                                 STORAGE_DURABILITY_LAG=0.1,
                                 LAYER_FEED_POLL_INTERVAL=0.05,
                                 LAYER_PROGRESS_INTERVAL=1.0)
        sim = SimulatedCluster(knobs, n_machines=7, durable_storage=True,
                               spec=ClusterConfigSpec(min_workers=7,
                                                      replication=2))
        await sim.start()
        await asyncio.wait_for(sim.wait_epoch(1), 120)
        db = await sim.database()
        consumer = L.LayerFeedConsumer(db, name="chaos")
        index = L.SecondaryIndex(db, Subspace(raw_prefix=b"idx/"),
                                 primary_begin=b"churn/",
                                 primary_end=b"churn0",
                                 mode="async", consumer=consumer)
        cache = L.ReadThroughCache(db, consumer, capacity=1024)
        watches = L.WatchRegistry(db, consumer)
        checker = L.LayerConsistencyChecker(db, index=index, cache=cache,
                                            watches=watches)
        await consumer.start()
        await index.start_async()
        watch_futs = [await watches.watch(b"churn/%08d" % i)
                      for i in (0, 3, 7, 250)]
        rng = deterministic_random()
        out = {"reads": 0, "stale_reads": 0, "writes": 0, "churn": 0,
               "killed": 0, "swizzled": 0, "clogs": 0}

        def tier_key(i):
            return b"tier/%08d" % i

        def churn_key(i):
            return b"churn/%08d" % i

        async def fill(tr):
            for i in range(200):
                tr.set(tier_key(i), b"v0-%08d" % i)
        await db.run(fill)

        async def seed_churn(tr):
            for i in range(0, 120, 3):
                tr.set(churn_key(i), b"bucket-%02d" % (i % 17))
        await db.run(seed_churn)

        cdf = _zipf_cdf(200, 0.99)

        async def read_tier(cid, r):
            gen = 0
            for _ in range(120):
                key = tier_key(_zipf_pick(cdf, r.random()))
                if r.coinflip(0.1):
                    gen += 1
                    value = b"v%d-c%d-%s" % (gen, cid, key)

                    async def body(tr, key=key, value=value):
                        tr.set(key, value)
                    await db.run(body)
                    out["writes"] += 1
                    continue
                value, valid_through = await cache.get_versioned(key)
                out["reads"] += 1
                tr = db.create_transaction()
                try:
                    tr.set_read_version(valid_through)
                    if await tr.get(key, snapshot=True) != value:
                        out["stale_reads"] += 1
                except Exception:  # noqa: BLE001 — aged out: unverifiable
                    pass
                finally:
                    tr.reset()

        async def index_churn(r):
            for _ in range(60):
                i = r.random_int(0, 119)
                if r.coinflip(0.05):
                    b, e = churn_key(i), churn_key(min(120, i + 8))

                    async def body(tr, b=b, e=e):
                        tr.clear_range(b, e)
                elif r.coinflip(0.15):
                    async def body(tr, k=churn_key(i)):
                        tr.clear(k)
                else:
                    v = b"bucket-%02d" % (r.random_int(0, 10_000) % 17)

                    async def body(tr, k=churn_key(i), v=v):
                        tr.set(k, v)
                await db.run(body)
                out["churn"] += 1

        async def attrition(r):
            await asyncio.sleep(3.0)
            victims = [x for x in await sim.txn_only_machines() if x.alive]
            if not victims:
                return
            victim = victims[int(r.random_int(0, len(victims)))]
            before = (await sim.wait_epoch(1))["epoch"]
            await victim.kill()
            out["killed"] += 1
            await sim.wait_epoch(before + 1)
            await asyncio.sleep(1.5)
            await victim.reboot()

        async def swizzle(r):
            await asyncio.sleep(5.0)
            victims = [x for x in await sim.txn_only_machines() if x.alive]
            if len(victims) < 2:
                return
            k = 2 + int(r.random_int(0, len(victims) - 1))
            picks = list(victims)
            r.shuffle(picks)
            subset = picks[:k]
            before = (await sim.wait_epoch(1))["epoch"]
            for x in subset:
                await x.kill()
                await asyncio.sleep(r.random() * 0.05)
            order = list(subset)
            r.shuffle(order)
            await asyncio.sleep(0.5)
            for x in order:
                await x.reboot()
                await asyncio.sleep(r.random() * 0.1)
            await sim.wait_epoch(before + 1)
            out["swizzled"] += len(subset)

        async def clogging(r):
            loop = asyncio.get_running_loop()
            end = loop.time() + 6.0
            ms = sim.machines
            while loop.time() < end:
                await asyncio.sleep(0.5 + r.random() * 1.0)
                a = ms[int(r.random_int(0, len(ms)))]
                b = ms[int(r.random_int(0, len(ms)))]
                if a is b:
                    continue
                if r.coinflip(0.7):
                    sim.net.clog_pair(a.addr, b.addr, 0.2 + r.random())
                else:
                    sim.net.partition(a.addr, b.addr)
                    await asyncio.sleep(0.3 + r.random() * 0.7)
                    sim.net.heal(a.addr, b.addr)
                out["clogs"] += 1

        async def disk_faults(r):
            for x in sim.machines:
                x.fault_profile.arm(DeterministicRandom(r.next_u64()),
                                    io_error_p=0.005, stall_p=0.02,
                                    stall_max_s=0.03, torn_p=0.75,
                                    corrupt_p=0.25)
            await asyncio.sleep(8.0)
            for x in sim.machines:
                x.fault_profile.quiesce()

        actors = [read_tier(0, rng.split()), read_tier(1, rng.split()),
                  index_churn(rng.split()), index_churn(rng.split()),
                  attrition(rng.split()), swizzle(rng.split()),
                  clogging(rng.split()), disk_faults(rng.split())]
        await asyncio.gather(*actors)

        tr = db.create_transaction()
        tr.lock_aware = True
        tip = await tr.get_read_version()
        tr.reset()
        await consumer.wait_frontier(tip, timeout=WAIT_S)
        verdict = None
        for _ in range(40):
            verdict = await checker.check()
            if not any(verdict[k]["refused"]
                       for k in ("index", "cache", "watches")):
                break
            await asyncio.sleep(1.0)
        out["verdict"] = verdict
        out["watches_fired"] = sum(1 for f in watch_futs if f.done())
        out["canary"] = index.row_key(b"CANARY", b"churn/99999999")

        async def rot(tr):
            tr.set(out["canary"], b"")
        await db.run(rot)
        out["caught"] = await checker.check()
        await consumer.stop(destroy=True)
        await sim.stop()
        return out
    return main()


def _chaos_run(name: str, mp, retire: bool = True,
               majority: bool = True) -> dict:
    P = importlib.import_module(f"{name}.runtime.simloop")
    buggify = importlib.import_module(f"{name}.runtime.buggify")
    with mp.context() as m:
        if name == PORT:
            patch_port(m, retire=retire, majority=majority)
        buggify.enable_buggify(True)
        try:
            with captured_trace(name) as events:
                out = P.run_simulation(layers_under_chaos(name), seed=7119)
        finally:
            buggify.enable_buggify(False)
    out["mismatches"] = [plain(e) for e in events
                         if e.get("Type") == "LayerMismatch"]
    return plain(out)


def _check_chaos(r: dict) -> None:
    """The reference chaos test's own assertions."""
    v = r["verdict"]
    assert v["divergences"] == 0 and not v["index"]["refused"], v
    assert r["caught"]["index"]["divergences"] == 1, r["caught"]
    assert r["stale_reads"] == 0 and r["reads"] > 0
    assert r["churn"] > 0 and r["killed"] >= 1
    assert [e.get("Key") for e in r["mismatches"]] == [r["canary"].hex()]
    assert r["mismatches"][0].get("Severity") == 40
    assert r["mismatches"][0].get("Layer") == "index"
    assert r["mismatches"][0].get("Expected") == "<missing>"


def test_layer_checker_under_chaos_matches_reference(monkeypatch):
    """0 divergences under chaos, then the canary caught key-exactly, on
    both packages.  The attrition and the swizzle make the cluster
    recover, and after a recovery the port's controller stops the ended
    generation's resolvers (the reference never does), an RPC whose
    draws from the simulated network shift every later event, as does
    the client's refresh returning on a majority of coordinators.  So the
    port as it is makes the assertions, and the port without that retire
    and with its refresh gathered (``torch_parity.gathered``) is held to
    the reference field for field."""
    ref = _chaos_run(REF, monkeypatch)
    _check_chaos(ref)
    _check_chaos(_chaos_run(PORT, monkeypatch))
    port = _chaos_run(PORT, monkeypatch, retire=False, majority=False)
    for k in ref:
        assert port[k] == ref[k], k
    assert port == ref


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_transactional_index_on_the_card_matches_reference(monkeypatch):
    """The transactional index's rebuild invariant with the port's
    resolvers on the card: what it showed equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f, t = "test_layers.py", "test_transactional_index_bit_identical_to_rebuild"
    ref = run_reference_test(f, t, REF, monkeypatch)
    card = run_reference_test(f, t, PORT, monkeypatch,
                              device=torch.device("cuda"))
    assert_same(ref, card)
