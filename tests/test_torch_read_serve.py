"""The port's storage read mirror against the JAX package's.

The port's ``DeviceReadServer`` runs on ``torch.device("cpu")`` here,
where kernel B8 (``prefix_search``) answers through its plain version
(two ``torch.searchsorted`` calls).  Every case is a port of
tests/test_device_pipeline.py's device-read tests (the single mirror,
the pending overlay, the stale fallback and refresh, the threshold and
knob gates, the storage server's wiring, the sharded mirror with partial
refresh and the lsm blocks mode, the staleness gauge): the same engine
contents go into both packages, and every batch must equal
``engine.get_batch`` byte for byte and the reference server's answer,
with equal counters.  The B8 plain version is held against numpy's u64
``searchsorted`` on the cases ``chip_smoke.py`` phase 3 uses, and so is
a line-for-line model of the kernel's two searches; a ``cuda``-marked
test holds the kernel against the plain version on the card.
"""

from __future__ import annotations

import asyncio
import os
import sys

import numpy as np
import pytest
import torch

from foundationdb_tpu.device import read_serve as rref
from foundationdb_tpu.runtime.knobs import Knobs as RKnobs
from foundationdb_tpu.storage.kv_store import MemoryKVStore as RMem
from foundationdb_tpu_torch.device import read_serve as pref
from foundationdb_tpu_torch.ops import kernels as K
from foundationdb_tpu_torch.runtime.knobs import Knobs as PKnobs
from foundationdb_tpu_torch.storage.kv_store import OP_SET
from foundationdb_tpu_torch.storage.kv_store import MemoryKVStore as PMem
from torch_parity import buggify_off  # noqa: F401  (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    sys.path.insert(0, _REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(_REPO)
    return cs


class Pair:
    """One engine content in both packages, with a read server on each
    (the port's on the CPU)."""

    def __init__(self, n: int, merge: bool = True, **knobs) -> None:
        self.kv = [PMem(None, "t"), RMem(None, "t")]
        self.apply([(OP_SET, b"dk%05d" % i, b"v%05d" % i)
                    for i in range(n)])
        if merge:
            self.merge()
        self.srv = [
            pref.DeviceReadServer(self.kv[0], PKnobs().override(**knobs),
                                  device=CPU, version_fn=self.tip),
            rref.DeviceReadServer(self.kv[1], RKnobs().override(**knobs),
                                  version_fn=self.tip)]
        self.version = 100

    def tip(self) -> int:
        return self.version

    def apply(self, ops) -> None:
        for kv in self.kv:
            kv._apply(list(ops))

    def merge(self) -> None:
        for kv in self.kv:
            kv.packed_index._merge()

    def get(self, keys):
        """Both servers' answers, held equal to each other and (when
        served) to the engine; -> the port's answer."""
        got = [s.get_batch(list(keys)) for s in self.srv]
        assert got[0] == got[1]
        if got[0] is not None:
            assert got[0] == self.kv[0].get_batch(list(keys))
        return got[0]

    def metrics(self) -> dict:
        m = [s.metrics() for s in self.srv]
        assert m[0] == m[1]
        return m[0]

    @property
    def dirs(self):
        return [s._dir for s in self.srv]


MIN4 = dict(STORAGE_DEVICE_READ_MIN_BATCH=4)


def test_matches_engine_path():
    p = Pair(500, **MIN4)
    assert all(s.active for s in p.srv)
    # the mirror cold-starts stale: the first batch takes the engine path
    assert p.get([b"dk00000"] * 8) is None
    keys = sorted({b"dk%05d" % (i * 37 % 700) for i in range(64)}
                  | {b"aaaa", b"zzzz"})
    assert p.get(keys) is not None
    m = p.metrics()
    assert (m["device_read_batches"], m["device_read_keys"],
            m["device_read_fallbacks"], m["device_read_uploads"]) == \
        (1, len(keys), 1, 1)


def test_probes_pending_overlay():
    p = Pair(200, **MIN4)
    p.get([b"dk%05d" % i for i in range(8)])        # builds the mirror
    gen = p.kv[0].packed_index.gen
    p.apply([(OP_SET, b"zz-new%02d" % i, b"nv") for i in range(4)])
    assert p.kv[0].packed_index.gen == gen          # no merge: overlay
    got = p.get(sorted([b"zz-new00", b"zz-new03", b"dk00001", b"zz-none"]))
    assert got == [b"v00001", b"nv", b"nv", None]


def test_stale_mirror_falls_back_then_refreshes():
    p = Pair(300, **MIN4)
    keys = [b"dk%05d" % i for i in range(16)]
    assert p.get(keys) is None                      # cold start
    assert p.get(keys) is not None
    uploads = p.dirs[0].uploads
    p.apply([(OP_SET, b"dk%05d" % (1000 + i), b"nv") for i in range(600)])
    p.merge()
    assert p.get(keys) is None                      # stale: engine serves
    assert p.dirs[0].uploads == uploads + 1         # ...and refreshed
    assert p.get(keys) is not None                  # fresh: device serves
    assert p.metrics()["device_read_fallbacks"] == 2


def test_threshold_and_knob_gates():
    p = Pair(100, STORAGE_DEVICE_READ_MIN_BATCH=32)
    assert p.get([b"dk00001"] * 8) is None          # below threshold
    assert p.metrics()["device_read_fallbacks"] == 1
    off = pref.DeviceReadServer(p.kv[0], PKnobs().override(
        STORAGE_DEVICE_READ_SERVE=False), device=CPU)
    assert not off.active
    assert off.get_batch([b"dk%05d" % i for i in range(64)]) is None
    # without a packed index the mirror is inactive and needs no device
    import types
    bare = pref.DeviceReadServer(types.SimpleNamespace(), PKnobs())
    assert not bare.active


def test_storage_server_wires_device_reads():
    from foundationdb_tpu_torch.core.data import KeyRange
    from foundationdb_tpu_torch.core.storage_server import StorageServer
    from foundationdb_tpu_torch.core.tlog import TLog

    async def main():
        knobs = PKnobs()
        ss = StorageServer(knobs, 0, KeyRange(b"", b"\xff"), TLog(knobs),
                           engine=Pair(50).kv[0], device=CPU)
        assert ss._device_reads is not None
        assert ss._device_reads._dir._device == CPU
        assert (await ss.metrics())["device_read_active"] == 1
        bare = StorageServer(knobs, 1, KeyRange(b"", b"\xff"), TLog(knobs))
        assert bare._device_reads is None
        assert "device_read_active" not in await bare.metrics()
    asyncio.run(main())


def sharded(shards: int):
    return dict(MIN4, STORAGE_DEVICE_READ_SHARDS=shards)


def test_sharded_directory_matches_engine_and_twin():
    p = Pair(800, **sharded(4))
    twin = pref.DeviceReadServer(p.kv[0], PKnobs().override(**sharded(0)),
                                 device=CPU)
    assert p.srv[0]._sharded and not twin._sharded
    keys = sorted({b"dk%05d" % (i * 37 % 1100) for i in range(96)}
                  | {b"aaaa", b"zzzz"})
    got = p.get(keys)               # sharded serves inline even from cold
    assert got is not None
    assert twin.get_batch(keys) is None             # twin primes only
    assert got == twin.get_batch(keys)
    m = p.metrics()
    assert (m["device_read_shards"], m["device_read_full_splits"],
            m["device_read_shard_refreshes"]) == (4, 1, 4)
    assert m["device_read_gathers"] >= 2            # spanned > 1 shard


def test_sharded_directory_partial_refresh_serves_inline():
    p = Pair(600, **sharded(4))
    keys = [b"dk%05d" % i for i in range(32)]
    p.get(keys)                                     # cold: full split
    assert p.get(keys) is not None
    refr0 = p.dirs[0].shard_refreshes
    p.apply([(OP_SET, b"dk%05d" % (5000 + i), b"nv") for i in range(300)])
    p.merge()
    assert p.get(keys) is not None                  # partial + inline
    delta = p.dirs[0].shard_refreshes - refr0
    assert 1 <= delta < 4
    assert p.metrics()["device_read_full_splits"] == 1


def test_staleness_gauge():
    p = Pair(300, **MIN4)
    keys = [b"dk%05d" % i for i in range(16)]
    p.get(keys)                                     # primes at tip 100
    assert p.get(keys) is not None
    assert [s.staleness_versions() for s in p.srv] == [0, 0]
    p.version = 500
    assert p.srv[0].staleness_versions() == 0       # fresh: overlay covers
    p.apply([(OP_SET, b"dk%05d" % (2000 + i), b"nv") for i in range(600)])
    p.merge()
    assert [s.staleness_versions() for s in p.srv] == [400, 400]
    assert p.metrics()["device_read_staleness_versions"] == 400
    p.get(keys)                                     # engine + refresh
    assert p.metrics()["device_read_staleness_versions"] == 0


def lsm_pair(monkeypatch, shards: int):
    """The same lsm contents in both packages (several sorted runs, a
    clear that leaves tombstones): -> (port store, ref store, probes,
    run_simulation of each)."""
    import foundationdb_tpu.storage.lsm as rlsm
    import foundationdb_tpu_torch.storage.lsm as plsm
    from foundationdb_tpu.runtime.files import SimFileSystem as RFS
    from foundationdb_tpu.runtime.simloop import run_simulation as rrun
    from foundationdb_tpu_torch.runtime.files import SimFileSystem as PFS
    from foundationdb_tpu_torch.runtime.simloop import run_simulation as prun
    for mod in (rlsm, plsm):
        monkeypatch.setattr(mod, "_MEMTABLE_BYTES", 1500)
        monkeypatch.setattr(mod, "_BLOCK_BYTES", 200)
        monkeypatch.setattr(mod, "_MAX_RUNS", 8)

    def go(mod, fs_cls, run, srv_cls, knobs, kw):
        async def main():
            import random
            kv = await mod.LSMKVStore.open(fs_cls(), "db/lsm")
            rng = random.Random(9)
            for round_ in range(8):
                ops = [(0, b"dk%04d" % rng.randrange(1200),
                        b"v%06d" % rng.randrange(10 ** 6))
                       for _ in range(60)]
                ops.append((1, b"dk0100", b"dk0140"))
                await kv.commit(ops, {"durable_version": round_})
            assert len(kv._runs) >= 2
            assert kv.packed_index.device_mode == "blocks"
            srv = srv_cls(kv, knobs.override(
                STORAGE_DEVICE_READ_MIN_BATCH=4,
                STORAGE_DEVICE_READ_SHARDS=shards), **kw)
            probes = sorted({b"dk%04d" % rng.randrange(1400)
                             for _ in range(150)})
            log = [srv.get_batch(probes), srv.get_batch(probes)]
            want = kv.get_batch(probes)
            await kv.commit([(0, b"zz-memkey", b"mv")],
                            {"durable_version": 99})
            qs = sorted(probes + [b"zz-memkey"])
            log += [srv.get_batch(qs), srv.get_batch(qs)]
            want2 = kv.get_batch(qs)
            big = [(0, b"fl%04d" % i, b"w" * 40) for i in range(50)]
            await kv.commit(big, {"durable_version": 100})
            want3 = kv.get_batch(probes)
            try:
                log += [srv.get_batch(probes), srv.get_batch(probes)]
            except AttributeError as e:
                log.append(f"AttributeError: {e}")
            return log, (want, want2, want3), srv.metrics()
        return run(main())

    port = go(plsm, PFS, prun, pref.DeviceReadServer, PKnobs(),
              {"device": CPU})
    ref = go(rlsm, RFS, rrun, rref.DeviceReadServer, RKnobs(), {})
    return port, ref


@pytest.mark.parametrize("shards", [0, 4], ids=["single", "sharded"])
def test_lsm_blocks_mode(monkeypatch, shards):
    """The mirror over the lsm engine's merged sparse directory: one
    search locates the candidate block in every run, the host finish
    returns what ``engine.get_batch`` would (tombstones newest-wins,
    memtable-only keys host-side), and a flush stales the mirror."""
    port, ref = lsm_pair(monkeypatch, shards)
    log, (want, want2, want3), m = port
    if shards:
        # the reference's sharded mirror asks the lsm directory for a
        # change log it does not keep once a flush changes the run set
        # (ROADMAP C); the port re-splits in full there
        assert ref[0][:4] == log[:4] and ref[1] == port[1]
        assert ref[0][4:] == ["AttributeError: 'LsmSparseIndex' object has "
                              "no attribute 'changed_since'"]
        assert m["device_read_full_splits"] == 2
    else:
        assert port == ref
    assert m["device_read_batches"] >= 3
    for got, w in zip(log, (want, want, want2, want2, want3, want3)):
        assert got is None or got == w
    if shards:
        assert log[0] == want                       # inline from cold
    else:
        assert log[0] is None and log[1] == want    # cold start primes
        assert log[4] is None and log[5] == want3   # the flush stales


# --------------------------------------------------------------------------
# B8: the prefix search


def kernel_model(pfx: np.ndarray, x: int) -> tuple[int, int]:
    """csrc/prefix_search.cu's two searches for one probe, line for line
    in Python (int64 compares on the mapped values)."""
    N = len(pfx)
    lo = 0
    if N > 0:
        base, ln = 0, N
        while ln > 1:
            half = ln >> 1
            base = base + half if pfx[base + half] < x else base
            ln -= half
        lo = base + (1 if pfx[base] < x else 0)
    hi = lo
    if lo < N and pfx[lo] <= x:
        b, step = lo, 1
        while b + step < N and pfx[b + step] <= x:
            b += step
            step <<= 1
        e = min(b + step, N)
        base, ln = b + 1, e - (b + 1)
        if ln == 0:
            hi = e
        else:
            while ln > 1:
                half = ln >> 1
                base = base + half if pfx[base + half] <= x else base
                ln -= half
            hi = base + (1 if pfx[base] <= x else 0)
    return lo, hi


# power-of-two and odd lengths: the left search's halving reaches an odd
# length only when N is not a power of two
CASES = [(0, 512), (1, 512), (4096, 512), (1 << 16, 4096), (4093, 512),
         (100_001, 4096)]


def test_map_prefixes_preserves_order():
    cs = chip_smoke()
    pfx, probes = cs.prefix_cases(5, 4096, 512)
    both = np.concatenate([pfx, probes])
    order = np.argsort(both, kind="stable")
    mapped = pref.map_prefixes(both)
    assert mapped.dtype == np.int64
    np.testing.assert_array_equal(np.argsort(mapped, kind="stable"), order)


@pytest.mark.parametrize("N,n", CASES)
def test_prefix_search_plain_matches_numpy_u64(N, n):
    """On the phase-3 cases: wide equal-prefix runs, values at or above
    2**63, probes below and above every prefix, an empty mirror."""
    cs = chip_smoke()
    pfx, probes = cs.prefix_cases(N + n, N, n)
    want_lo = np.searchsorted(pfx, probes, side="left")
    want_hi = np.searchsorted(pfx, probes, side="right")
    t = torch.from_numpy(pref.map_prefixes(pfx))
    q = torch.from_numpy(pref.map_prefixes(probes))
    for lo, hi in (K.prefix_search_plain(t, q), K.prefix_search(t, q)):
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(hi.numpy(), want_hi)
    assert (want_hi - want_lo).max(initial=0) > 1 or N < 2
    mp, mq = pref.map_prefixes(pfx).tolist(), pref.map_prefixes(probes)
    model = [kernel_model(mp, int(x)) for x in mq[:256]]
    assert model == list(zip(want_lo[:256].tolist(), want_hi[:256].tolist()))


def test_prefix_search_checks_its_inputs():
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.prefix_search(t.to(torch.int32), t)
    with pytest.raises(ValueError):
        K.prefix_search(t, t, lo=torch.empty(3, dtype=torch.int64))
    lo, hi = K.prefix_search(t, torch.zeros(0, dtype=torch.int64))
    assert lo.shape == hi.shape == (0,)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kv = Pair(10).kv[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pref.DeviceReadServer(kv, PKnobs())


@pytest.mark.cuda
def test_prefix_search_kernel_matches_plain_on_card():
    """Kernel B8 against its plain version on CUDA tensors, tolerance 0,
    and the mirror on the card against the engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cs = chip_smoke()
    dev = torch.device("cuda")
    for N, n in CASES + [(1 << 20, 4096), ((1 << 20) - 3, 4096)]:
        pfx, probes = cs.prefix_cases(N + n, N, n)
        t = torch.from_numpy(pref.map_prefixes(pfx)).to(dev)
        q = torch.from_numpy(pref.map_prefixes(probes)).to(dev)
        before = K.KERNELS["prefix_search"].launches
        lo, hi = K.prefix_search(t, q)
        assert K.KERNELS["prefix_search"].launches == before + 1
        plo, phi = K.prefix_search_plain(t, q)
        assert torch.equal(lo, plo) and torch.equal(hi, phi)
    kv = Pair(5000).kv[0]
    for shards in (0, 4):
        srv = pref.DeviceReadServer(kv, PKnobs().override(
            STORAGE_DEVICE_READ_MIN_BATCH=4,
            STORAGE_DEVICE_READ_SHARDS=shards))
        keys = sorted({b"dk%05d" % (i * 7 % 6000) for i in range(900)})
        got = srv.get_batch(keys) or srv.get_batch(keys)
        assert got == kv.get_batch(keys)
