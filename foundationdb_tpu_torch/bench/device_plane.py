"""Device-plane bench on the card: the sharded read mirror, the
verdict-bitmask readback, and the in-place ring append, each A/B'd
against its verbatim twin.

Three measurements, each returned as a dict of flat keys:

1. **Sharded read mirror vs single directory** under tail-localized
   churn: every round inserts a key span past the existing keyspace
   (bumping the packed index gen) then probes batched reads.  The twin
   goes stale on every round and pays a full re-upload + engine
   fallback; the sharded mirror partial-refreshes only the touched tail
   shard and keeps serving off the device.  Reports device-served batch
   counts, keys/s per side, and refresh locality.  Every batch is held
   equal to ``engine.get_batch``.

2. **Verdict-bitmask readback vs the raw-vector twin**: mostly-clean
   proxy batches through DevicePipeline on the cuda backend with
   RESOLVER_VERDICT_BITMASK on vs off — readback bytes/txn and txns/s
   per side, verdicts asserted bit-identical.

3. **In-place ring append vs the rebuild twin**: the same batches with
   RESOLVER_RING_INPLACE on vs off (kernel K2 against ``torch.cat``) —
   txns/s per side, verdicts asserted bit-identical.

Every run takes a ``torch.device``: the CUDA card by default (the
shards of the sharded mirror are separate prefix tensors on it),
``torch.device("cpu")`` for the kernels' plain versions.
``chip_smoke.py`` phase 13 drives all three on the card and fails on a
parity flag that is false.
"""

from __future__ import annotations

import asyncio
import time

MIRROR_KEYS = 120_000
ROUNDS = 12
CHURN_KEYS = 400
PROBES = 512
BATCHES_PER_ROUND = 2
SHARDS = 4
VERDICT_BATCHES = 48
VERDICT_TXNS = 64
RING_BATCHES = 24


def run_mirror(device=None) -> dict:
    from ..device.read_serve import DeviceReadServer
    from ..ops.conflict_torch import default_device
    from ..runtime.knobs import Knobs
    from ..storage.kv_store import OP_SET, MemoryKVStore

    dev = default_device(device)
    out: dict = {"devplane_device": str(dev), "devplane_shards": SHARDS}

    def side(shards: int) -> tuple[float, int, "DeviceReadServer"]:
        kv = MemoryKVStore(None, "t")
        kv._apply([(OP_SET, b"mk%07d" % i, b"v%07d" % i)
                   for i in range(MIRROR_KEYS)])
        kv.packed_index._merge()
        knobs = Knobs().override(STORAGE_DEVICE_READ_MIN_BATCH=4,
                                 STORAGE_DEVICE_READ_SHARDS=shards)
        srv = DeviceReadServer(kv, knobs, device=dev)
        if not srv.active:
            raise RuntimeError("the device read mirror is not armed")
        probe_sets = [
            sorted({b"mk%07d" % ((r * 104729 + j * 31 + s * 7919)
                                 % (MIRROR_KEYS + 500))
                    for j in range(PROBES)})
            for r in range(ROUNDS) for s in range(BATCHES_PER_ROUND)]
        warm = probe_sets[0]
        if srv.get_batch(warm) is None:
            srv.get_batch(warm)
        srv.served_batches = 0
        srv.fallbacks = 0
        keys_served = 0
        t0 = time.perf_counter()
        pi = 0
        for r in range(ROUNDS):
            kv._apply([(OP_SET, b"zz%07d" % (r * CHURN_KEYS + j), b"c")
                       for j in range(CHURN_KEYS)])
            kv.packed_index._merge()
            for _ in range(BATCHES_PER_ROUND):
                keys = probe_sets[pi]
                pi += 1
                got = srv.get_batch(keys)
                if got is None:
                    got = kv.get_batch(keys)
                keys_served += len(keys)
                if got != kv.get_batch(keys):
                    raise RuntimeError(
                        "device read path diverged from the engine")
        return time.perf_counter() - t0, keys_served, srv

    twin_s, twin_keys, twin_srv = side(0)
    shard_s, shard_keys, shard_srv = side(SHARDS)
    m = shard_srv.metrics()
    out.update({
        "devplane_mirror_twin_batches": twin_srv.served_batches,
        "devplane_mirror_sharded_batches": shard_srv.served_batches,
        "devplane_mirror_served_ratio": round(
            shard_srv.served_batches / max(twin_srv.served_batches, 1), 2),
        "devplane_mirror_twin_keys_per_sec": round(twin_keys / twin_s, 1),
        "devplane_mirror_sharded_keys_per_sec": round(shard_keys / shard_s, 1),
        "devplane_mirror_shard_refreshes": m["device_read_shard_refreshes"],
        "devplane_mirror_full_splits": m["device_read_full_splits"],
        "devplane_mirror_twin_uploaded_keys": twin_srv._dir.uploaded_keys,
        "devplane_mirror_sharded_uploaded_keys": m["device_read_uploaded_keys"],
    })
    return out


def _proxy_batches(n_batches: int):
    from ..ops.batch import TxnRequest

    batches, versions = [], []
    v, key = 1_000, 0
    for i in range(n_batches):
        txns = []
        for j in range(VERDICT_TXNS):
            if i % 12 == 11 and j < 2:
                # cross-batch collision at a stale snapshot -> CONFLICT,
                # so the packed planes carry real set bits
                k = b"dp-hot"
                txns.append(TxnRequest([(k, k + b"\x00")],
                                       [(k, k + b"\x00")], v - 200))
            else:
                k = b"dp%08d" % key
                key += 1
                txns.append(TxnRequest([(k, k + b"\x00")],
                                       [(k, k + b"\x00")], v - 1))
        batches.append(txns)
        versions.append(v)
        v += 10
    return batches, versions


def _pipeline_pass(knobs, batches, versions,
                   device) -> tuple[list, float, float]:
    """One DevicePipeline pass; returns (flat verdicts, elapsed_s,
    readback bytes/txn)."""
    from ..device.pipeline import DevicePipeline
    from ..ops.backends import make_conflict_backend

    async def run():
        be = make_conflict_backend(knobs, device=device)
        pipe = DevicePipeline(be, knobs)
        t0 = time.perf_counter()
        futs = [pipe.submit(t, v) for t, v in zip(batches, versions)]
        rows = [await f for f in futs]
        dt = time.perf_counter() - t0
        await pipe.close()
        bpt = be.readback_bytes / max(be.readback_txns, 1)
        return [x for r in rows for x in r], dt, bpt
    return asyncio.run(run())


def _base_knobs():
    from ..runtime.knobs import Knobs

    return Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda",
        RESOLVER_BATCH_TXNS=VERDICT_TXNS,
        RESOLVER_RANGES_PER_TXN=2, CONFLICT_RING_CAPACITY=4096,
        KEY_ENCODE_BYTES=16, CONFLICT_WINDOW_SLOTS=64,
        MAX_WRITE_TRANSACTION_LIFE_VERSIONS=1_000, RESOLVER_GROUP_MAX=8)


def run_verdict_bitmask(device=None) -> dict:
    batches, versions = _proxy_batches(VERDICT_BATCHES)
    base = _base_knobs()
    raw, raw_s, raw_bpt = _pipeline_pass(
        base.override(RESOLVER_VERDICT_BITMASK=False), batches, versions,
        device)
    packed, packed_s, packed_bpt = _pipeline_pass(
        base.override(RESOLVER_VERDICT_BITMASK=True), batches, versions,
        device)
    n = VERDICT_BATCHES * VERDICT_TXNS
    return {
        "devplane_verdict_parity": raw == packed,
        "devplane_verdict_aborts": sum(1 for x in raw if x != 0),
        "devplane_verdict_raw_bytes_per_txn": round(raw_bpt, 2),
        "devplane_verdict_packed_bytes_per_txn": round(packed_bpt, 3),
        "devplane_verdict_bitmask_ratio": round(
            raw_bpt / max(packed_bpt, 1e-9), 1),
        "devplane_verdict_raw_txns_per_sec": round(n / raw_s, 1),
        "devplane_verdict_packed_txns_per_sec": round(n / packed_s, 1),
    }


def run_ring_inplace(device=None) -> dict:
    from ..ops.conflict_torch import default_device

    dev = default_device(device)
    batches, versions = _proxy_batches(RING_BATCHES)
    base = _base_knobs()
    rebuild, rebuild_s, _ = _pipeline_pass(
        base.override(RESOLVER_RING_INPLACE=False), batches, versions, dev)
    inplace, inplace_s, _ = _pipeline_pass(
        base.override(RESOLVER_RING_INPLACE=True), batches, versions, dev)
    n = RING_BATCHES * VERDICT_TXNS
    return {
        "devplane_ring_parity": rebuild == inplace,
        "devplane_ring_rebuild_txns_per_sec": round(n / rebuild_s, 1),
        "devplane_ring_inplace_txns_per_sec": round(n / inplace_s, 1),
        # the plain versions on the cpu: a correctness exercise, not a
        # perf claim
        "devplane_ring_mode": dev.type,
    }
