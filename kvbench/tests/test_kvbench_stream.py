"""The general generator: the same stream from a seed, another from
another seed, and the keys the port's own generators make."""

from __future__ import annotations

import numpy as np
import pytest

from kvbench import keys, spec, stream

from kvbench_small import REPO, shrink


def _cfg(name: str, small: bool = True) -> dict:
    cfg = spec.config(spec.load(REPO), name, REPO)
    return shrink(cfg) if small else cfg


def _same(a: stream.Stream, b: stream.Stream) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
               ("versions", "snapshots", "nr", "nw", "blob", "offs"))


@pytest.mark.parametrize("config", ["mako5050-z099", "tpcc-neworder-w100"])
def test_a_seed_gives_one_stream(config):
    cfg = _cfg(config)
    mix = {"stream_batches": 8}
    big = 2 ** 33 + 7           # a seed past 32 signed bits
    assert _same(stream.build(cfg, mix, big), stream.build(cfg, mix, big))
    assert not _same(stream.build(cfg, mix, big),
                     stream.build(cfg, mix, big + 1))


def test_mako_matches_the_ports_workload():
    from foundationdb_tpu_torch.bench.workload import MakoWorkload
    from foundationdb_tpu_torch.ops.batch import wire_from_txns
    cfg = _cfg("mako5050-z099", small=False)
    seed = 2 ** 31 + 77
    s = stream.build(cfg, {"stream_batches": 4}, seed)
    shape = cfg["batches"]
    batches, versions = MakoWorkload(
        n_keys=cfg["schema"]["n_keys"], seed=seed,
        snapshot_lag_versions=shape["snapshot_lag_versions"]).make_batches(
            4, shape["txns"], start_version=shape["start_version"],
            versions_per_batch=shape["versions_per_batch"])
    assert list(versions) == list(s.versions)
    for j, txns in enumerate(batches):
        w = wire_from_txns(txns)
        blob, offs, nr, nw, snaps = s.wire(j)
        assert w.blob == blob
        for a, b in ((w.offs, offs), (w.nr, nr), (w.nw, nw),
                     (w.snapshots, snaps)):
            assert np.array_equal(a, b)


def test_tuple_keys_pack_as_the_tuple_layer():
    from foundationdb_tpu_torch.client import tuple as tup
    v = np.array([0, 1, 255, 256, 65535, 65536, 100000, 2 ** 40])
    mat, lens = keys.tuple_keys("stock", v, v[::-1])
    for i in range(v.size):
        assert bytes(mat[i, :lens[i]]) == tup.pack(
            ("stock", int(v[i]), int(v[::-1][i])))


def test_new_order_ranges():
    """Each New-Order: warehouse, district, customer and its distinct
    stock rows read; district, order, new-order, the lines' span and the
    stock rows written; every key within the 32-byte encoding."""
    from foundationdb_tpu_torch.client import tuple as tup
    cfg = _cfg("tpcc-neworder-w100")
    s = stream.build(cfg, {"stream_batches": 2}, 5)
    assert s.nr.max() <= 18 and s.nw.max() <= 19
    assert np.array_equal(s.nw - s.nr, np.ones_like(s.nr))
    assert int(s.lens.max()) <= 19 and not s.points
    blob, offs, nr, nw, _ = s.wire(0)
    ks = [blob[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    r = 2 * int(nr[0])
    reads, writes = ks[:r], ks[r:r + 2 * int(nw[0])]
    w, d = tup.unpack(reads[2])[1:]
    assert reads[0] == tup.pack(("wh", w)) and reads[1] == reads[0] + b"\0"
    assert writes[0] == tup.pack(("dist", w, d))
    line = tup.pack(("orderline", w, d, tup.unpack(writes[2])[3]))
    assert writes[6:8] == [line + b"\x00", line + b"\xff"]
    stock = reads[6::2]
    assert stock == writes[8::2] and len(set(stock)) == len(stock)
    assert cfg["reduced"] == ["rollback_share"]
