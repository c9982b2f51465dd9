"""The bench mains that the north-star bench runs as subprocesses, and
the perf_smoke helpers its ``bigkeys`` and ``lsm_ingest`` stages use,
against the reference's.

- ``bench.multi_resolver --device cpu --live-only``: rc 0, the
  reference's one JSON line (its metric, and the keys of every result
  and every partition), each live mesh committing.
- ``bench.device_plane --device cpu``: rc 0, both parity flags true, and
  the keys the reference's three A/Bs return (read from its source: on
  this JAX its in-place ring A/B fails to import ``disable_x64``,
  ROADMAP C).
- ``tools/perf_smoke.py``'s ``bigkeys_key_fn``, ``apply_bigkeys``,
  ``packed_scan``, ``lsm_compact_commits``, ``_lsm_compact_geometry``
  and ``lsm_ingest_side``: the same inputs through both packages give
  the same keys, versions, rows and serving surface.

Tolerance 0 everywhere: these are keys, counts and bytes.
"""

from __future__ import annotations

import ast
import asyncio
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import buggify_off, one_torch_thread  # noqa: E402,F401


def reference_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_multi_resolver_main_live_only(monkeypatch, capsys):
    from foundationdb_tpu.bench import multi_resolver as ref_mr

    from foundationdb_tpu_torch.bench import multi_resolver as mr
    monkeypatch.setattr(sys, "argv", ["multi_resolver", "--live-only"])
    assert ref_mr.main() == 0
    ref = _last_json(capsys.readouterr().out)
    assert mr.main(["--device", "cpu", "--live-only"]) == 0
    port = _last_json(capsys.readouterr().out)
    assert port["metric"] == ref["metric"] == \
        "multi_resolver_scaling (config 5)"
    assert set(port["results"]) == set(ref["results"]) == {"live_mesh"}
    live, ref_live = port["results"]["live_mesh"], ref["results"]["live_mesh"]
    assert set(live) == set(ref_live) == {"1", "2", "4", "4_broadcast"}
    for S, r in live.items():
        assert set(r) == set(ref_live[S])
        assert len(r["partitions"]) == len(ref_live[S]["partitions"])
        for p, q in zip(r["partitions"], ref_live[S]["partitions"]):
            assert set(p) == set(q)
        assert r["committed"] > 0 and r["routing"] == (S != "4_broadcast")


def _reference_device_plane_keys() -> set:
    """The keys the reference's ``run_mirror``, ``run_verdict_bitmask``
    and ``run_ring_inplace`` put in its line: their dict literals."""
    path = os.path.join(REPO, "foundationdb_tpu", "bench", "device_plane.py")
    tree = ast.parse(open(path).read(), path)
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "run_mirror", "run_verdict_bitmask", "run_ring_inplace"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys.update(k.value for k in node.keys
                                if isinstance(k, ast.Constant))
    return keys


def test_device_plane_main_on_the_cpu(capsys):
    from foundationdb_tpu_torch.bench import device_plane as dp
    assert dp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert set(line) == _reference_device_plane_keys()
    assert line["devplane_verdict_parity"] is True
    assert line["devplane_ring_parity"] is True
    assert line["devplane_ring_mode"] == "cpu"
    assert line["devplane_mirror_sharded_batches"] > 0
    # the launches line a parent adds up: nothing launches on the CPU
    from foundationdb_tpu_torch.bench.stats import LAUNCHES
    launches = [ln for ln in out.err.splitlines() if ln.startswith(LAUNCHES)]
    assert launches
    assert not any(json.loads(launches[-1][len(LAUNCHES):]).values())


# --------------------------------------------------------------------------
# perf_smoke's workload helpers


@pytest.fixture(scope="module")
def smoke():
    from foundationdb_tpu_torch.tools import perf_smoke
    return reference_tool("perf_smoke"), perf_smoke


@pytest.mark.parametrize("n", [9, 30, 2_000_000])
def test_bigkeys_key_fn(smoke, n):
    ref, port = smoke
    a, b = ref.bigkeys_key_fn(n), port.bigkeys_key_fn(n)
    span = range(min(n, 5000))
    assert [a(i) for i in span] == [b(i) for i in span]
    if n < 100:
        assert len({b(i) for i in range(n)}) == n


def _storage(name: str):
    import importlib
    D = importlib.import_module(f"{name}.core.data")
    SS = importlib.import_module(f"{name}.core.storage_server").StorageServer
    TLog = importlib.import_module(f"{name}.core.tlog").TLog
    knobs = importlib.import_module(f"{name}.runtime.knobs").Knobs().override(
        STORAGE_VERSION_WINDOW=1 << 60)
    return SS(knobs, 0, D.KeyRange(b"", b"\xff"), TLog(knobs))


def test_apply_bigkeys_and_packed_scan(smoke):
    ref, port = smoke
    n = 12_000
    got = []
    for mod, name in ((ref, "foundationdb_tpu"),
                      (port, "foundationdb_tpu_torch")):
        ss = _storage(name)

        async def main(mod=mod, ss=ss):
            v, _ = await mod.apply_bigkeys(ss, n, mod.bigkeys_key_fn(n))
            rows = await mod.packed_scan(ss, b"big%012d" % 0,
                                         b"big%012d" % 9000, v, chunk=1000)
            return v, [(bytes(k), bytes(x)) for k, x in rows]
        got.append(asyncio.run(main()))
    assert got[0] == got[1]
    assert got[1][0] == 3 and len(got[1][1]) == 9000


def test_lsm_compact_commits_and_ingest_side(smoke):
    import importlib
    ref, port = smoke
    assert ref.COMPACT_KEYS_PER == port.COMPACT_KEYS_PER
    a = ref.lsm_compact_commits(150, ref.COMPACT_KEYS_PER, 20_000)
    b = port.lsm_compact_commits(150, port.COMPACT_KEYS_PER, 20_000)
    assert a == b
    commits, probes = b
    sides = []
    for mod, name in ((ref, "foundationdb_tpu"),
                      (port, "foundationdb_tpu_torch")):
        lsm = importlib.import_module(f"{name}.storage.lsm")
        before = (lsm._MEMTABLE_BYTES, lsm._BLOCK_BYTES, lsm._MAX_RUNS)
        saved = mod._lsm_compact_geometry(lsm)
        assert saved == before
        geometry = (lsm._MEMTABLE_BYTES, lsm._BLOCK_BYTES, lsm._MAX_RUNS)
        try:
            runs = [asyncio.run(mod.lsm_ingest_side(leveled, commits,
                                                    probes[:64],
                                                    probe_every=50))
                    for leveled in (True, False)]
        finally:
            (lsm._MEMTABLE_BYTES, lsm._BLOCK_BYTES, lsm._MAX_RUNS) = saved
        sides.append((geometry, [
            {k: r[k] for k in ("got", "rows_sha", "n_rows", "write_amp",
                               "compactions", "runs", "levels")}
            for r in runs]))
    assert sides[0] == sides[1]
    leveled, mono = sides[1][1]
    assert leveled["got"] == mono["got"]
    assert leveled["rows_sha"] == mono["rows_sha"]
    assert leveled["compactions"] > 0
