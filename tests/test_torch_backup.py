"""The port's backup, point-in-time restore and task bucket against the
JAX package's.

Each scenario of the reference's own tests (tests/test_backup.py,
test_backup_feed.py, test_backup_pitr.py and test_task_bucket.py) runs
twice under its own seed: as written against the reference (``numpy``
backend), and with its imports pointed at the port, whose clusters run
the ``cuda`` backend on ``torch.device("cpu")`` so the kernels' plain
versions answer.  Both runs make the reference's own assertions.  Then
what each showed is held equal, exactly: every read, read version and
commit version its transactions returned, every cluster state it waited
for, every result of the backup agent, the container and the task
bucket, and the bytes of every simulated disk (the backup containers
and the machines' disks).
"""

from __future__ import annotations

import asyncio
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, reference_cases,
                          run_reference_test)

CASES = {
    "test_backup.py": [
        "test_backup_restore_roundtrip",
        "test_backup_is_consistent_cut_under_writes",
        "test_restore_requires_manifest"],
    "test_backup_feed.py": [
        "test_pack_rows_roundtrip",
        "test_container_snapshot_and_log_roundtrip",
        "test_container_detects_torn_frame",
        "test_agent_kill_resume_exactly_once",
        "test_restore_resumes_after_crash",
        "test_restore_to_version_picks_snapshot_at_or_below",
        "test_database_backup_api_and_status_rollup",
        "test_sim_restore_to_version_byte_identical_under_chaos"],
    "test_backup_pitr.py": [
        "test_pitr_restore_to_exact_version",
        "test_pitr_torn_transaction_consistency",
        "test_continuous_backup_survives_recovery",
        "test_restore_refuses_coverage_hole_below_log",
        "test_backup_reactivation_captures_new_stream"],
    "test_task_bucket.py": [
        "test_concurrent_agents_execute_each_task_once",
        "test_expired_lease_requeues_crashed_agents_task",
        "test_future_parks_task_until_set",
        "test_add_after_already_fired_future_runs_immediately",
        "test_two_adds_in_one_transaction_both_survive",
        "test_sweep_releases_parks_under_fired_future",
        "test_lease_extension_keeps_task_claimed"],
}

# Scenarios whose cluster recovers: after the first recovery the port's
# controller stops the ended generation's resolvers (the reference never
# does), and that RPC's draws from the simulated network shift every
# later event.  These run the port twice: as it is, with the reference's
# assertions, and without the retire, held to the reference event for
# event.
RECOVERS = {"test_sim_restore_to_version_byte_identical_under_chaos"}


@pytest.mark.parametrize("file,test", reference_cases(CASES))
def test_scenario_matches_reference(file, test, monkeypatch):
    hold_to_reference(file, test, monkeypatch, recovers=test in RECOVERS)


def _mutations(seed: int, n: int):
    """``n`` seeded (version, [(type, key, value)]) entries of sets,
    clears and atomic adds over a small key space."""
    g = np.random.default_rng(seed)
    out, v = [], 1000
    for _ in range(n):
        v += int(g.integers(1, 50))
        muts = []
        for _ in range(int(g.integers(1, 6))):
            k = b"key%03d" % int(g.integers(0, 64))
            kind = int(g.integers(0, 3))
            if kind == 0:
                muts.append(("set", k, bytes(g.integers(
                    0, 256, size=int(g.integers(0, 40)), dtype=np.uint8))))
            elif kind == 1:
                muts.append(("clear_range", k, k + b"\xff"))
            else:
                muts.append(("add", k, int(g.integers(0, 1 << 31))
                             .to_bytes(8, "little")))
        out.append((v, muts))
    return out


async def _container_files(name: str, seed: int) -> dict:
    import importlib
    cont = importlib.import_module(f"{name}.backup.container")
    data = importlib.import_module(f"{name}.core.data")
    files = importlib.import_module(f"{name}.runtime.files")
    fs = files.SimFileSystem()
    c = cont.BackupContainer(fs, "bk")
    await c.init()
    g = np.random.default_rng(seed)
    rows = sorted({b"row%05d" % int(i): bytes(g.integers(
        0, 256, size=int(g.integers(0, 200)), dtype=np.uint8))
        for i in g.integers(0, 100000, size=700)}.items())
    names, nbytes = [], 0
    for i in range(0, len(rows), 250):
        name_, n = await c.write_snapshot_page(900, i // 250,
                                               rows[i:i + 250])
        names.append(name_)
        nbytes += n
    await c.finish_snapshot(900, names, len(rows), nbytes)
    entries = []
    for v, muts in _mutations(seed, 40):
        ms = [data.Mutation(data.MutationType.ADD, a, b) if kind == "add"
              else getattr(data.Mutation, kind)(a, b)
              for kind, a, b in muts]
        entries.append((v, data.MutationBatch.from_mutations(ms)))
    lname, _ = await c.write_log_file(entries[0][0], entries[-1][0], 0,
                                      entries)
    await c.save_log_manifest({"feed": b"f", "begin": 900,
                               "through": entries[-1][0],
                               "files": [[entries[0][0], entries[-1][0],
                                          lname]],
                               "bytes": 1, "stopped": True})
    return {"disks": {p: bytes(b) for p, b in fs.disks.items()},
            "digest": cont.keyspace_digest(rows),
            "pages": [await c.read_snapshot_page(n) for n in names],
            "log": [(v, bytes(b.blob)) for v, b in
                    await c.read_log_file(lname)],
            "describe": await c.describe()}


@pytest.mark.parametrize("seed", [0, 1])
def test_container_files_match_reference(seed):
    """Snapshot pages, a mutation-log file and the manifests written by
    the port for the same seeded rows and mutations: byte for byte the
    reference's files, and the same keyspace digest."""
    ref = asyncio.run(_container_files(REF, seed))
    port = asyncio.run(_container_files(PORT, seed))
    assert sorted(port["disks"]) == sorted(ref["disks"])
    assert len(port["disks"]) >= 6
    for p in ref["disks"]:
        assert port["disks"][p] == ref["disks"][p], p
    assert port == ref


def test_database_backup_api_on_the_port():
    """``Database.start_backup``, ``stop_backup`` and ``restore`` on the
    port's in-process cluster on the CPU: a continuous backup, writes
    after its snapshot, and a point-in-time restore into a fresh cluster
    to the middle of the writes and to the end."""
    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.core.cluster import Cluster, ClusterConfig
    from foundationdb_tpu_torch.runtime.files import SimFileSystem
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.simloop import run_simulation
    cpu = torch.device("cpu")

    async def main():
        fs, k = SimFileSystem(), Knobs()
        expected = {}
        async with Cluster(ClusterConfig(), k, device=cpu) as cluster:
            db = Database(cluster)
            base = {b"b%04d" % i: b"v%d" % i for i in range(200)}

            async def fill(tr):
                for key, v in base.items():
                    tr.set(key, v)
            await db.run(fill)
            await db.start_backup(fs, "bk/api")
            versions = []
            for j in range(20):
                tr = db.create_transaction()
                tr.set(b"b%04d" % (j * 7), b"w%d" % j)
                versions.append(await tr.commit())
            mid = versions[9]
            expected["mid"] = dict(base)
            expected["mid"].update({b"b%04d" % (j * 7): b"w%d" % j
                                    for j in range(10)})
            expected["end"] = dict(base)
            expected["end"].update({b"b%04d" % (j * 7): b"w%d" % j
                                    for j in range(20)})
            frontier = await db.stop_backup("bk/api")
            assert frontier >= versions[-1]
        got = {}
        for name, to in (("mid", mid), ("end", None)):
            async with Cluster(ClusterConfig(), k, device=cpu) as c2:
                db2 = Database(c2)
                await db2.restore(fs, "bk/api", to_version=to)
                got[name] = dict(await db2.get_range(b"", b"\xff", limit=0))
        return expected, got

    expected, got = run_simulation(main(), seed=5)
    assert got == expected


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_pitr_on_the_card_matches_reference(monkeypatch):
    """The point-in-time restore scenario with the port's resolvers and
    read mirrors on the card: what it showed, with the client's refresh
    gathered (``torch_parity.gathered``), equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f, t = "test_backup_pitr.py", "test_pitr_restore_to_exact_version"
    ref = run_reference_test(f, t, REF, monkeypatch)
    card = run_reference_test(f, t, PORT, monkeypatch,
                              device=torch.device("cuda"), majority=False)
    assert_same(ref, card)
