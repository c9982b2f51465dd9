"""The port's seeded chaos run (``sim/run_one.py``) and the layer stack
under chaos against the JAX package's: the cases of
tests/test_sim_harness.py and tests/test_layers_chaos.py, and the chaos
run's command line.

Each scenario runs on both packages under its own seed, with its own
assertions: as written against the reference, and with its imports
pointed at the port, whose simulated cluster runs the ``cuda`` backend
and the read mirrors on ``torch.device("cpu")`` (the kernels' plain
versions).  Every one of these clusters recovers (machine attrition,
reboots), and after a recovery the port's controller stops the ended
generation's resolvers, an RPC whose draws from the simulated network
shift every later event.  So the port runs twice: as it is, making the
scenario's assertions, and without that retire, held to the reference
exactly: every workload's metrics (``simulate``'s results), every read,
read version and commit version, every cluster state waited for, each
layer's results and the LayerMismatch events traced
(``torch_parity.hold_to_reference``).

Seed 3 of the chaos run fails on the reference: its ConsistencyCheck
finds the two replicas of [b"\\x80", b"\\xff\\xff\\xff") disagreeing on
``\\xff/keyServers/layout`` at virtual time 22.13, after the reboot of
10.1.0.4 in epoch 4.  The cause is a live move whose flip commit was
retried into a new epoch (``test_live_move_flip_is_fenced_on_its_epoch``
below); the port repairs it.  So seed 3 runs as two tests: the port's
run held to the reference test's assertions, and the reference's run
held to its known fault, exactly.
"""

from __future__ import annotations

import json
import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, captured_trace,
                          fresh_run, gathered, hold_to_reference,
                          one_torch_thread, patch_port, results_of,
                          run_reference_test)

HARNESS = "test_sim_harness.py"


@pytest.mark.parametrize("seed", [0, 17])
def test_attrition_clogging_buggify_invariants(seed, monkeypatch):
    ref = hold_to_reference(HARNESS, "test_attrition_clogging_buggify_invariants",
                            monkeypatch, args={"seed": seed}, recovers=True)
    assert results_of(ref, "simulate")[0]["Cycle"]["transactions"] == 60


def test_attrition_clogging_buggify_invariants_seed_3_on_the_port(
        monkeypatch):
    """Seed 3 as the reference test has it, on the port (its simulated
    cluster on the CPU), with the test's own assertions: they hold,
    since the port fences a live move's flip on its epoch."""
    shown = run_reference_test(HARNESS,
                               "test_attrition_clogging_buggify_invariants",
                               PORT, monkeypatch, args={"seed": 3})
    res = results_of(shown, "simulate")[0]
    assert res["Cycle"]["transactions"] == 60
    assert res["ConsistencyCheck"]["shards_checked"] >= 2


def replica_reads(log: dict):
    """A replacement for the reference's ``ConsistencyCheck._check_once``
    that puts every replica's rows it reads into ``log``, keyed by
    (range end, replica index)."""
    from foundationdb_tpu.workloads.consistency import \
        ConsistencyCheckWorkload as CC

    class Replica:
        def __init__(self, rep, i):
            self.rep, self.i = rep, i

        async def get_key_values(self, b, e, version, limit):
            kvs, more = await self.rep.get_key_values(b, e, version, limit)
            log.setdefault((bytes(e), self.i), []).extend(
                (bytes(k), bytes(v)) for k, v in kvs)
            return kvs, more

    def recording(real):
        def storage_for_key(key):
            group = real(key)
            return types.SimpleNamespace(replicas=[
                Replica(r, i) for i, r in
                enumerate(getattr(group, "replicas", [group]))])
        return storage_for_key

    async def check_once(self, _real=CC._check_once):
        cluster = getattr(self.db, "view", None) or self.db.cluster
        cluster.storage_for_key = recording(cluster.storage_for_key)
        try:
            return await _real(self)
        finally:
            del cluster.storage_for_key
    return check_once


def test_attrition_clogging_buggify_invariants_seed_3_reference_fault(
        monkeypatch):
    """Seed 3 on the reference fails, and exactly as recorded: its
    ConsistencyCheck finds the two replicas of [b"\\x80",
    b"\\xff\\xff\\xff") disagreeing on ``\\xff/keyServers/layout`` and on
    nothing else (the live-move flip fault the port repairs, see
    ``test_live_move_flip_is_fenced_on_its_epoch``)."""
    from foundationdb_tpu.workloads.consistency import \
        ConsistencyCheckWorkload
    log: dict = {}
    monkeypatch.setattr(ConsistencyCheckWorkload, "_check_once",
                        replica_reads(log))
    with pytest.raises(AssertionError,
                       match="workload ConsistencyCheck check failed"):
        run_reference_test(HARNESS,
                           "test_attrition_clogging_buggify_invariants",
                           REF, monkeypatch, args={"seed": 3})
    assert (b"\xff\xff\xff", 1) in log
    diverged = {}
    for (end, i), rows in log.items():
        if i:
            a, b = dict(log[(end, 0)]), dict(rows)
            keys = {k for k in a.keys() | b.keys() if a.get(k) != b.get(k)}
            if keys:
                diverged[end] = keys
    assert diverged == {b"\xff\xff\xff": {b"\xff/keyServers/layout"}}


@pytest.mark.parametrize("test", ["test_sim_runs_without_buggify",
                                  "test_storage_machine_reboot_rejoins_with_disk"],
                         ids=["without_buggify", "reboot_rejoins_with_disk"])
def test_sim_scenario_matches_reference(test, monkeypatch):
    hold_to_reference(HARNESS, test, monkeypatch, recovers=True)


def test_layer_checker_under_chaos_matches_reference(monkeypatch):
    """tests/test_layers_chaos.py as written, on both packages: zero
    divergences under chaos, then the canary caught key-exactly."""
    ref = hold_to_reference(
        "test_layers_chaos.py",
        "test_layer_checker_zero_divergences_under_chaos_then_canary",
        monkeypatch, recovers=True)
    assert len(ref["mismatches"]) == 1


def test_live_move_flip_is_fenced_on_its_epoch(monkeypatch):
    """Repro of the reference's seed-3 failure, on the port without the
    resolver retire and with the client's refresh gathered (so event for
    event the reference's run until the repair acts).  Data distribution starts a live move of
    [b"\\x80", b"\\xff\\xff\\xff") to fresh tags 4 and 5 in epoch 2; its
    destinations catch up; a ConfigureDatabase recovery to epoch 3
    rolls the move's "in" journal back to the source team and rejoins
    only tags 0-3, at recovery version 5308162, while tag 5 has already
    applied the ended generation's discarded tail up to 5576422.  The
    flip's transaction, retried through the recovery, committed in
    epoch 3 and made tags 4 and 5 the shard's team; in epoch 4 tag 5
    rejoined from 5576422, past epoch 3's layout writes, and served a
    stale ``\\xff/keyServers/layout``.  The port fences each attempt of
    the flip on the move's epoch (``DataDistributor._commit_layout``):
    the move aborts, and every invariant holds."""
    from foundationdb_tpu_torch.runtime.simloop import run_simulation
    from foundationdb_tpu_torch.sim.run_one import simulate

    fresh_run(PORT)
    with monkeypatch.context() as m, captured_trace(PORT) as events:
        patch_port(m, retire=False, majority=False)
        res = run_simulation(simulate(3, kills=2, buggify=True,
                                      device=torch.device("cpu")), seed=3)
    assert res["ConsistencyCheck"]["shards_checked"] == 2
    assert res["Cycle"]["transactions"] == 60
    aborted = [e for e in events if e.get("Type") == "DDMoveAborted"]
    assert [e.get("Error") for e in aborted] == [
        "MoveAborted('epoch changed before the flip')"]
    assert not [e for e in events if e.get("Type") == "DDMoveComplete"]


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_one_main_on_the_cpu_matches_reference(capsys, monkeypatch):
    """``python -m foundationdb_tpu_torch.sim.run_one --device cpu --seed
    0``: the reference's last line, ``"ok": true`` with every workload's
    results, equal to the reference's own command's; the port's as it
    is, or, where its refresh returning on a majority of coordinators
    moved the schedule, with that refresh gathered
    (``torch_parity.gathered``)."""
    from foundationdb_tpu.sim import run_one as ref_run_one
    from foundationdb_tpu_torch.sim import run_one

    fresh_run(REF)
    assert ref_run_one.main(["--seed", "0"]) == 0
    ref = _last_line(capsys)
    fresh_run(PORT)
    assert run_one.main(["--device", "cpu", "--seed", "0"]) == 0
    port = _last_line(capsys)
    assert port["ok"] is True and port["seed"] == 0
    if port != ref:
        gathered(monkeypatch)
        fresh_run(PORT)
        assert run_one.main(["--device", "cpu", "--seed", "0"]) == 0
        port = _last_line(capsys)
    assert port == ref


def test_run_one_main_needs_the_card_by_default(capsys):
    """``--device cuda`` (the default) runs on the card; without one it
    fails like any run (exit 1, ``"ok": false`` with the reason) and never
    falls back to the CPU."""
    from foundationdb_tpu_torch.sim import run_one

    rc = run_one.main(["--seed", "0", "--kills", "1"])
    line = _last_line(capsys)
    if torch.cuda.is_available():
        assert rc == 0 and line["ok"] is True
    else:
        assert rc == 1 and line["ok"] is False
        assert "no CUDA device" in line["error"]
        assert "results" not in line


@pytest.mark.cuda
def test_chaos_seed_on_the_card_matches_reference(monkeypatch):
    """Chaos seed 17 with every resolver and read mirror on the card:
    the scenario's assertions as it is, and without the retire and with
    the client's refresh gathered, what it showed equals the
    reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t, args = "test_attrition_clogging_buggify_invariants", {"seed": 17}
    cuda = torch.device("cuda")
    ref = run_reference_test(HARNESS, t, REF, monkeypatch, args=args)
    run_reference_test(HARNESS, t, PORT, monkeypatch, device=cuda, args=args)
    card = run_reference_test(HARNESS, t, PORT, monkeypatch, device=cuda,
                              args=args, retire=False, majority=False)
    assert_same(ref, card)
