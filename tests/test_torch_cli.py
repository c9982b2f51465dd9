"""The port's fdbcli (``foundationdb_tpu_torch.cli``) against the JAX
package's.

The reference's own multi-process scenarios that go through the CLI run
as written against the port (``torch_parity.reference_module``): its
servers are ``python -m foundationdb_tpu_torch.server --device cpu``
processes (the kernels' plain versions), driven over TCP by the port's
``open_cli``, with each scenario's own assertions:
- changing the coordinators through the CLI (tests/test_server.py);
- DR and lock through the CLI, between two clusters;
- SIGKILL of the elected leader's process, then re-election, a new epoch
  and service again through the CLI;
- a TLS cluster served through the CLI that refuses a plaintext client
  (tests/test_tls.py).

Then one ``--exec`` script through both packages' ``Cli`` over each
one's simulated cluster under one seed: every command's output equal,
the status document compared without its host-clock fields.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (ONE_THREAD, PORT, REF,  # noqa: E402,F401
                          SERVER_ON_CPU, api_version_reset, buggify_off,
                          fresh_run, gathered, one_torch_thread,
                          reference_module, status_outcome)


@pytest.mark.parametrize("file,test", [
    ("test_server.py", "test_change_coordinators_through_cli"),
    ("test_server.py", "test_dr_and_lock_through_cli"),
    ("test_server.py", "test_tcp_leader_kill_failover"),
    ("test_tls.py", "test_tls_cluster_serves_and_rejects_plaintext"),
], ids=["change_coordinators", "dr_and_lock", "leader_kill_failover",
        "tls"])
def test_reference_scenario_through_the_port_cli(file, test, tmp_path):
    mod = reference_module(file, PORT, edits=[SERVER_ON_CPU, ONE_THREAD])
    getattr(mod, test)(tmp_path=tmp_path)


SCRIPT = ("set apple 1; set banana 2; set cherry 3; get apple; "
          "getrange a z; getrange a z 2; clear apple; get apple; "
          "get nothing; lock feedface; set locked x; lock other; "
          "unlock other; unlock feedface; set unlocked y; "
          "exclude 10.0.2.9:5000; include 10.0.2.9:5000; coordinators; "
          "status; status json; configure logs=2; frobnicate")


def cli_over_sim(name: str) -> list:
    """``SCRIPT``'s commands, one at a time, through package ``name``'s
    Cli over its 4-machine simulated cluster (the port's on the CPU),
    from a fresh process's state; returns each command's output, the
    status document as ``status_outcome`` gives it."""
    P = importlib.import_module
    cli_mod = P(f"{name}.cli")
    cc = P(f"{name}.core.cluster_client")
    stubs_mod = P(f"{name}.rpc.stubs")
    Knobs = P(f"{name}.runtime.knobs").Knobs
    spec = P(f"{name}.core.cluster_controller").ClusterConfigSpec(
        min_workers=4)
    kw = {"device": torch.device("cpu")} if name == PORT else {}
    fresh_run(name)

    async def main():
        sim = P(f"{name}.sim.cluster_sim").SimulatedCluster(
            Knobs(), n_machines=4, spec=spec, **kw)
        await sim.start()
        await sim.wait_epoch(1)
        t = sim.client_transport()
        coords = sim.coordinator_stubs(t)
        view = cc.RecoveredClusterView(sim.knobs, t,
                                       await cc.fetch_cluster_state(coords))
        cli = cli_mod.Cli(sim.knobs, view, coords,
                          coordinator_factory=lambda addrs:
                          stubs_mod.make_coordinator_stubs(addrs,
                                                           transport=t))
        out = []
        for line in SCRIPT.split(";"):
            got = await cli.execute(line.strip())
            if line.strip() == "status json":
                got = status_outcome(json.loads(got))
            out.append(got)
        await sim.stop()
        return out
    return P(f"{name}.runtime.simloop").run_simulation(main(), seed=5)


def test_cli_script_over_the_simulated_cluster_matches_reference(
        monkeypatch):
    """The script's answers: the port as it is gives the reference's
    outcomes; with its refresh gathered (``torch_parity.gathered``: the
    simulator's schedule the reference's), every answer equals."""
    ref, port = cli_over_sim(REF), cli_over_sim(PORT)
    for out in (ref, port):
        assert out[3] == "`apple' is `1'" and out[-1].startswith("ERROR")
        assert "ERROR" in out[10] and out[14] == "Committed", out
    if port != ref:
        gathered(monkeypatch)
        port = cli_over_sim(PORT)
    assert port == ref
