"""The port's tools (``foundationdb_tpu_torch/tools/``) against the JAX
package's (``tools/``).

- The seed farm at ``--jobs 2 --device cpu`` over seeds 0 and 1: each
  seed's result (the child ``sim.run_one``'s last line) and the failure
  buckets equal to the reference farm's, each child's client refresh
  gathered (``gathered_children``, as ``torch_parity.gathered`` does in
  process; ROADMAP C3).
- tests/test_trace_tool.py's and tests/test_metrics_tool.py's scenarios
  as written on both packages (``torch_parity.hold_to_reference``), the
  port's with the port's trace and metrics tools and its simulated
  cluster on the CPU; then both packages' tools over one trace file give
  equal reports.
- The resolve stage of the perf smoke: the port's ``cuda`` backend on
  ``torch.device("cpu")`` (the kernels' plain versions) through the
  DevicePipeline and the unpipelined loop gives verdicts equal to the
  ``numpy`` twin's and to the reference's device pipeline over the same
  ``_resolve_workload(96, 16, 2, 1234)``, with TOO_OLD verdicts among
  them.  No timing floor is held here: the A/B is a measurement of the
  card (``chip_smoke.py`` phase 27, and its ``cuda``-marked twin here).

Tolerance 0 everywhere: these are integers and bytes.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, api_version_reset,  # noqa: E402,F401
                          buggify_off, hold_to_reference, one_torch_thread,
                          reference_cases)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _summary(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


# sim.run_one as ``python -m`` runs it, with the client's refresh and the
# election rounds waiting for every coordinator, as the reference's do
GATHERED_RUN_ONE = (
    "import runpy\n"
    "from foundationdb_tpu_torch.core import coordination\n"
    "coordination.MAJORITY_ROUNDS = False\n"
    "runpy.run_module('foundationdb_tpu_torch.sim.run_one', "
    "run_name='__main__')\n")


def gathered_children(mp, farm) -> None:
    """The port's seed farm ``farm`` starting each child as
    ``GATHERED_RUN_ONE``: a refresh that returns on a majority of
    coordinators moves the simulator's schedule, so the children's
    results are held to the reference's with it gathered."""
    module = ["-m", "foundationdb_tpu_torch.sim.run_one"]

    def run(cmd, **kw):
        assert cmd[1:3] == module, cmd
        return subprocess.run([cmd[0], "-c", GATHERED_RUN_ONE, *cmd[3:]],
                              **kw)
    mp.setattr(farm, "subprocess", types.SimpleNamespace(
        run=run, TimeoutExpired=subprocess.TimeoutExpired))


def test_seed_farm_matches_reference(tmp_path, monkeypatch, capsys):
    ref_farm = reference_tool("seed_farm")
    ref_runs = []

    def recorded(*a, _run=ref_farm.run_seed, **kw):
        r = _run(*a, **kw)
        ref_runs.append(r)
        return r
    monkeypatch.setattr(ref_farm, "run_seed", recorded)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", ["seed_farm.py", "--seeds", "2",
                                      "--jobs", "2"])
    ref_farm.main()
    ref = _summary(capsys)

    from foundationdb_tpu_torch.tools import seed_farm
    gathered_children(monkeypatch, seed_farm)
    out = tmp_path / "seeds.jsonl"
    seed_farm.main(["--seeds", "2", "--jobs", "2", "--device", "cpu",
                    "--out", str(out)])
    port = _summary(capsys)
    runs = [json.loads(line) for line in out.read_text().splitlines()]

    def result(r):
        return {k: v for k, v in r.items() if k != "elapsed"}
    assert port["device"] == "cpu" and port["seeds_per_minute"] > 0
    assert [r["seed"] for r in runs] == [0, 1]
    assert all(r["ok"] and r["results"] for r in runs)
    assert [result(r) for r in runs] == sorted(
        (result(r) for r in ref_runs), key=lambda r: r["seed"])
    for k in ("seeds", "ok", "failed", "failure_buckets"):
        assert port[k] == ref[k], k


def test_seed_farm_needs_the_card_by_default(monkeypatch):
    """Without a card the default ``--device cuda`` farm stops before it
    starts a child; it never runs the seeds on the CPU instead."""
    from foundationdb_tpu_torch.tools import seed_farm
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    started = []
    monkeypatch.setattr(seed_farm, "run_seed",
                        lambda *a, **kw: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seed_farm.main(["--seeds", "1", "--jobs", "1"])
    assert started == []


# the scenarios' own imports of the tools, pointed at the port's
TOOL_EDITS = {
    "test_trace_tool.py": ("import trace_tool\n",
                           f"from {PORT}.tools import trace_tool\n"),
    "test_metrics_tool.py": ("import metrics_tool  # noqa: E402\n",
                             f"from {PORT}.tools import metrics_tool\n"),
}
TOOL_CASES = reference_cases({
    "test_trace_tool.py": [
        "test_span_envelope_wire_roundtrip",
        "test_dispatcher_reactivates_span_context",
        "test_transport_attach_only_wraps_sampled",
        "test_trace_tool_reconstruct_and_rank",
        "test_trace_tool_rolled_paths",
        "test_sim_trace_reconstructs_cross_role_timeline",
        "test_backup_restore_and_fetchkeys_spans_pair"],
    "test_metrics_tool.py": ["test_metrics_tool_views_from_trace_file_alone"],
})


@pytest.mark.parametrize("file,test", TOOL_CASES)
def test_tool_scenario_matches_reference(file, test, tmp_path, monkeypatch):
    def args(mod):
        """A directory of each run's own for a scenario that takes one."""
        if "tmp_path" not in inspect.signature(getattr(mod, test)).parameters:
            return {}
        return {"tmp_path": pathlib.Path(tempfile.mkdtemp(dir=tmp_path))}
    # the metrics scenario requests a recovery
    hold_to_reference(file, test, monkeypatch, args=args,
                      recovers=file == "test_metrics_tool.py",
                      port_edits=[TOOL_EDITS[file]])


def test_tools_report_one_trace_file_alike(tmp_path):
    """Both packages' trace and metrics tools over the trace file of
    tests/test_metrics_tool.py's recorded simulation: every report
    equal."""
    from foundationdb_tpu_torch.tools import metrics_tool, trace_tool
    ref_metrics = reference_tool("metrics_tool")
    ref_trace = reference_tool("trace_tool")
    import test_metrics_tool
    path = str(tmp_path / "trace.jsonl")
    test_metrics_tool._record_sim(path)
    events = metrics_tool._load([path])
    assert events == ref_metrics._load([path]) and len(events) > 100
    for fn in ("summarize", "lag_report", "recovery_report", "scrub_report",
               "layers_report"):
        assert getattr(metrics_tool, fn)(events) == \
            getattr(ref_metrics, fn)(events), fn
    assert metrics_tool.diff_report(events, events) == \
        ref_metrics.diff_report(events, events)
    assert trace_tool.analyze(events) == ref_trace.analyze(events)


# --------------------------------------------------------------------------
# the resolve stage


def reference_verdicts(n_batches: int, batch_txns: int) -> list[int]:
    """The reference's device pipeline (its ``tpu`` backend, on the CPU)
    over its own ``_resolve_workload(n_batches, batch_txns, 2, 1234)`` at
    its resolve stage's knobs."""
    import jax

    from foundationdb_tpu.device.pipeline import DevicePipeline
    from foundationdb_tpu.ops.backends import make_conflict_backend
    from foundationdb_tpu.runtime.knobs import Knobs
    perf_smoke = reference_tool("perf_smoke")
    batches, versions = perf_smoke._resolve_workload(n_batches, batch_txns,
                                                     2, 1234)
    knobs = Knobs().override(
        RESOLVER_BATCH_TXNS=batch_txns, RESOLVER_RANGES_PER_TXN=2,
        CONFLICT_RING_CAPACITY=2048, KEY_ENCODE_BYTES=16,
        CONFLICT_WINDOW_SLOTS=64, MAX_WRITE_TRANSACTION_LIFE_VERSIONS=400,
        RESOLVER_CONFLICT_BACKEND="tpu")

    async def run():
        pipe = DevicePipeline(make_conflict_backend(knobs), knobs)
        futs = [pipe.submit(t, v) for t, v in zip(batches, versions)]
        rows = [await f for f in futs]
        await pipe.close()
        return [x for r in rows for x in r]
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return asyncio.run(run())
    finally:
        jax.config.update("jax_enable_x64", was)


def test_resolve_stage_verdicts_match_reference():
    from foundationdb_tpu_torch.ops.batch import TOO_OLD
    from foundationdb_tpu_torch.tools import perf_smoke as ps
    cpu = torch.device("cpu")
    n, b = ps.RESOLVE_BATCHES, ps.RESOLVE_TXNS
    knobs = ps.resolve_knobs(b)
    batches, versions = ps._resolve_workload(n, b, 2, 1234)
    work = (knobs, batches, versions, cpu)
    twin = ps.flat(asyncio.run(ps.run_pipe("numpy", *work))[0])
    rows, _, metrics = asyncio.run(ps.run_pipe("cuda", *work))
    port = ps.flat(rows)
    assert len(port) == n * b and metrics["device_dispatches"] > 0
    assert port == twin
    # the unpipelined loop slides its floor a batch later: it is held to
    # the twin's run of the same loop
    assert ps.flat(asyncio.run(ps.run_serial("cuda", *work))[0]) == \
        ps.flat(asyncio.run(ps.run_serial("numpy", *work))[0])
    assert sum(1 for x in port if x == TOO_OLD) > 0
    assert port == reference_verdicts(n, b)


@pytest.mark.cuda
def test_resolve_stage_on_the_card():
    """``chip_smoke.py`` phase 27's gates: verdicts equal to the twin's,
    TOO_OLD verdicts, K1 = K3 > 0, every K1 and K3 call equal to its
    plain version on its own tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    cs.check_resolve_stage(cs.resolve_stage_phase(torch.device("cuda")))
