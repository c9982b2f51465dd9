"""The port's north-star bench (``foundationdb_tpu_torch/bench/north_star.py``)
against the reference's (``bench.py`` at the repo root).

- The resolver stage at the reference's ``--quick`` shape (40 batches of
  64 mako txns over 100000 keys): the port's ``run`` with the ``cuda``
  backend on ``torch.device("cpu")`` (the kernels' plain versions)
  against ``bench.run`` with the ``tpu`` backend on JAX's CPU, on the
  same batches: abort rates, verdict parity, every ``*_matches_serial``
  and the device pipeline's grouping equal.
- ``--device cpu --quick`` as a subprocess: exit 0, one JSON line, its
  keys the reference's ``--quick --cpu`` line's with ``tpu`` renamed
  ``cuda``.  Without a card and without ``--device cpu``: a non-zero
  exit and an ``error`` key, never a ``value`` or a ``cpu_twin_*`` key.
- Every function of ``bench.py`` has its namesake in the port, and the
  keys each one writes into the JSON line (its dict literals and
  subscript assignments) are the reference's, renamed.
- Each host stage on the CPU, small through its keyword sizes, with its
  own gates holding and its keys the reference stage's.

Tolerance 0 everywhere: these are counts, verdicts and keys.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench as ref_bench  # noqa: E402  (the reference's bench.py)

from foundationdb_tpu_torch.bench import north_star as ns  # noqa: E402
from torch_parity import buggify_off, one_torch_thread  # noqa: E402,F401

CPU = torch.device("cpu")


def renamed(keys) -> set:
    return {k.replace("tpu", "cuda") for k in keys}


def child_env() -> dict:
    # one torch thread a process: the CPU tests run several at once
    return dict(os.environ, OMP_NUM_THREADS="1")


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_resolver_stage_matches_reference():
    jax.config.update("jax_enable_x64", True)
    ref = ref_bench.run(40, 64, 100_000, True, None)
    port = ns.run(40, 64, 100_000, True, CPU)
    assert (port["parity"], port["mismatches"]) == (True, 0)
    assert (ref["parity"], ref["mismatches"]) == (True, 0)
    for kind, ref_kind in (("cpp", "cpp"), ("cuda", "tpu")):
        p, r = port["results"][kind], ref["results"][ref_kind]
        assert set(p) == set(r)
        for k in ("abort_rate", "pipelined_matches_serial",
                  "grouped_matches_serial", "device_pipeline_matches_serial",
                  "pipeline_depth", "pipeline_group_mean",
                  "pipeline_dispatches"):
            assert p.get(k) == r.get(k), (kind, k, p.get(k), r.get(k))
        assert p["pipelined_matches_serial"] and p["grouped_matches_serial"]
    assert port["results"]["cuda"]["device_pipeline_matches_serial"]


def test_main_quick_on_the_cpu_prints_the_reference_keys():
    port = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.bench.north_star",
         "--device", "cpu", "--quick", "-q"], cwd=REPO, env=child_env(),
        capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    assert len(port.stdout.strip().splitlines()) == 1
    line = last_json(port.stdout)
    ref = subprocess.run(
        [sys.executable, "bench.py", "--quick", "--cpu", "-q"], cwd=REPO,
        env=dict(child_env(), JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert set(line) == renamed(last_json(ref.stdout))
    assert line["verdict_parity"] is True and line["verdict_mismatches"] == 0
    assert line["backend_used"] == "cpu" and line["value"] is None
    assert line["cpu_twin_commits_per_sec"] > 0
    assert line["metric"].endswith("cuda kernel)")


def test_without_a_card_the_run_ends_with_an_error():
    env = dict(child_env(), CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.bench.north_star",
         "--quick", "--probe-wait", "120"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    line = last_json(p.stdout)
    assert "error" in line and "value" not in line
    assert not [k for k in line if k.startswith("cpu_twin")]


# --------------------------------------------------------------------------
# the JSON line's keys, function by function


def _keys_written(fn: ast.AST) -> set:
    """The string keys a function writes: its dict literals' and its
    subscript assignments' (f-string keys as their source)."""
    def key(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return ast.unparse(node)
        return None

    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            out.update(k for k in map(key, node.keys) if k is not None)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and key(t.slice):
                    out.add(key(t.slice))
    return out


def _functions(path: str) -> dict:
    tree = ast.parse(open(path).read(), path)
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_every_function_keeps_the_reference_keys():
    ref = _functions(os.path.join(REPO, "bench.py"))
    port = _functions(ns.__file__)
    missing = sorted(set(ref) - set(port))
    assert not missing, missing
    for name, fn in ref.items():
        assert _keys_written(port[name]) == renamed(_keys_written(fn)), name


# --------------------------------------------------------------------------
# the host stages, small


def _gates(name: str, r: dict, size: dict) -> None:
    """The stage's own gates, where its line says what held."""
    if name == "feed_tail":
        assert r["feed_txns"] == size["n_txns"]
        assert r["feed_mutations_seen"] == size["n_txns"]
    elif name == "read_point":
        assert r["read_n_samples"] > 0 and r["multiget_keys_per_sec"] > 0
    elif name == "scan":
        assert r["scan_n_samples"] > 0 and r["scan_rows_per_sec"] > 0
    elif name == "bigkeys":
        assert r["bigkeys_rows"] == size["n_rows"]
    elif name == "lsm_ingest":
        assert r["lsm_ingest_rows"] > 0 and r["lsm_compactions"] > 0
    elif name == "hot_shard":
        assert r["hot_shard_reads_before"] > 0
    elif name == "backup_restore":
        assert r["restore_verified"] is True
        assert r["backup_snapshot_rows"] >= size["n_rows"]
    elif name == "tpcc_district":
        assert r["tpcc_district_throttle_tpmC_off"] is not None
    elif name == "layers":
        assert r["layers_checker_divergences"] == 0
        assert r["layers_stale_reads"] == 0
        assert r["layers_reads"] + r["layers_writes"] == size["n_ops"]


STAGES = {
    "feed_tail": dict(n_txns=60, n_clients=4),
    "read_point": dict(n_rows=2000, point_clients=4, mg_clients=2,
                       duration_s=0.5),
    "scan": dict(n_rows=2000, scan_clients=4, duration_s=0.5, sweeps=1),
    "bigkeys": dict(n_rows=20_000, n_point=256, scan_rows=5000),
    "lsm_ingest": dict(n_commits=200, keyspace=20_000, n_probes=64),
    "hot_shard": dict(n_keys=2000, writers_n=2, readers_n=2, window_s=1.0,
                      split_wait_s=3.0, warmup_s=0.5, settle_s=0.5),
    "backup_restore": dict(n_rows=2000, n_writers=2, write_s=1.0),
    "tpcc_district": dict(duration_s=1.0, n_clients=4),
    "layers": dict(n_keys=100, n_ops=300, n_watches=4),
}


@pytest.mark.parametrize("name", list(STAGES))
def test_host_stage_small_on_the_cpu(name):
    fn = getattr(ns, f"run_{name}_phase")
    size = STAGES[name]
    kw = dict(size) if name == "lsm_ingest" else dict(size, device=CPU)
    r = fn(True, **kw)
    ref_fn = _functions(os.path.join(REPO, "bench.py"))[f"run_{name}_phase"]
    # "i" keys the hot-shard stage's measuring-window flag, not its line
    assert set(r) == renamed(_keys_written(ref_fn)) - {"i"}
    _gates(name, r, size)
