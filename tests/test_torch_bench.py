"""The port's public-benchmark workloads against the JAX package's.

(a) YCSB workload F (``bench/ycsb.py``, 2000 rows, 16 clients) and TPC-C
    NewOrder (``bench/tpcc.py``, the default schema, 8 clients) through
    both packages under one seed.  Each bench module's ``time`` is
    patched to a clock whose ``perf_counter`` is the simulation loop's
    virtual time, so both runs see the same schedule: the reports must
    be equal apart from ``elapsed_s``, which the virtual clock also fixes
    but is left out as the one wall-clock field;
(b) the abort-parity gate (``bench/abort_parity.py``) at its own
    configuration (``parity_knobs``, 60 batches of 24): the port's
    ``cuda`` kind on the CPU against the reference's ``tpu`` kind, and
    ``numpy`` against ``numpy``, report for report;
(c) the device probe (``bench/tpu_probe.py``) without a card: ``cpu-only``
    and exit 0, as the reference's probe on JAX's CPU;
(d) the command lines: ``--backend cuda`` raises without a card;
(e) the import guard of tests/test_torch_resolver.py covers the modules
    this slice added.

``cuda``-marked twins run the abort-parity gate and a short YCSB run on
the card against the CPU (they skip without one).  Every tolerance is 0.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from torch_parity import buggify_off  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKAGES = ("foundationdb_tpu", "foundationdb_tpu_torch")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_cluster.py's small resolver shapes
SHAPE = dict(RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
             KEY_ENCODE_BYTES=16, CONFLICT_RING_CAPACITY=1 << 12,
             CONFLICT_WINDOW_SLOTS=256, CONFLICT_DICT_SLOTS=0,
             RESOLVER_GROUP_BUCKET=4, RESOLVER_GROUP_MAX=8)
NEW_MODULES = ("core/management.py", "client/special_keys.py",
               "client/tuple.py", "client/subspace.py",
               "client/directory.py", "bench/ycsb.py", "bench/tpcc.py",
               "bench/abort_parity.py", "bench/tpu_probe.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# (a) YCSB-F and TPC-C NewOrder

VIRTUAL_CLOCK = types.SimpleNamespace(
    perf_counter=lambda: asyncio.get_running_loop().time())
RUNS = {
    "ycsb": ("run_ycsb_f", dict(n_rows=2000, n_clients=16, duration_s=0.3,
                                warmup_s=0.1)),
    "tpcc": ("run_tpcc_neworder", dict(n_clients=8, duration_s=0.3,
                                       warmup_s=0.1)),
}


def run_bench(name: str, which: str, device=CPU, seed: int = 3) -> dict:
    """One bench of package ``name`` on the simulation loop's virtual
    clock; the reference on its ``tpu`` backend, the port on ``cuda``
    with ``device``."""
    mod = importlib.import_module(f"{name}.bench.{which}")
    sim = importlib.import_module(f"{name}.runtime.simloop")
    Knobs = importlib.import_module(f"{name}.runtime.knobs").Knobs
    port = name.endswith("_torch")
    knobs = Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda" if port else "tpu", **SHAPE)
    fn, kw = RUNS[which]
    kw = dict(kw, **({"device": device} if port else {}))
    real = mod.time
    mod.time = VIRTUAL_CLOCK
    try:
        return sim.run_simulation(getattr(mod, fn)(knobs, **kw), seed=seed)
    finally:
        mod.time = real


@pytest.mark.parametrize("which", list(RUNS))
def test_bench_report_matches_reference(which):
    ref, port = (run_bench(n, which) for n in PACKAGES)
    ref.pop("elapsed_s")
    port.pop("elapsed_s")
    assert port == ref
    done = port["ops"] if which == "ycsb" else port["new_orders"]
    assert done > 100 and port["aborts"] > 0
    assert set(port["abort_codes"]) <= {"1007", "1020"}
    if which == "tpcc":
        assert port["livelock"] is False and port["tpmC"] > 0


@pytest.mark.cuda
def test_ycsb_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "foundationdb_tpu_torch"
    assert run_bench(name, "ycsb", torch.device("cuda")) == \
        run_bench(name, "ycsb", CPU)


# --------------------------------------------------------------------------
# (b) the abort-parity gate

def parity(name: str, kind: str, device=CPU) -> dict:
    ap = importlib.import_module(f"{name}.bench.abort_parity")
    kw = {"device": device} if name.endswith("_torch") else {}
    return ap.run_parity(ap.parity_knobs(), kind, n_batches=60,
                         batch_size=24, seed=7, **kw)


@pytest.mark.parametrize("kinds", [("tpu", "cuda"), ("numpy", "numpy")],
                         ids=["encoded", "numpy"])
def test_abort_parity_matches_reference(kinds):
    ref = parity(PACKAGES[0], kinds[0])
    port = parity(PACKAGES[1], kinds[1])
    assert port == ref
    assert port["txns_audited"] == 1440 and port["safety_violations"] == 0
    # fat txns ran: the coalescing widened at least one verdict
    assert port["widening_aborts_coalescing"] > 0


@pytest.mark.cuda
def test_abort_parity_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = PACKAGES[1]
    assert parity(name, "cuda", torch.device("cuda")) == \
        parity(name, "cuda", CPU)


# --------------------------------------------------------------------------
# (c) the probe, (d) the command lines


def test_probe_without_a_card_writes_cpu_only(tmp_path, monkeypatch):
    from foundationdb_tpu_torch.bench import tpu_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["tpu_probe", "--out", out])
    assert tpu_probe.main() == 0
    port = json.load(open(out))
    # the reference's probe on JAX's CPU, as its own process
    ref_out = str(tmp_path / "ref.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rc = subprocess.run([sys.executable, "-m",
                         "foundationdb_tpu.bench.tpu_probe", "--out",
                         ref_out], cwd=_REPO, env=env, timeout=300).returncode
    ref = json.load(open(ref_out))
    assert rc == 0 and ref["state"] == port["state"] == "cpu-only"
    assert port["devices"] == ["cpu"]
    tpu_probe.write_status(out, {"state": "error", "error": "x"})
    assert json.load(open(out))["state"] == "error"
    assert not os.path.exists(out + ".tmp")


@pytest.mark.parametrize("which", ["ycsb", "tpcc"])
def test_backend_cuda_raises_without_a_card(which, monkeypatch):
    mod = importlib.import_module(f"foundationdb_tpu_torch.bench.{which}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [which, "--backend", "cuda",
                                      "--seconds", "0.1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


# --------------------------------------------------------------------------
# (e) the import guard


def test_import_guard_covers_the_new_modules():
    from test_torch_resolver import _port_sources
    pkg = os.path.join(_REPO, "foundationdb_tpu_torch")
    scanned = {os.path.relpath(p, pkg) for p in _port_sources()}
    assert set(NEW_MODULES) <= scanned
    for rel in NEW_MODULES:
        src = open(os.path.join(pkg, rel)).read()
        assert "import jax" not in src and "foundationdb_tpu." not in src
