"""The port's Resolver vs the reference Resolver, and the port's imports.

The port's resolver role (``cuda`` backend kind on a CPU device, so the
kernels' plain versions run) and the JAX package's (``tpu`` kind on the
CPU, lanes path) answer the same seeded ResolveBatchRequest streams
submitted concurrently; per-batch verdicts and abort words must be
identical, under asyncio and under each package's own SimEventLoop, with
the endpoint dictionary off and on.
"""

import ast
import asyncio
import os
import re

import numpy as np
import pytest
import torch

from foundationdb_tpu.bench.workload import MakoWorkload
from foundationdb_tpu.core import resolver as ref_resolver
from foundationdb_tpu.runtime import Knobs as RefKnobs
from foundationdb_tpu.runtime import run_simulation as ref_run_simulation
from foundationdb_tpu_torch.core import resolver as port_resolver
from foundationdb_tpu_torch.ops import batch as port_batch
from foundationdb_tpu_torch.runtime import Knobs as PortKnobs
from foundationdb_tpu_torch.runtime import \
    run_simulation as port_run_simulation
from torch_parity import buggify_off  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# small shapes; a ring of 8 slabs that wraps, a window of 2 slabs, and a
# txn-life window wide enough that only eviction raises the floor (the
# floor the pipeline slides depends on how batches were grouped)
SHAPE = dict(RESOLVER_BATCH_TXNS=8, RESOLVER_RANGES_PER_TXN=4,
             KEY_ENCODE_BYTES=16, CONFLICT_RING_CAPACITY=8 * 4 * 8,
             CONFLICT_WINDOW_SLOTS=8 * 4 * 2, CONFLICT_DICT_SLOTS=0,
             RESOLVER_GROUP_BUCKET=4, RESOLVER_GROUP_MAX=8,
             MAX_WRITE_TRANSACTION_LIFE_VERSIONS=10**9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mako_stream(n=40):
    wl = MakoWorkload(n_keys=2000, key_width=16, seed=3)
    return wl.make_batches(n, 8, start_version=10_000,
                           versions_per_batch=100)


def range_stream(n=40, seed=4):
    """Ranges over short keys, some fat txns (more than R ranges: the
    exact C++ sidecar), ~15% of snapshots old enough to go TOO_OLD once
    the ring has wrapped."""
    from foundationdb_tpu.ops.batch import TxnRequest
    g = np.random.default_rng(seed)

    def rng_():
        a = int(g.integers(0, 400))
        return (b"k%05d" % a, b"k%05d" % (a + int(g.integers(1, 6))))

    batches, versions, v = [], [], 10_000
    for _ in range(n):
        v += 100
        txns = []
        for _ in range(int(g.integers(1, 9))):
            fat = g.random() < 0.1
            nr = int(g.integers(5, 9)) if fat else int(g.integers(0, 5))
            nw = int(g.integers(5, 9)) if fat else int(g.integers(0, 5))
            lag = int(g.integers(10, 30)) if g.random() < 0.15 \
                else int(g.integers(1, 4))
            txns.append(TxnRequest([rng_() for _ in range(nr)],
                                   [rng_() for _ in range(nw)],
                                   max(0, v - 100 * lag)))
        batches.append(txns)
        versions.append(v)
    return batches, versions


async def drive(mod, knobs, batches, versions, device):
    res = mod.Resolver(knobs, device=device)
    prev = [0] + versions[:-1]
    reqs = [mod.ResolveBatchRequest(p, v, t)
            for p, v, t in zip(prev, versions, batches)]
    replies = await asyncio.gather(*(res.resolve(r) for r in reqs))
    await res.close()
    return [(r.verdicts, r.abort_words) for r in replies], res.backend


def run_pair(batches, versions, sim: bool, dict_slots: int = 0):
    shape = dict(SHAPE, CONFLICT_DICT_SLOTS=dict_slots)
    ref_knobs = RefKnobs().override(RESOLVER_CONFLICT_BACKEND="tpu", **shape)
    port_knobs = PortKnobs().override(RESOLVER_CONFLICT_BACKEND="cuda",
                                      **shape)
    port_txns = [[port_batch.TxnRequest(t.read_ranges, t.write_ranges,
                                        t.read_snapshot) for t in b]
                 for b in batches]
    ref_main = drive(ref_resolver, ref_knobs, batches, versions, None)
    port_main = drive(port_resolver, port_knobs, port_txns, versions, CPU)
    if sim:
        return (ref_run_simulation(ref_main, seed=9),
                port_run_simulation(port_main, seed=9))
    return asyncio.run(ref_main), asyncio.run(port_main)


# 16384 = 8*R*B*64, the smallest dictionary the backend accepts at SHAPE
@pytest.mark.parametrize("dict_slots", [0, 16384])
@pytest.mark.parametrize("sim", [False, True])
@pytest.mark.parametrize("stream", ["mako", "ranges"])
def test_resolver_matches_reference(stream, sim, dict_slots):
    batches, versions = mako_stream() if stream == "mako" \
        else range_stream()
    (ref, _), (port, backend) = run_pair(batches, versions, sim, dict_slots)
    # the dictionary branch ran, and every group fit it
    assert backend.dict_dispatches > 0 if dict_slots \
        else backend._dict is None
    assert backend.dict_fallbacks == 0
    assert len(ref) == len(port) == len(batches)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"batch {i}"
    codes = {c for v, _ in port for c in v}
    assert 1 in codes                       # conflicts happen
    if stream == "ranges":
        assert 2 in codes                   # and eviction makes TOO_OLD


def test_resolver_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    knobs = PortKnobs().override(**SHAPE)
    assert knobs.RESOLVER_CONFLICT_BACKEND == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_resolver.Resolver(knobs)
    from foundationdb_tpu_torch.ops.backends import make_conflict_backend
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_conflict_backend(knobs)
    assert make_conflict_backend(knobs, device=CPU).cs.device == CPU


# the operator's and the application's entry points and the tools, which
# the scans below must cover
ENTRY_POINTS = [os.path.join(ROOT, "foundationdb_tpu_torch", p) for p in (
    "cli.py", "monitor.py", "capi_host.py", "server.py",
    "bindings/python/fdbtpu.py", "bindings/bindingtester/stack_tester.py",
    "tools/seed_farm.py", "tools/trace_tool.py", "tools/metrics_tool.py",
    "tools/perf_smoke.py", "bench/north_star.py")]


def _port_sources():
    pkg = os.path.join(ROOT, "foundationdb_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _tools_on_sys_path(node: ast.AST) -> bool:
    """A ``sys.path.insert``/``append`` whose argument names ``tools``."""
    f = getattr(node, "func", None)
    return (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
            and f.attr in ("insert", "append")
            and ast.unparse(f.value) == "sys.path"
            and any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                    and c.value.rstrip("/").endswith("tools")
                    for a in node.args for c in ast.walk(a)))


def test_port_imports_nothing_of_jax_or_the_reference():
    # the JAX package, JAX, and the repo-root modules of the reference's
    # benchmark: bench.py and the scripts under tools/
    banned = ("jax", "jaxlib", "foundationdb_tpu", "bench", "perf_smoke",
              "trace_tool", "metrics_tool", "seed_farm")
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if _tools_on_sys_path(node):
                bad.append(f"{os.path.relpath(path, ROOT)}: "
                           f"{ast.unparse(node)}")
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert len(_port_sources()) > 20
    assert set(ENTRY_POINTS) <= set(_port_sources())
    assert not bad, bad


def test_port_c_shim_hosts_the_port_client():
    """The C ABI's shim imports its host module by a string that no scan
    of Python imports sees: it must name the port's ``capi_host`` and no
    module of the JAX package, and so must every other native source."""
    pkg = os.path.join(ROOT, "foundationdb_tpu_torch")
    names = {}
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".cpp", ".cu", ".cuh", ".h", ".c")):
                path = os.path.join(d, f)
                # dotted module names (a comment's file path is no import)
                names[os.path.relpath(path, ROOT)] = set(re.findall(
                    r"foundationdb_tpu\w*(?:\.\w+)+", open(path).read()))
    shim = os.path.join("foundationdb_tpu_torch", "bindings", "c",
                        "fdbtpu_c.cpp")
    assert 'PyImport_ImportModule("foundationdb_tpu_torch.capi_host")' in \
        open(os.path.join(ROOT, shim)).read()
    assert "foundationdb_tpu_torch.capi_host" in names[shim]
    bad = {p: sorted(n for n in ns
                     if n.split(".")[0] != "foundationdb_tpu_torch")
           for p, ns in names.items()}
    assert not {p: n for p, n in bad.items() if n}, bad


def _bound_names(path: str) -> set:
    """The names a module binds at its top level (definitions,
    assignments, imports), including those bound inside top-level
    ``if``/``try`` blocks."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    names.update(n.id for n in ast.walk(t)
                                 if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for h in getattr(node, "handlers", []):
                    visit(h.body)
    visit(ast.parse(open(path).read(), path).body)
    return names


def _module_file(parts: list) -> str | None:
    base = os.path.join(ROOT, *parts)
    for p in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(p):
            return p
    return None


def test_port_has_no_dangling_imports():
    """Every import of the port's own modules, the lazy ones inside
    functions included, names a module of the port that exists and, for
    ``from m import x``, an ``x`` that ``m`` binds or a submodule."""
    pkg = os.path.join(ROOT, "foundationdb_tpu_torch")
    bad, seen = [], 0
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        here = rel[:-3].split(os.sep)
        if here[-1] == "__init__":
            here = here[:-1]
        else:
            here = here[:-1]        # the package the module lies in
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    base = here[:len(here) - (node.level - 1)]
                else:
                    base = []
                mod = base + (node.module.split(".") if node.module else [])
                if mod[:1] != ["foundationdb_tpu_torch"]:
                    continue
                seen += 1
                target = _module_file(mod)
                if target is None:
                    bad.append(f"{rel}:{node.lineno}: no module "
                               f"{'.'.join(mod)}")
                    continue
                names = _bound_names(target)
                for a in node.names:
                    if a.name != "*" and a.name not in names and \
                            _module_file(mod + [a.name]) is None:
                        bad.append(f"{rel}:{node.lineno}: "
                                   f"{'.'.join(mod)} has no {a.name}")
            elif isinstance(node, ast.Import):
                for a in node.names:
                    mod = a.name.split(".")
                    if mod[0] == "foundationdb_tpu_torch":
                        seen += 1
                        if _module_file(mod) is None:
                            bad.append(f"{rel}:{node.lineno}: no module "
                                       f"{a.name}")
    assert os.path.isdir(pkg) and seen > 500
    assert set(ENTRY_POINTS) <= set(_port_sources())
    assert not bad, bad


# the reference's test files that no parity file names in a ``CASES``
# dict: each is held by the parity file named, which runs its scenarios
# or cases another way
HELD_ELSEWHERE = {
    "test_backends.py": ("test_torch_dict.py",
                         "the backend cases, ported beside the dictionary's"),
    "test_bindings.py": ("test_torch_bindings.py",
                         "runs as written through reference_module"),
    "test_btree.py": ("test_torch_storage.py",
                      "the btree engine's restarts and answers, both "
                      "packages under one seed"),
    "test_conflict_jax.py": ("test_torch_conflict.py",
                             "its cases against the port's conflict set"),
    "test_conflict_np.py": ("test_torch_oracle.py",
                            "its traces and cases through both oracles"),
    "test_coordination.py": ("test_torch_coordination.py",
                             "its scenarios on both packages"),
    "test_data_distribution.py": ("test_torch_recovery.py",
                                  "its scenarios on both packages"),
    "test_device_pipeline.py": ("test_torch_read_serve.py",
                                "its device-read tests on both packages"),
    "test_durability.py": ("test_torch_storage.py",
                           "its restarts on both packages"),
    "test_failure_monitor.py": ("test_torch_coordination.py",
                                "its scenarios on both packages"),
    "test_layers_chaos.py": ("test_torch_sim.py",
                             "its chaos scenario as written"),
    "test_lsm.py": ("test_torch_storage.py",
                    "the lsm engine's restarts and answers, both packages "
                    "under one seed"),
    "test_metrics_tool.py": ("test_torch_tools.py",
                             "its scenario against the port's tool"),
    "test_monitor.py": ("test_torch_monitor.py",
                        "runs as written through reference_module"),
    "test_ops_workloads.py": ("test_torch_sim_specs.py",
                              "its spec cases on both packages"),
    "test_perf_smoke.py": ("test_torch_perf_smoke_device.py",
                           "its 17 stages through torch_parity.stage_stats "
                           "in the four test_torch_perf_smoke_* files"),
    "test_pipeline.py": ("test_torch_cluster.py",
                         "its scenarios through the port's Cluster"),
    "test_recovery.py": ("test_torch_recovery.py",
                         "its scenarios on both packages"),
    "test_resolver_mesh.py": ("test_torch_resolver_mesh.py",
                              "every case through hold_to_reference"),
    "test_restarting.py": ("test_torch_sim_specs.py",
                           "every case through hold_to_reference"),
    "test_rpc.py": ("test_torch_rpc.py", "its scenarios on both packages"),
    "test_scrubber.py": ("test_torch_recovery.py",
                         "its scenarios on both packages"),
    "test_server.py": ("test_torch_cli.py",
                       "its multi-process scenarios through "
                       "reference_module, with test_torch_server.py"),
    "test_sharded.py": ("test_torch_sharded.py",
                        "its seeded streams on both packages"),
    "test_sim_harness.py": ("test_torch_sim.py",
                            "every case through hold_to_reference"),
    "test_special_keys.py": ("test_torch_client_layers.py",
                             "its scenarios on both packages"),
    "test_tls.py": ("test_torch_cli.py",
                    "runs as written through reference_module"),
    "test_trace_tool.py": ("test_torch_tools.py",
                           "its scenarios against the port's tool"),
    "test_workloads.py": ("test_torch_workloads.py",
                          "its cases in the four test_torch_workloads* "
                          "files"),
    "test_workloads_r5.py": ("test_torch_workloads_r5.py",
                             "every case on both packages"),
}


def _cases_keys(path: str) -> set:
    """The string keys of the module-level ``...CASES`` dicts of a test
    file: the reference's test files it holds case by case."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Dict):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id.endswith("CASES")
                   for t in targets):
                out |= {k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)}
    return out


def test_every_reference_test_file_is_held():
    """Every test file of the reference (``tests/test_*.py`` but
    ``test_torch_*``) is named in a parity file's ``CASES``, or in
    ``HELD_ELSEWHERE`` with the parity file that runs it, which names
    it; a file the reference gains fails here until a parity file holds
    it."""
    tests = os.path.join(ROOT, "tests")
    files = os.listdir(tests)
    reference = {f for f in files if f.startswith("test_")
                 and f.endswith(".py") and not f.startswith("test_torch_")}
    held = set()
    for f in files:
        if f.startswith("test_torch_") and f.endswith(".py"):
            held |= _cases_keys(os.path.join(tests, f))
    assert not held & set(HELD_ELSEWHERE), held & set(HELD_ELSEWHERE)
    for ref, (port, _) in HELD_ELSEWHERE.items():
        assert ref[:-3] in open(os.path.join(tests, port)).read(), \
            f"{port} does not name {ref}"
    assert not reference - held - set(HELD_ELSEWHERE), \
        sorted(reference - held - set(HELD_ELSEWHERE))
    assert len(reference) > 70 and not (held | set(HELD_ELSEWHERE)) - \
        reference
