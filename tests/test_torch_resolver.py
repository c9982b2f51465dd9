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


def _port_sources():
    pkg = os.path.join(ROOT, "foundationdb_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_nothing_of_jax_or_the_reference():
    banned = ("jax", "jaxlib", "foundationdb_tpu")
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
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
    assert not bad, bad
