"""Helpers and fixtures of kvbench's tests: a small copy of the benchmark
(the same cells, configurations and mixes at sizes the CPU holds) under
a temporary root, and the card for the tests marked ``cuda``.  Test
modules import the fixtures they use from here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def shrink(cfg: dict) -> dict:
    """A configuration at a size the CPU holds: 16-txn batches, a ring of
    4096 slots, a window of 256, a small keyspace and dictionary."""
    cfg = json.loads(json.dumps(cfg))
    cfg["batches"]["txns"] = 16
    cfg["knobs"].update(RESOLVER_BATCH_TXNS=16, CONFLICT_RING_CAPACITY=4096,
                        CONFLICT_WINDOW_SLOTS=256)
    sch = cfg["schema"]
    if sch["kind"] == "mako":
        sch["n_keys"] = 2000
        cfg["knobs"]["CONFLICT_DICT_SLOTS"] = 1 << 15
    else:
        sch["warehouses"] = 2
        sch["items"] = 2000
        cfg["knobs"]["CONFLICT_DICT_SLOTS"] = 1 << 18
    return cfg


SMALL_MIX = {"stream_batches": 16, "group_batches": 4,
             "inflight_groups": 2, "warm_passes": 1, "trace_groups": 2}


def make_root(root: Path) -> Path:
    """The repo's benchmark, shrunk, under ``root``: the same names, so
    the harness finds everything as it does in a checkout."""
    for d in ("metrics", "schemas"):
        shutil.copytree(REPO / "kvbench" / d, root / "kvbench" / d)
    (root / "kvbench" / "configs").mkdir()
    (root / "kvbench" / "traffic").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = shrink(json.loads((REPO / c["file"]).read_text()))
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        (root / "kvbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(SMALL_MIX))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cells() -> list[str]:
    return [w["name"] for w in
            json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def small_root(tmp_path) -> Path:
    """The small benchmark under a fresh temporary root."""
    return make_root(tmp_path)


@pytest.fixture
def whole_passes(monkeypatch):
    """A measured window of two whole passes of the stream, however fast
    the CPU runs the plain path, so each check sees every batch's place
    and a fault in one group shows in the next."""
    from kvbench.loop import Loop
    inner = Loop.run

    def run(self, seconds=None, groups=None, span=None):
        if seconds is not None:
            seconds, groups = None, 2 * self.per_pass
        return inner(self, seconds=seconds, groups=groups, span=span)
    monkeypatch.setattr(Loop, "run", run)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "kvbench/tests -m cuda)")
    return torch.device("cuda", 0)
