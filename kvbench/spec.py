"""Finding what ``BENCHMARK.json`` names: a cell, its configuration, its
traffic mix, its metrics and the code each of them needs.

Everything is found by name under one root (the checkout):

    BENCHMARK.json                        the cells, configs, metrics
    <config's file>                       a configuration (JSON)
    kvbench/traffic/<traffic>.json        a traffic mix (JSON)
    kvbench/schemas/<kind>.py             the txn generator a config names
    kvbench/metrics/<metric>.py           a metric's reader

so a later cell, mix, configuration or metric is new files and new
entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "config")
    with open(root / entry["file"]) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "kvbench" / "traffic" / f"{_checked(name)}.json") as f:
        return json.load(f)


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``kvbench/<kind>/<name>.py`` under ``root``, loaded from
    its path (a metric's name may hold dots and dashes).  Its relative
    imports resolve against this package."""
    path = root / "kvbench" / kind / f"{_checked(name)}.py"
    # a module name without the metric name's dots, so the loader's
    # parent is the package the relative imports name
    key = f"kvbench.{kind}." + re.sub(r"[.\-]", "_", name)
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__) == path:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = f"kvbench.{kind}"
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` list, and those whose list names the cell."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
