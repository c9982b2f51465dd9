"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``foundationdb_tpu`` (the part before the first dot, whole:
``foundationdb_tpu_torch`` begins with ``foundationdb_tpu``), and the
reference and the generator load nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from kvbench_small import REPO, cells, small_root  # noqa: F401


def _child(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(small_root):
    code = f"""
import json, sys, torch
from pathlib import Path
from kvbench import harness, run, spec
root = Path({str(small_root)!r})
bench = spec.load(root)
for cell in {cells()!r}:
    harness.run(bench, spec.cell(bench, cell), 1, 0.3, True,
                torch.device("cpu"), 0.0, root=root)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([run.loaded_banned(), "foundationdb_tpu_torch" in tops]))
"""
    banned, port = json.loads(_child(code))
    assert banned == [] and port


def test_the_reference_loads_nothing_of_the_program(small_root):
    code = f"""
import json, sys
from pathlib import Path
from kvbench import reference, spec, stream
root = Path({str(small_root)!r})
bench = spec.load(root)
for c in bench["configs"]:
    s = stream.build(spec.config(bench, c["name"], root),
                     {{"stream_batches": 4}}, 3, root)
    reference.resolve_stream(s, 5_000_000)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    tops = json.loads(_child(code))
    assert not {"foundationdb_tpu_torch", "foundationdb_tpu", "jax",
                "torch"} & set(tops)


def test_the_banned_names_compare_whole():
    from kvbench import run
    sys.modules.setdefault("foundationdb_tpu_torch", sys.modules[__name__])
    assert "foundationdb_tpu" not in run.loaded_banned()
