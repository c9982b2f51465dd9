"""A clear of rows that live only in a durable engine, read before the
clear itself is durable.

The MVCC window tombstones only the keys it holds.  A row that has
migrated to the engine (older than one window) and is then cleared
stays in the engine until the clear's version becomes durable, and the
reference serves it to every read in between: a stale read, which
``tests/test_perf_smoke.py``'s ``recover`` stage catches when its
recovered cluster is read before the clear is durable (on the card:
the stage failed 17 of 25 runs).  The port's storage server tombstones
those engine rows in the window at the clear's version
(``StorageServer._mask_engine_rows``).

Each test runs an in-process durable cluster (memory engine), makes
five rows durable, stops durability from advancing (a window wider than
any version), clears one row and reads at once.  The clear rides the
packed apply path alone, and the lazy path beside an atomic op.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, one_torch_thread)


def read_after_clear(name: str, lazy: bool) -> dict:
    """Package ``name``'s reads right after clearing a durable row."""
    def m(path):
        return importlib.import_module(f"{name}.{path}")
    Transaction = m("client.transaction").Transaction
    C = m("core.cluster")
    kw = {"device": torch.device("cpu")} if name == PORT else {}

    async def main() -> dict:
        knobs = m("runtime.knobs").Knobs().override(
            STORAGE_VERSION_WINDOW=1_000, STORAGE_DURABILITY_LAG=0.01)
        c = await C.Cluster.create(
            C.ClusterConfig(storage_servers=2), knobs,
            fs=m("runtime.files").SimFileSystem(), data_dir="db", **kw)
        c.start()
        try:
            tr = Transaction(c)
            for i in range(5):
                tr.set(b"k%d" % i, b"v%d" % i)
            v1 = await tr.commit()
            tr.reset()
            while min(s.durable_version for s in c.storage_servers) < v1:
                await asyncio.sleep(0.01)
            # the rows are the engine's; from here nothing more becomes
            # durable, so the clear below stays in the window
            knobs.STORAGE_VERSION_WINDOW = 1 << 62
            engine_rows = [k for k, _ in c.storage_servers[0].engine.range(
                b"k", b"l")]
            tr.clear(b"k2")
            if lazy:
                tr.add(b"ctr", (1).to_bytes(8, "little"))
            await tr.commit()
            tr.reset()
            rows = await tr.get_range(b"k", b"l", snapshot=True)
            point = await tr.get(b"k2", snapshot=True)
            multi = await tr.get_multi([b"k1", b"k2", b"k3"], snapshot=True)
            return {"engine_rows": engine_rows,
                    "range": [k for k, _ in rows], "point": point,
                    "multi": multi}
        finally:
            await c.stop()
    return asyncio.run(main())


@pytest.mark.parametrize("lazy", [False, True], ids=["packed", "lazy"])
def test_clear_masks_engine_rows_on_the_port(lazy):
    got = read_after_clear(PORT, lazy)
    assert got["engine_rows"] == [b"k0", b"k1", b"k2", b"k3", b"k4"]
    assert got["range"] == [b"k0", b"k1", b"k3", b"k4"]
    assert got["point"] is None
    assert got["multi"] == [b"v1", None, b"v3"]


@pytest.mark.parametrize("lazy", [False, True], ids=["packed", "lazy"])
def test_clear_masks_engine_rows_reference_fault(lazy):
    """The reference's known gap (``storage/versioned_map.py``'s module
    docstring), held so that a repair there shows: the cleared row is
    still served."""
    got = read_after_clear(REF, lazy)
    assert got["engine_rows"] == [b"k0", b"k1", b"k2", b"k3", b"k4"]
    assert b"k2" in got["range"]
    assert got["point"] == b"v2"
