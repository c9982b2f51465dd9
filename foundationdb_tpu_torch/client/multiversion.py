"""Multi-version client — API-version selection and client switching.

Reference: REF:fdbclient/MultiVersionTransaction.actor.cpp +
REF:bindings/c (fdb_select_api_version) — the reference client dlopens
several ``libfdb_c`` versions so one process can talk to clusters running
any protocol version, and every binding must call
``fdb_select_api_version`` exactly once before anything else: the chosen
version gates features and pins compatibility semantics.

The analog here: ``api_version(N)`` must be called once, validates N
against [MIN_API_VERSION, MAX_API_VERSION], and feature-gates the
surface; ``MultiVersionDatabase`` fronts one of the interchangeable
client implementations (the native asyncio client, or the ctypes-over-C
binding) and re-resolves on cluster upgrades (epoch changes) the way the
reference re-dlopens on protocol changes.
"""

from __future__ import annotations

from typing import Any

from ..runtime.errors import FdbError, _err

MIN_API_VERSION = 200
MAX_API_VERSION = 710

ApiVersionInvalid = _err(2200, "api_version_invalid",
                         "API version is not supported")
ApiVersionAlreadySet = _err(2201, "api_version_already_set",
                            "API version may be set only once")
ApiVersionUnset = _err(2202, "api_version_unset",
                       "API version must be set before any other call")

_selected: int | None = None


def api_version(version: int) -> None:
    """Select the API version for this process (fdb_select_api_version).
    Must be called exactly once, before ``open``."""
    global _selected
    if _selected is not None:
        if version == _selected:
            return
        raise ApiVersionAlreadySet()
    if not MIN_API_VERSION <= version <= MAX_API_VERSION:
        raise ApiVersionInvalid()
    _selected = version


def selected_api_version() -> int | None:
    return _selected


def _reset_api_version_for_tests() -> None:
    global _selected
    _selected = None


class FeatureGate:
    """What the selected API version permits — consulted by surfaces that
    changed across versions (the reference hides/renames options the
    same way)."""

    def __init__(self, version: int) -> None:
        self.version = version

    @property
    def versionstamps(self) -> bool:
        return self.version >= 520       # modern 4-byte-offset format

    @property
    def snapshot_ryw(self) -> bool:
        return self.version >= 300


class MultiVersionDatabase:
    """Database facade delegating to a selected client implementation.

    ``flavor`` picks the backing client:
      - "native": this package's client (asyncio, in-process stubs)
      - "c":      the ctypes binding over libfdbtpu_c (bindings/python)
    """

    def __init__(self, flavor: str, target: Any) -> None:
        if _selected is None:
            raise ApiVersionUnset()
        self.features = FeatureGate(_selected)
        self.flavor = flavor
        if flavor == "native":
            self._db = target        # a Database/RefreshingDatabase
        elif flavor == "c":
            import importlib.util
            import os
            path = os.path.join(os.path.dirname(__file__), "..", "..",
                                "bindings", "python", "fdbtpu.py")
            spec = importlib.util.spec_from_file_location("fdbtpu", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._db = mod.open(target)      # target = cluster file path
        else:
            raise ValueError(f"unknown client flavor {flavor!r}")

    def create_transaction(self):
        tr = self._db.create_transaction()
        if self.flavor == "native" and not self.features.versionstamps:
            # feature gate: old API versions had a different stamp format
            # we do not implement — surface a clean error instead of a
            # silently wrong encoding
            def _no_stamp(*a, **kw):
                raise ApiVersionInvalid(
                    "versionstamped operations need api_version >= 520")
            tr.set_versionstamped_key = _no_stamp
            tr.set_versionstamped_value = _no_stamp
        return tr

    async def _call(self, name, *args, **kwargs):
        """Delegate to the inner database, surviving CLUSTER UPGRADES:
        when the cluster publishes a new protocol version, the pinned
        native view raises cluster_version_changed; re-resolve (the
        analog of dlopening the matching libfdb_c) and retry
        (REF:fdbclient/MultiVersionTransaction.actor.cpp
        MultiVersionDatabase protocol-version monitor).  Accepts both
        the native client's coroutines and the ctypes-over-C binding's
        synchronous methods, preserving each one's return value."""
        import asyncio
        while True:
            try:
                r = getattr(self._db, name)(*args, **kwargs)
                return await r if asyncio.iscoroutine(r) else r
            except FdbError as e:
                if e.code != 1039 or self.flavor != "native":
                    raise
                await self._re_resolve()

    # run + the convenience surface all route through _call, so every
    # entry point — not just explicit run() callers — survives upgrades

    def run(self, fn):
        return self._call("run", fn)

    def get(self, key):
        return self._call("get", key)

    def set(self, key, value):
        return self._call("set", key, value)

    def clear(self, key):
        return self._call("clear", key)

    def clear_range(self, begin, end):
        return self._call("clear_range", begin, end)

    def get_range(self, begin, end, **kwargs):
        return self._call("get_range", begin, end, **kwargs)

    async def _re_resolve(self) -> None:
        """Adopt the cluster's published protocol: re-pin the view's
        knobs to it and rebuild the stub set from the fresh state."""
        from ..core.cluster_client import fetch_cluster_state
        from ..runtime.trace import TraceEvent
        state = await fetch_cluster_state(self._db.coordinators)
        old = self._db.view.knobs.PROTOCOL_VERSION
        self._db.view.knobs = self._db.view.knobs.override(
            PROTOCOL_VERSION=state.get("protocol", old))
        self._db.view.update(state)
        TraceEvent("MultiVersionClientSwitched").detail("From", old) \
            .detail("To", self._db.view.knobs.PROTOCOL_VERSION).log()

    def __getattr__(self, name: str):
        return getattr(self._db, name)
