"""Spec-file-driven simulation tests, including restart/upgrade specs.

Reference: REF:tests/fast/*.toml + REF:tests/restarting/ — the reference
defines simulation tests as declarative spec files (workload lists +
knobs), and its *restarting* tier runs a test in two halves: part 1
against the old binary, then the cluster is stopped, restarted under a
NEW binary/protocol version, and part 2 must find everything intact.

A spec here is TOML:

    [config]
    machines = 5
    replication = 2
    durableStorage = true
    buggify = false

    [[test]]                    # phase 1 workloads (run concurrently)
    testName = "Cycle"
    nodeCount = 10

    [restart]                   # optional: the restarting/upgrade step
    protocolBump = true         # restart as a "new binary"

    [[restart.test]]            # phase 2, after the restart
    testName = "ConsistencyCheck"

With a ``[restart]`` section the runner: quiesces phase 1, snapshots the
whole committed keyspace, power-kills EVERY machine (unsynced writes
lost), restarts them under a bumped PROTOCOL_VERSION, verifies the
snapshot readable byte-for-byte through a NEW client AND through the
multi-version client created BEFORE the upgrade (which must re-resolve
across the protocol change, while a pinned single-version view raises
cluster_version_changed), then runs phase 2.
"""

from __future__ import annotations

try:                            # tomllib is stdlib only from py3.11
    import tomllib
except ModuleNotFoundError:     # py3.10: the same parser's PyPI name
    try:
        import tomli as tomllib
    except ModuleNotFoundError:
        tomllib = None          # last resort: the minimal parser below

from ..core.cluster_controller import ClusterConfigSpec
from ..runtime.buggify import enable_buggify
from ..runtime.errors import FdbError
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from ..workloads.workload import run_workloads_on


def load_spec(path: str) -> dict:
    with open(path, "rb") as f:
        blob = f.read()
    if tomllib is not None:
        return tomllib.loads(blob.decode("utf-8"))
    return _parse_spec_toml(blob.decode("utf-8"))


def _parse_value(s: str):
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_parse_value(x) for x in _split_top(inner)] if inner else []
    if s in ("true", "false"):
        return s == "true"
    if len(s) >= 2 and s[0] in "\"'" and s[-1] == s[0]:
        return s[1:-1]
    try:
        return int(s)
    except ValueError:
        return float(s)


def _strip_comment(s: str) -> str:
    """Cut a trailing ``# comment`` outside quotes (quote-aware, so a
    '#' inside a quoted string or an array of strings survives)."""
    quote = None
    for i, ch in enumerate(s):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return s[:i]
    return s


def _split_top(s: str) -> list[str]:
    """Split an inline array body on top-level commas."""
    out, depth, cur, quote = [], 0, [], None
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == "[":
            depth += 1
            cur.append(ch)
        elif ch == "]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur and "".join(cur).strip():
        out.append("".join(cur))
    return out


def _parse_spec_toml(text: str) -> dict:
    """Minimal TOML-subset parser covering the sim spec files: comments,
    ``[table]`` / ``[[array.of.tables]]`` headers with dotted names, and
    ``key = value`` where value is a string, int, float, bool, or an
    inline array of those.  Used only when neither tomllib nor tomli is
    importable (old interpreter, bare image)."""
    root: dict = {}
    cur = root

    def descend(parts: list[str]) -> dict:
        node = root
        for p in parts:
            nxt = node.get(p)
            if isinstance(nxt, list):
                node = nxt[-1]
            elif isinstance(nxt, dict):
                node = nxt
            else:
                node = node.setdefault(p, {})
        return node

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[["):
            parts = line[2:line.index("]]")].strip().split(".")
            parent = descend(parts[:-1])
            parent.setdefault(parts[-1], [])
            cur = {}
            parent[parts[-1]].append(cur)
        elif line.startswith("["):
            parts = line[1:line.index("]")].strip().split(".")
            parent = descend(parts[:-1])
            cur = parent.setdefault(parts[-1], {})
        else:
            key, _, val = line.partition("=")
            cur[key.strip()] = _parse_value(_strip_comment(val).strip())
    return root


async def run_spec(spec: dict, seed: int = 0,
                   buggify_override: bool | None = None,
                   device=None) -> dict:
    """Run one spec against a fresh SimulatedCluster; returns a result
    dict with per-phase workload results + restart continuity info.
    ``buggify_override`` (the CLI's --no-buggify) beats the spec file —
    triage runs must be able to isolate a failure from buggify noise.
    ``device`` is where every machine's resolvers and read mirrors, and
    any cluster a workload builds, run (the CUDA card when None)."""
    from .cluster_sim import SimulatedCluster

    cfg = spec.get("config", {})
    buggify = bool(cfg.get("buggify", True)) \
        if buggify_override is None else buggify_override
    knobs = Knobs().override(BUGGIFY_ENABLED=buggify,
                             **cfg.get("knobs", {}))
    # buggify is a process-global flag: restore it on exit, or one spec
    # run leaves fault injection armed for every later sim in the same
    # process (surfaced as replica-lag flakes in unrelated suite tests)
    from ..runtime.buggify import buggify_enabled
    prev_buggify = buggify_enabled()
    enable_buggify(buggify)
    sim = None
    try:
        n = int(cfg.get("machines", 6))
        sim = SimulatedCluster(
            knobs, n_machines=n,
            durable_storage=bool(cfg.get("durableStorage", False)),
            dcids=cfg.get("dcids"),
            spec=ClusterConfigSpec(
                min_workers=n,
                replication=int(cfg.get("replication", 2)),
                logs=int(cfg.get("logs", 2)),
                regions=[dict(r) for r in cfg["regions"]]
                if cfg.get("regions") else None),
            device=device)
        await sim.start()
        state1 = await sim.wait_epoch(1)
        db = await sim.database()

        def _phase_specs(tests: list[dict]) -> list[dict]:
            out = []
            for t in tests:
                t = dict(t)
                t["sim"] = sim      # chaos workloads opt-in to the handle
                out.append(t)
            return out

        results: dict = {"seed": seed}
        results["phase1"] = await run_workloads_on(
            db, _phase_specs(spec.get("test", [])),
            client_count=int(cfg.get("clients", 2)), device=device)

        restart = spec.get("restart")
        if restart is not None:
            results["restart"] = await _run_restart(sim, db, restart, state1)
            if restart.get("test"):
                db2 = await sim.database()
                results["phase2"] = await run_workloads_on(
                    db2, _phase_specs(restart["test"]),
                    client_count=int(cfg.get("clients", 2)), device=device)
        return results
    finally:
        # teardown runs on the failure path too (a workload assertion
        # must not leak cluster tasks), and must not mask it
        if sim is not None:
            try:
                await sim.stop()
            except Exception:  # noqa: BLE001
                TraceEvent("SpecSimStopFailed", severity=30).log()
        enable_buggify(prev_buggify)


async def _snapshot(db) -> list[tuple[bytes, bytes]]:
    tr = db.create_transaction()
    while True:
        try:
            rows = await tr.get_range(b"", b"\xff", limit=0)
            return [(bytes(a), bytes(b)) for a, b in rows]
        except Exception as e:  # noqa: BLE001 — follow recoveries
            await tr.on_error(e)


async def _run_restart(sim, old_db, restart: dict, state1: dict) -> dict:
    """The restarting/upgrade step: snapshot, whole-cluster power loss,
    restart under a bumped protocol, prove continuity."""
    from ..client.multiversion import (MultiVersionDatabase,
                                       selected_api_version, api_version)
    before = await _snapshot(old_db)
    # the multi-version client is created against the OLD cluster and
    # must survive the upgrade by re-resolving
    if selected_api_version() is None:
        api_version(710)
    mv = MultiVersionDatabase("native", old_db)

    epoch0 = (await sim.wait_state(lambda s: True))["epoch"]
    for m in sim.machines:
        await m.kill()
    if restart.get("protocolBump", True):
        sim.knobs = sim.knobs.override(
            PROTOCOL_VERSION=sim.knobs.PROTOCOL_VERSION + 1)
    for m in sim.machines:
        await m.start()
    state2 = await sim.wait_state(
        lambda s: s["epoch"] > epoch0
        and s.get("protocol") == sim.knobs.PROTOCOL_VERSION)

    out = {"old_protocol": state1.get("protocol"),
           "new_protocol": state2.get("protocol"),
           "rows": len(before)}

    # a NEW client of the new "binary" reads everything back
    db2 = await sim.database()
    after = await _snapshot(db2)
    if after != before:
        missing = len({k for k, _ in before} - {k for k, _ in after})
        raise AssertionError(
            f"restart lost/changed data: {len(before)} rows before, "
            f"{len(after)} after ({missing} missing)")

    if restart.get("protocolBump", True):
        # the PINNED old view must refuse the upgraded cluster...
        try:
            await old_db.refresh()
            raise AssertionError(
                "pinned single-version client accepted an upgraded "
                "cluster (expected cluster_version_changed)")
        except FdbError as e:
            if e.code != 1039:
                raise
        # ...while the multi-version client re-resolves and keeps going
        async def probe(tr):
            return await tr.get(before[0][0]) if before else None
        got = await mv.run(probe)
        if before:
            assert bytes(got) == before[0][1], "mv client read stale data"
        out["mv_client_switched"] = True
    return out
