"""Workload base class + factory + runner.

Reference: REF:fdbserver/workloads/workloads.actor.h (TestWorkload with
setup/start/check/getMetrics and clientId/clientCount) and
REF:fdbserver/tester.actor.cpp (phase orchestration across workloads).
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Type

from ..client.database import Database
from ..core.cluster import Cluster, ClusterConfig
from ..runtime.knobs import Knobs
from ..runtime.rng import DeterministicRandom, deterministic_random
from ..runtime.simloop import run_simulation


@dataclasses.dataclass
class WorkloadContext:
    db: Database
    client_id: int
    client_count: int
    rng: DeterministicRandom
    options: dict[str, Any]
    # where a cluster the workload builds runs its resolvers and read
    # mirrors (the CUDA card when None; ``torch.device("cpu")`` for the
    # kernels' plain versions)
    device: Any = None


class TestWorkload:
    """Override setup/start/check; report numbers via metrics()."""

    name = "base"

    def __init__(self, ctx: WorkloadContext) -> None:
        self.ctx = ctx
        self.db = ctx.db
        self.rng = ctx.rng

    def opt(self, key: str, default: Any) -> Any:
        return self.ctx.options.get(key, default)

    async def setup(self) -> None:   # populate initial data (client 0 only by convention)
        pass

    async def start(self) -> None:   # the concurrent body
        pass

    async def check(self) -> bool:   # invariant check after quiescence
        return True

    def metrics(self) -> dict[str, float]:
        return {}


_REGISTRY: dict[str, Type[TestWorkload]] = {}


def register_workload(cls: Type[TestWorkload]) -> Type[TestWorkload]:
    _REGISTRY[cls.name] = cls
    return cls


def make_workload(name: str, ctx: WorkloadContext) -> TestWorkload:
    return _REGISTRY[name](ctx)


async def run_workloads_on(db: Database, specs: list[dict[str, Any]],
                           client_count: int = 1,
                           device=None) -> dict[str, dict[str, float]]:
    """Tester phases: setup (client 0) → start (all clients concurrently)
    → check (client 0).  ``specs``: [{"testName": ..., **options}].
    ``device`` is where the clusters the workloads build run (the card
    when None)."""
    rng = deterministic_random()
    instances: list[list[TestWorkload]] = []
    for spec in specs:
        name = spec["testName"]
        opts = {k: v for k, v in spec.items() if k != "testName"}
        clients = [make_workload(name, WorkloadContext(
            db, cid, client_count, rng.split(), opts, device))
            for cid in range(client_count)]
        instances.append(clients)

    for clients in instances:
        await clients[0].setup()
    await asyncio.gather(*(w.start() for clients in instances for w in clients))
    results: dict[str, dict[str, float]] = {}
    for spec, clients in zip(specs, instances):
        ok = await clients[0].check()
        if not ok:
            raise AssertionError(f"workload {spec['testName']} check failed")
        merged: dict[str, float] = {}
        for w in clients:
            for k, v in w.metrics().items():
                merged[k] = merged.get(k, 0) + v
        results[spec["testName"]] = merged
    return results


def run_workloads(specs: list[dict[str, Any]], seed: int = 0,
                  config: ClusterConfig | None = None,
                  knobs: Knobs | None = None,
                  client_count: int = 1,
                  device=None) -> dict[str, dict[str, float]]:
    """One-call sim test run: the analog of
    ``fdbserver -r simulation -f spec.toml -s seed``, with the cluster's
    resolvers on ``device`` (the CUDA card when None)."""
    async def main():
        async with Cluster(config or ClusterConfig(), knobs or Knobs(),
                           device=device) as cluster:
            db = Database(cluster)
            return await run_workloads_on(db, specs, client_count, device)
    return run_simulation(main(), seed=seed)
