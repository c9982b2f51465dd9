"""The closed loop the window drives: a fleet of proxies keeps the
resolver fed.

Groups of ``group`` wire batches go to
``foundationdb_tpu_torch.ops.backends.resolve_group_wire_begin``;
``inflight`` groups stay in flight, and the next group goes in as the
oldest one's verdicts come back (the loop of the port's
``bench/north_star.py::measure_grouped``).  The stream is replayed pass
after pass; each pass starts on a fresh conflict history
(``reset_ring``), so every pass's verdicts are the reference's for one
pass.

Each group is timed by the host clock: handed to the entry (``t_sub``),
the entry returned (``t_ret``), its verdicts back on the host
(``t_done``).  A group's verdicts are kept as one int8 array, so what
the window holds for the check grows by no Python object a batch.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import time

import numpy as np


@dataclasses.dataclass
class Group:
    pos: int                # the group's place in the pass
    t_sub: float
    t_ret: float
    n_upd: int | None       # endpoint rows the dictionary shipped
    t_done: float = 0.0
    verdicts: np.ndarray | None = None  # [group, B] int8; -1: none came


def host_verdicts(got, group: int, txns: int) -> np.ndarray:
    """A group's verdicts as the entry returned them (a list of one list
    a batch) -> int8 [group, txns]; a batch that came back short, or not
    at all, reads -1."""
    if len(got) == group and all(len(v) == txns for v in got):
        return np.fromiter(itertools.chain.from_iterable(got), np.int8,
                           count=group * txns).reshape(group, txns)
    out = np.full((group, txns), -1, dtype=np.int8)
    for k, v in enumerate(got[:group]):
        if len(v) == txns:
            out[k] = v
    return out


class Loop:
    def __init__(self, backend, wires: list, versions: list[int],
                 group: int, inflight: int) -> None:
        if len(wires) % group:
            raise ValueError(f"a stream of {len(wires)} batches is not "
                             f"whole groups of {group}")
        from foundationdb_tpu_torch.ops.backends import \
            resolve_group_wire_begin
        self._begin = resolve_group_wire_begin
        self.backend = backend
        self.wires = wires
        self.versions = [int(v) for v in versions]
        self.group = group
        self.inflight = inflight
        self.per_pass = len(wires) // group
        self.txns = wires[0].count if wires else 0
        self.pos = 0

    def _submit(self, span):
        if self.pos == 0:
            self.backend.reset_ring(0)      # a pass starts on fresh history
        lo, hi = self.pos * self.group, (self.pos + 1) * self.group
        t_sub = time.perf_counter()
        with span("kvbench.enqueue"):
            aw = self._begin(self.backend, self.wires[lo:hi],
                             self.versions[lo:hi])
        t_ret = time.perf_counter()
        enc = getattr(self.backend, "_dict", None)
        g = Group(self.pos, t_sub, t_ret, getattr(enc, "n_upd", None))
        self.pos = (self.pos + 1) % self.per_pass
        return g, aw

    def run(self, seconds: float | None = None, groups: int | None = None,
            span=None) -> tuple[list[Group], float, float]:
        """Submit groups until ``seconds`` have passed (or ``groups``
        groups went in), then wait for those in flight.  Returns the
        groups and the window's start and end on the host clock.
        ``span(name)`` wraps the entry and each wait (a profiler
        annotation in a traced run)."""
        span = span or (lambda name: contextlib.nullcontext())

        async def go():
            done: list[Group] = []
            pending: collections.deque = collections.deque()
            t0 = time.perf_counter()
            deadline = t0 + seconds if seconds is not None else None

            async def finish_oldest():
                g, aw = pending.popleft()
                with span("kvbench.wait"):
                    got = await aw
                g.t_done = time.perf_counter()
                g.verdicts = host_verdicts(got, self.group, self.txns)

            while groups is None or len(done) < groups:
                if len(pending) >= self.inflight:
                    await finish_oldest()
                if deadline is not None and time.perf_counter() >= deadline:
                    break
                g, aw = self._submit(span)
                done.append(g)
                pending.append((g, aw))
            while pending:
                await finish_oldest()
            return done, t0, time.perf_counter()

        return asyncio.run(go())
