"""Deterministic virtual-time asyncio event loop — the Sim2 replacement.

Reference: REF:fdbrpc/sim2.actor.cpp + REF:flow/Net2.actor.cpp — FDB swaps
the real network (Net2) for a simulator (Sim2) behind the INetwork
interface; simulated time advances instantly to the next timer, so an
entire multi-machine cluster run takes wall-milliseconds and is exactly
reproducible from a seed.

Here the swap point is the asyncio event loop itself: ``SimEventLoop``
subclasses ``asyncio.SelectorEventLoop`` with a selector that never touches
the OS — ``select(timeout)`` *advances the virtual clock* instead of
sleeping, and ``loop.time()`` returns virtual time.  All simulated network
and disk I/O is in-memory (see rpc/sim_transport.py), so no real file
descriptors are ever waited on.  asyncio's ready-queue and timer-heap
scheduling are FIFO/stable, so runs are deterministic given a seeded RNG.
"""

from __future__ import annotations

import asyncio
import selectors
from typing import Any, Coroutine

from .rng import DeterministicRandom, set_deterministic_random


class SimQuiescenceError(RuntimeError):
    """The simulation has no runnable or scheduled work but the main task is unfinished."""


class _VirtualSelector(selectors.BaseSelector):
    """A selector that advances virtual time rather than blocking."""

    def __init__(self) -> None:
        self.loop: "SimEventLoop | None" = None
        self._map: dict[int, selectors.SelectorKey] = {}

    def register(self, fileobj, events, data=None):
        key = selectors.SelectorKey(fileobj, self._fd(fileobj), events, data)
        self._map[key.fd] = key
        return key

    def unregister(self, fileobj):
        return self._map.pop(self._fd(fileobj), None)

    def _fd(self, fileobj) -> int:
        return fileobj if isinstance(fileobj, int) else fileobj.fileno()

    def select(self, timeout=None):
        assert self.loop is not None
        if timeout is None:
            # No timers and nothing ready: the sim is quiesced.
            raise SimQuiescenceError(
                "simulation deadlock: no runnable tasks and no pending timers")
        if timeout > 0:
            self.loop._vtime += timeout
        return []

    def get_map(self):
        return self._map

    def close(self):
        self._map.clear()


class SimEventLoop(asyncio.SelectorEventLoop):
    def __init__(self) -> None:
        sel = _VirtualSelector()
        super().__init__(selector=sel)
        sel.loop = self
        self._vtime = 0.0
        # asyncio clamps selector timeouts to 24h (MAXIMUM_SELECT_TIMEOUT);
        # that is fine — long delays just take several _run_once passes.

    def time(self) -> float:
        return self._vtime

    # Real-world side effects are forbidden under simulation.
    def run_in_executor(self, executor, func, *args):  # pragma: no cover
        raise RuntimeError("run_in_executor is not allowed in simulation")


def run_simulation(main: Coroutine[Any, Any, Any], seed: int = 0,
                   install_global_rng: bool = True) -> Any:
    """Run ``main`` to completion on a fresh virtual-time loop.

    The analog of ``fdbserver -r simulation -s <seed>``: a seed fully
    determines scheduling, latencies, and faults.
    """
    if install_global_rng:
        set_deterministic_random(DeterministicRandom(seed))
        from .buggify import reset_buggify_sites
        reset_buggify_sites()
    loop = SimEventLoop()
    try:
        return loop.run_until_complete(main)
    finally:
        # Cancel leftovers so closing the loop is clean and deterministic.
        # all_tasks() is a set (address-ordered); sort by task name so the
        # cancellation order is reproducible across runs.
        def _task_key(t: asyncio.Task):
            name = t.get_name()
            if name.startswith("Task-"):
                try:
                    return (0, int(name[5:]), name)
                except ValueError:
                    pass
            return (1, 0, name)

        pending = sorted(asyncio.all_tasks(loop), key=_task_key)
        for t in pending:
            t.cancel()
        if pending:
            try:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            except SimQuiescenceError:
                pass
        loop.close()
