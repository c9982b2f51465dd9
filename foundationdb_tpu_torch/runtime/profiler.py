"""Slow-task profiler — catches event-loop stalls and attributes them.

Reference: REF:flow/Profiler.actor.cpp — the reference samples the
program counter when the Flow event loop runs one task for longer than a
threshold, emitting a trace with the offending stack.  Same instrument
here, asyncio-shaped: a watchdog THREAD watches a heartbeat the loop
refreshes every tick; when the heartbeat goes stale past
``SLOW_TASK_THRESHOLD`` the watchdog captures the loop thread's current
Python stack via ``sys._current_frames`` and emits one
``SlowTask`` TraceEvent with the duration and the innermost frames.

The reference's single-threaded-event-loop discipline makes this the
race-free observability primitive: a stall IS a bug (a coroutine doing
blocking work on the loop), and the stack names it.  Under the
virtual-time simulator the profiler is a no-op — virtual time never
stalls and extra threads would break determinism.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time
import traceback

from .knobs import Knobs
from .trace import TraceEvent


def _meter_clock() -> float:
    """The running event loop's clock when one exists, else monotonic.

    The ``_default_clock`` pattern from trace.py: on a real asyncio loop
    ``loop.time()`` IS the monotonic clock, so behavior is unchanged —
    but under ``SimEventLoop`` it is the virtual clock, so a RateMeter's
    ``per_sec`` measures virtual-time work against virtual time instead
    of clocking wall seconds against instantly-advancing sim work
    (which made every sim-run rate gauge nonsense)."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


class RateMeter:
    """Hot-path throughput counter: total count, batch count, and
    clock rate — no locks, no per-event timestamps, safe to bump
    from the apply path at millions of events/sec.  The storage role
    uses one for ``mutations_applied`` so an apply-throughput regression
    (the r5 O(n²) index collapse) shows up as a falling rate in status
    instead of a bench timeout."""

    _WINDOW_S = 5.0

    __slots__ = ("name", "count", "batches", "_t0", "_m0", "_m1", "_clock")

    def __init__(self, name: str, clock=None) -> None:
        self.name = name
        self.count = 0
        self.batches = 0
        self._clock = clock or _meter_clock
        self._t0 = self._clock()
        # rolling window marks (time, count): per_sec is measured against
        # a 5-10s trailing mark, NOT a per-reader delta — multiple pollers
        # (ratekeeper, status) would otherwise shrink each other's window
        # to nothing, and a lifetime average would dilute a stall on a
        # long-lived server to noise
        self._m0 = (self._t0, 0)
        self._m1 = (self._t0, 0)

    def add(self, n: int) -> None:
        self.count += n
        self.batches += 1

    def snapshot(self) -> dict:
        now = self._clock()
        if now < self._t0:
            # clock base changed under us: constructed before a virtual-
            # time loop existed (monotonic anchor), sampled inside it
            # (virtual now).  Re-anchor instead of dividing the whole
            # count by the 1e-9 clamp — rates read 0 for one interval,
            # then measure virtual time like everything else.
            self._t0 = now
            self._m0 = (now, self.count)
            self._m1 = (now, self.count)
        if now - self._m1[0] >= self._WINDOW_S:
            self._m0 = self._m1
            self._m1 = (now, self.count)
        t0, c0 = self._m0
        dt_recent = now - t0
        dt_life = now - self._t0
        recent = (self.count - c0) / dt_recent if dt_recent > 1e-9 else 0.0
        return {
            "count": self.count,
            "batches": self.batches,
            "per_sec": round(recent, 1),
            "per_sec_lifetime":
                round(self.count / dt_life, 1) if dt_life > 1e-9 else 0.0,
            "mean_batch": round(self.count / self.batches, 1)
            if self.batches else 0.0,
        }


# the process's live profiler (set by start(), cleared by stop()): roles
# splat stall_metrics() into their metrics() replies so the r5-class
# event-loop-occupancy incident reaches the status rollup at one glance
# instead of living only in the SlowTask trace events
_ACTIVE: "SlowTaskProfiler | None" = None


def active_profiler() -> "SlowTaskProfiler | None":
    return _ACTIVE


def stall_metrics() -> dict:
    """The process's slow-task counters for role metrics() surfaces:
    empty when no profiler is armed (sim runs — virtual time never
    stalls), so knob-default sim metrics stay byte-identical."""
    p = _ACTIVE
    if p is None or p._watchdog is None:
        return {}
    return {
        "slow_task_stalls": p.stalls,
        "slow_task_last_stall_ms":
            round((p.last_stall_s or 0.0) * 1e3, 1),
    }


class SlowTaskProfiler:
    """Watchdog for one asyncio event loop (the production loop)."""

    def __init__(self, knobs: Knobs | None = None,
                 threshold: float | None = None) -> None:
        k = knobs or Knobs()
        self.threshold = threshold if threshold is not None \
            else k.SLOW_TASK_THRESHOLD
        self.interval = max(self.threshold / 4, 0.005)
        self._beat = time.monotonic()
        self._loop_thread_id: int | None = None
        self._stop = threading.Event()
        self._heartbeat_task: asyncio.Task | None = None
        self._watchdog: threading.Thread | None = None
        self.stalls = 0                 # total stalls caught
        self.last_stall_s: float | None = None

    # --- loop side ---

    async def _heartbeat(self) -> None:
        while not self._stop.is_set():
            self._beat = time.monotonic()
            await asyncio.sleep(self.interval)

    def start(self) -> "SlowTaskProfiler":
        global _ACTIVE
        from .simloop import SimEventLoop
        loop = asyncio.get_running_loop()
        if isinstance(loop, SimEventLoop):
            return self             # no-op under the simulator (see module doc)
        self._loop_thread_id = threading.get_ident()
        self._beat = time.monotonic()
        self._heartbeat_task = loop.create_task(
            self._heartbeat(), name="slow-task-heartbeat")
        self._watchdog = threading.Thread(
            target=self._watch, daemon=True, name="slow-task-watchdog")
        self._watchdog.start()
        _ACTIVE = self
        return self

    def stop(self) -> None:
        global _ACTIVE
        self._stop.set()
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        if _ACTIVE is self:
            _ACTIVE = None

    # --- watchdog thread ---

    def _watch(self) -> None:
        # On detection the watchdog captures the loop thread's stack (the
        # culprit is mid-stall, so the frame names it); the event is
        # emitted when the heartbeat RESUMES, carrying the whole stall's
        # duration rather than the duration at detection time.
        stall_stack: str | None = None
        stall_beat = 0.0
        while not self._stop.is_set():
            time.sleep(self.interval)
            stale = time.monotonic() - self._beat
            if stale >= self.threshold:
                if stall_stack is None or self._beat > stall_beat:
                    stall_beat = self._beat
                    frame = sys._current_frames().get(self._loop_thread_id)
                    stall_stack = "".join(
                        traceback.format_stack(frame, limit=8)) \
                        if frame is not None else "<no frame>"
                continue
            if stall_stack is not None:
                # the stall just ended: heartbeat resumed
                duration = self._beat - stall_beat
                self.stalls += 1
                self.last_stall_s = duration
                # Begin/End ride the MONOTONIC clock — the same base a
                # real asyncio loop's time() (and hence every span
                # event's Time) uses.  The event's own Time field comes
                # from the watchdog THREAD where no loop runs, so it
                # falls back to wall time; trace_tool's SlowTask↔span
                # overlap join must use these fields, not Time.
                TraceEvent("SlowTask", severity=30) \
                    .detail("DurationMs", round(duration * 1e3, 1)) \
                    .detail("BeginMonotonic", round(stall_beat, 6)) \
                    .detail("EndMonotonic", round(self._beat, 6)) \
                    .detail("Stack", stall_stack[-2000:]).log()
                stall_stack = None
