"""Structured event logging — the sole observability substrate.

Reference: REF:flow/Trace.h/.cpp (TraceEvent with .detail(k,v) chaining,
Severity levels, rolled files, rate limiting) and REF:fdbrpc/Stats.h
(Counter/CounterCollection emitting periodic *Metrics events).

We emit JSON-lines. In simulation, time comes from the virtual clock so
logs are deterministic given a seed.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time as _time
from typing import Any, Callable, Optional


def _default_clock() -> float:
    """Virtual time when called inside a running event loop, else wall time.

    This is what makes sim trace output deterministic by default: under
    run_simulation the running loop is a SimEventLoop whose time() is the
    virtual clock.
    """
    try:
        import asyncio
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return _time.time()


def _next_roll_gen(path: str) -> int:
    """Continue the .N roll sequence past any files left by a previous run."""
    gen = 0
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    try:
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    gen = max(gen, int(suffix))
    except OSError:
        pass
    return gen


class Severity:
    DEBUG = 5
    INFO = 10
    WARN = 20
    WARN_ALWAYS = 30
    ERROR = 40


class TraceLog:
    """Destination for trace events: a JSONL stream, optionally rolled."""

    def __init__(self, path: Optional[str] = None, min_severity: int = Severity.INFO,
                 clock: Optional[Callable[[], float]] = None, roll_bytes: int = 50 << 20):
        self.min_severity = min_severity
        self.clock = clock or _default_clock
        self.path = path
        self.roll_bytes = roll_bytes
        self._written = 0
        self._gen = _next_roll_gen(path) if path else 0
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOBase] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            try:
                self._written = os.path.getsize(path)
            except OSError:
                pass
            self._fh = open(path, "a", buffering=1)
        self.event_count = 0
        self.sink: Optional[Callable[[dict], None]] = None  # test hook

    def emit(self, event: dict) -> None:
        self.event_count += 1
        if self.sink is not None:
            self.sink(event)
            return
        line = json.dumps(event, separators=(",", ":"), default=str)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._written += len(line) + 1
                if self._written >= self.roll_bytes:
                    self._roll()
            else:
                sys.stderr.write(line + "\n")

    def _roll(self) -> None:
        assert self._fh is not None and self.path is not None
        self._fh.close()
        self._gen += 1
        os.replace(self.path, f"{self.path}.{self._gen}")
        self._fh = open(self.path, "a", buffering=1)
        self._written = 0

    def close(self) -> None:
        # under the write lock: a concurrent emit() must never see a
        # closed-but-not-None handle (ValueError on a live thread)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_GLOBAL = TraceLog()


def set_trace_log(log: TraceLog) -> None:
    global _GLOBAL
    _GLOBAL = log


def get_trace_log() -> TraceLog:
    return _GLOBAL


class TraceEvent:
    """``TraceEvent("CommitBatch", sev=...).detail("Txns", n).log()``.

    Also logs automatically when used as a context-less statement via
    ``__del__``-free explicit ``log()`` (we do not rely on GC, unlike the
    C++ destructor-logging idiom).
    """

    def __init__(self, type_: str, severity: int = Severity.INFO,
                 log: Optional[TraceLog] = None):
        self._log = log or _GLOBAL
        self.severity = severity
        self.fields: dict[str, Any] = {"Type": type_}

    def detail(self, key: str, value: Any) -> "TraceEvent":
        self.fields[key] = value
        return self

    def error(self, e: BaseException) -> "TraceEvent":
        self.fields["Error"] = getattr(e, "name", type(e).__name__)
        self.fields["ErrorCode"] = getattr(e, "code", 0)
        self.severity = max(self.severity, Severity.WARN)
        return self

    def log(self) -> None:
        if self.severity < self._log.min_severity:
            return
        ev = {"Time": round(self._log.clock(), 6), "Severity": self.severity}
        ev.update(self.fields)
        self._log.emit(ev)


class Counter:
    """Monotonic counter with rate; emitted via CounterCollection (REF:fdbrpc/Stats.h)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n

    def __iadd__(self, n: int) -> "Counter":
        self.value += n
        return self


class Histogram:
    """32-bucket power-of-two histogram (REF:flow/Histogram.h): bucket i
    counts samples in [2^i, 2^(i+1)) — microseconds for latency use.
    Emitted as one trace event per interval, like the reference's
    Histogram::writeToLog."""

    def __init__(self, group: str, op: str, unit: str = "microseconds"):
        self.group = group
        self.op = op
        self.unit = unit
        self.buckets = [0] * 32
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def sample(self, x: float) -> None:
        i = max(0, min(31, int(x).bit_length() - 1)) if x >= 1 else 0
        self.buckets[i] += 1
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def sample_seconds(self, seconds: float) -> None:
        self.sample(seconds * 1e6)

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket where the cumulative count crosses
        p (0..1); 0 when empty."""
        if self.count == 0:
            return 0.0
        target = p * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return float(1 << (i + 1))
        return float(1 << 32)

    def clear(self) -> None:
        self.buckets = [0] * 32
        self.count = 0
        self.total = 0.0
        self.min = self.max = None

    def log_metrics(self, log: Optional[TraceLog] = None,
                    id_: str = "") -> None:
        if self.count == 0:
            return
        ev = TraceEvent(f"Histogram{self.group}{self.op}", log=log or _GLOBAL)
        if id_:
            # instance id (the metrics plane passes its source id) so two
            # proxies' latency series don't merge in trace tooling
            ev.detail("ID", id_)
        ev.detail("Unit", self.unit).detail("Count", self.count) \
            .detail("Min", round(self.min or 0, 1)) \
            .detail("Max", round(self.max or 0, 1)) \
            .detail("Mean", round(self.total / self.count, 1)) \
            .detail("P50", self.percentile(0.5)) \
            .detail("P95", self.percentile(0.95)) \
            .detail("P99", self.percentile(0.99)).log()
        self.clear()


class CounterCollection:
    def __init__(self, name: str, id_: str = ""):
        self.name = name
        self.id = id_
        self.counters: dict[str, Counter] = {}
        self._last_values: dict[str, int] = {}
        self._last_time: Optional[float] = None

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def log_metrics(self, log: Optional[TraceLog] = None,
                    extra: Optional[dict] = None) -> None:
        """Emit one ``<Name>Metrics`` event: counter values + per-interval
        rates, plus ``extra`` details (the metrics plane folds gauge and
        meter samples in here so one series carries the whole source)."""
        lg = log or _GLOBAL
        now = lg.clock()
        ev = TraceEvent(f"{self.name}Metrics", log=lg).detail("ID", self.id)
        dt = (now - self._last_time) if self._last_time is not None else None
        for n, c in self.counters.items():
            ev.detail(n, c.value)
            if dt and dt > 0:
                ev.detail(f"{n}Rate", round((c.value - self._last_values.get(n, 0)) / dt, 3))
            self._last_values[n] = c.value
        self._last_time = now
        for k, v in (extra or {}).items():
            ev.detail(k, v)
        ev.log()
