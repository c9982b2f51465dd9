"""Wire-propagated distributed span contexts — cross-role transaction tracing.

Reference: REF:fdbclient/NativeAPI.actor.cpp ``debugTransaction`` — the
reference attributes a sampled transaction's latency across roles by
propagating one debug ID with every request and emitting
``TransactionDebug`` / ``CommitDebug`` events keyed by that ID at each
role boundary (GRV queue/reply, commit batch, resolution, TLog push,
storage read).  That is the Dapper span-propagation model: a trace id
plus a parent span id travel in the RPC envelope; every hop logs point
events the offline analyzer (tools/trace_tool.py, modeled on the
reference's transaction_profiling_analyzer) stitches into one
cross-role timeline.

Design constraints honored here:

- **Determinism**: sampling decisions come from the client's existing
  counter-based TraceBatch sampler (runtime/latency_probe.py) — no RNG
  draws, so seeded simulation streams are unperturbed.  Span ids come
  from a process-local counter; they never feed scheduling.
- **Zero cost unsampled**: an unsampled request carries nothing — the
  transports only build a ``SpanEnvelope`` when a sampled context is
  active, and every role-side emit site is a ``ctx is None`` check.
- **One substrate**: span events are ordinary TraceEvents (JSONL), so
  sim trace output stays deterministic and the analyzer needs only the
  rolled trace files.

Propagation is a contextvar: the client activates its root context
around an RPC; transports wrap the payload in a ``SpanEnvelope``;
``RequestDispatcher.dispatch`` unwraps it and re-activates the context
around the handler, so role code just calls ``current_span()``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import itertools
from typing import Any, Optional

from .trace import Severity, TraceEvent

_CURRENT: contextvars.ContextVar[Optional["SpanContext"]] = \
    contextvars.ContextVar("fdbtpu_span", default=None)

# process-local span id source: ids label events, never drive
# scheduling, so this stays outside the deterministic RNG on purpose
_ids = itertools.count(1)

# process-wide rollup (reset per test/sim run via reset_totals)
TOTALS = {"sampled_txns": 0, "spans_emitted": 0, "dropped_spans": 0}


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """What travels with a request: which trace, which parent span."""
    trace_id: int
    span_id: int
    parent_id: int = 0
    sampled: bool = True


@dataclasses.dataclass
class SpanEnvelope:
    """RPC payload wrapper carrying the sender's span context over the
    wire (registered as a wire struct in rpc/wire.py).  Transports build
    one only for sampled contexts; the dispatcher unwraps it before the
    handler sees the payload."""
    trace_id: int
    span_id: int
    parent_id: int
    payload: Any


_SALT: int | None = None


def _trace_salt() -> int:
    """High bits mixed into root trace ids so two client PROCESSES of
    one real cluster cannot collide (each starts its probe counter at
    0).  Under the virtual-time simulator the salt is always 0: every
    sim client shares one process, and a pid/wall-time salt would break
    same-seed bit-identical trace output."""
    import asyncio
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    from .simloop import SimEventLoop
    if loop is not None and isinstance(loop, SimEventLoop):
        return 0
    global _SALT
    if _SALT is None:
        import os
        import time
        _SALT = ((os.getpid() & 0xFFFF) << 32) \
            | ((int(time.time()) & 0xFFFF) << 48)
    return _SALT


def new_root(trace_id: int) -> SpanContext:
    """Client-side root span for a sampled transaction (the moment the
    TraceBatch sampler fires)."""
    TOTALS["sampled_txns"] += 1
    return SpanContext(_trace_salt() | trace_id, next(_ids), 0, True)


def new_server_root(seq: int, namespace: int = 1) -> SpanContext:
    """Server-side root for a request that arrived WITHOUT a sampled
    client context (GRV-only / read-only-heavy clients, feed-stream
    consumers).  ``namespace`` keeps the
    serving role's trace ids disjoint from client probe counters (and
    from other roles') in one process: client roots use the low bits
    raw, so any namespace >= 1 shifted past them cannot collide."""
    TOTALS["sampled_txns"] += 1
    return SpanContext(_trace_salt() | ((namespace & 0xFF) << 24) | seq,
                       next(_ids), 0, True)


class ServerSampler:
    """Deterministic counter-based 1-in-N server-side root sampling —
    the one home of the period arithmetic every serving role shares
    (GRV proxy, feed streams).  ``root()`` returns a fresh root context
    on sampled requests, None otherwise; never draws from the seeded
    RNG, so sim streams are unperturbed."""

    __slots__ = ("namespace", "count")

    def __init__(self, namespace: int) -> None:
        self.namespace = namespace
        self.count = 0

    def root(self, sample_rate: float) -> SpanContext | None:
        if sample_rate <= 0:
            return None
        self.count += 1
        period = max(1, round(1 / sample_rate))
        if self.count % period:
            return None
        return new_server_root(self.count, self.namespace)


def child_of(ctx: SpanContext) -> SpanContext:
    """A new span under ``ctx`` — created at explicit role-boundary
    forwarding sites (client→GRV, proxy→resolver, proxy→TLog, ...)."""
    return SpanContext(ctx.trace_id, next(_ids), ctx.span_id, ctx.sampled)


def current_span() -> SpanContext | None:
    return _CURRENT.get()


def activate(ctx: SpanContext | None) -> contextvars.Token:
    return _CURRENT.set(ctx)


def deactivate(token: contextvars.Token) -> None:
    _CURRENT.reset(token)


class child_scope:
    """Activate a child span of ``ctx`` for the scope (no-op when ctx is
    None) — the one home of the activate/child_of/deactivate dance every
    role-boundary hop needs; a hand-rolled copy that forgets the reset
    leaks the contextvar across batches."""

    def __init__(self, ctx: SpanContext | None) -> None:
        self._ctx = ctx
        self._tok = None

    def __enter__(self) -> SpanContext | None:
        if self._ctx is None:
            return None
        child = child_of(self._ctx)
        self._tok = _CURRENT.set(child)
        return child

    def __exit__(self, *exc):
        if self._tok is not None:
            _CURRENT.reset(self._tok)
        return False


class no_span:
    """Context manager masking the active span — REQUIRED around
    ``create_task`` for any long-lived worker spawned lazily from a
    request path: the task copies the caller's context at creation, so
    without the mask a batching loop would attribute every later
    request's downstream RPCs to the first sampled transaction that
    happened to spawn it."""

    def __enter__(self):
        self._tok = _CURRENT.set(None)
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tok)
        return False


def attach(payload: Any) -> Any:
    """Wrap an outbound RPC payload with the active sampled context (the
    transports' envelope hook); unsampled requests pass through as-is."""
    ctx = _CURRENT.get()
    if ctx is None or not ctx.sampled:
        return payload
    return SpanEnvelope(ctx.trace_id, ctx.span_id, ctx.parent_id, payload)


def detach(payload: Any) -> tuple[Any, SpanContext | None]:
    """Dispatcher-side unwrap: (inner payload, context or None)."""
    if isinstance(payload, SpanEnvelope):
        return payload.payload, SpanContext(payload.trace_id,
                                            payload.span_id,
                                            payload.parent_id, True)
    return payload, None


def fmt_trace(trace_id: int) -> str:
    return f"{trace_id:016x}"


def reset_totals() -> None:
    """Reset the rollup AND the span-id counter — a harness re-running
    a seeded sim in one process needs ids to restart or the second
    run's trace JSONL differs from the first despite the same seed."""
    global _ids
    for k in TOTALS:
        TOTALS[k] = 0
    _ids = itertools.count(1)
    from .latency_probe import EVICTIONS_TOTAL
    EVICTIONS_TOTAL["probe_evictions"] = 0


def process_counters() -> dict:
    """The process-wide trace-plane loss/volume counters under stable
    metric names: span TOTALS plus the TraceBatch
    probe-eviction rollup.  Splatted into every role's ``metrics()`` —
    status dedupes per process by address, the slow-task discipline —
    so silent probe/span loss under load finally shows up in the
    tracing rollup.  Key names deliberately avoid the per-role
    ``spans_emitted``/``spans_dropped`` of ``SpanSink.counters()``."""
    from .latency_probe import EVICTIONS_TOTAL
    return {"span_sampled_txns": TOTALS["sampled_txns"],
            "span_totals_emitted": TOTALS["spans_emitted"],
            "span_totals_dropped": TOTALS["dropped_spans"],
            "probe_evictions": EVICTIONS_TOTAL["probe_evictions"]}


class SpanSink:
    """Per-role span emitter: a role holds one and calls ``event`` at
    its boundaries; it counts what it emitted (surfaced via the role's
    ``metrics()`` and the cluster_status tracing rollup)."""

    __slots__ = ("role", "emitted", "dropped")

    def __init__(self, role: str) -> None:
        self.role = role
        self.emitted = 0
        # spans this role had to drop (e.g. a second sampled txn in a
        # commit batch whose downstream hops are keyed to the first)
        self.dropped = 0

    def event(self, type_: str, ctx: SpanContext | None, location: str,
              severity: int = Severity.INFO, **details: Any) -> None:
        """Emit one span point event iff ``ctx`` is a sampled context.

        Schema: Type (TransactionDebug/CommitDebug), TraceID (hex),
        SpanID, ParentID, Role, Location, plus free-form details —
        exactly what tools/trace_tool.py reconstructs timelines from."""
        if ctx is None or not ctx.sampled:
            return
        from .trace import get_trace_log
        if severity < get_trace_log().min_severity:
            # the log would drop it — don't count a span that never
            # reached the file, or the status rollup overstates
            return
        ev = TraceEvent(type_, severity=severity) \
            .detail("TraceID", fmt_trace(ctx.trace_id)) \
            .detail("SpanID", ctx.span_id) \
            .detail("ParentID", ctx.parent_id) \
            .detail("Role", self.role) \
            .detail("Location", location)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()
        self.emitted += 1
        TOTALS["spans_emitted"] += 1

    def drop(self, n: int = 1) -> None:
        self.dropped += n
        TOTALS["dropped_spans"] += n

    def counters(self) -> dict:
        return {"spans_emitted": self.emitted, "spans_dropped": self.dropped}
