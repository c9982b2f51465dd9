"""Flow-style concurrency helpers over asyncio.

Reference: REF:flow/genericactors.actor.h — waitForAll, choose/when,
timeoutError, ActorCollection.  asyncio's primitives cover most of it;
these wrappers give the FDB-shaped API the roles are written against and
keep cancellation semantics consistent (dropping a Future cancels the
actor, like Flow).
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Coroutine, Iterable, TypeVar

from .errors import TimedOut, BrokenPromise

T = TypeVar("T")


async def wait_for_all(futs: Iterable[Awaitable[T]]) -> list[T]:
    return list(await asyncio.gather(*futs))


async def timeout_error(aw: Awaitable[T], seconds: float) -> T:
    """Raise TimedOut (FDB error 1004) if aw does not finish in time."""
    try:
        return await asyncio.wait_for(asyncio.ensure_future(aw), seconds)
    except asyncio.TimeoutError:
        raise TimedOut() from None


async def delay(seconds: float) -> None:
    await asyncio.sleep(seconds)


def now() -> float:
    return asyncio.get_running_loop().time()


class Promise:
    """Single-assignment variable; the consumer side is ``.future``.

    Mirrors Flow's Promise/Future pair (REF:flow/flow.h SAV<T>), except
    drop-detection: Flow sends broken_promise when the last Promise copy is
    destroyed; here the owner must call ``break_promise()`` explicitly (we
    do not rely on GC finalizers).  An abandoned waiter surfaces as
    SimQuiescenceError in simulation rather than hanging silently.

    The underlying asyncio.Future is created lazily on first ``.future``
    access so a Promise may be constructed before the (sim) loop exists
    and sent from plain code; it binds to the loop of its first awaiter.
    """

    _UNSET = object()

    def __init__(self) -> None:
        self._fut: asyncio.Future | None = None
        self._value: Any = self._UNSET
        self._error: BaseException | None = None

    def send(self, value: Any = None) -> None:
        if self._fut is not None:
            if not self._fut.done():
                self._fut.set_result(value)
        elif self._value is self._UNSET and self._error is None:
            self._value = value

    def send_error(self, err: BaseException) -> None:
        if self._fut is not None:
            if not self._fut.done():
                self._fut.set_exception(err)
        elif self._value is self._UNSET and self._error is None:
            self._error = err

    def break_promise(self) -> None:
        self.send_error(BrokenPromise())

    @property
    def future(self) -> asyncio.Future:
        if self._fut is None:
            self._fut = asyncio.get_running_loop().create_future()
            if self._error is not None:
                self._fut.set_exception(self._error)
            elif self._value is not self._UNSET:
                self._fut.set_result(self._value)
        return self._fut

    def is_set(self) -> bool:
        if self._fut is not None:
            return self._fut.done()
        return self._value is not self._UNSET or self._error is not None


class PromiseStream:
    """Unbounded typed stream (REF:flow/flow.h PromiseStream<T>)."""

    def __init__(self) -> None:
        self._q: asyncio.Queue = asyncio.Queue()
        self._closed_err: BaseException | None = None

    def send(self, value: Any) -> None:
        if self._closed_err is None:
            self._q.put_nowait(value)

    def send_error(self, err: BaseException) -> None:
        self._closed_err = err
        self._q.put_nowait(_StreamError(err))

    def close(self) -> None:
        """Cleanly end the stream; async-for consumers exit their loop."""
        self.send_error(EndOfStream())

    async def recv(self) -> Any:
        v = await self._q.get()
        if isinstance(v, _StreamError):
            self._q.put_nowait(v)  # keep rethrowing for other readers
            raise v.err
        return v

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except EndOfStream:
            raise StopAsyncIteration from None
        # Real stream errors (send_error) propagate to the async-for body.


class EndOfStream(Exception):
    """Clean close marker for PromiseStream (maps to StopAsyncIteration)."""


class _StreamError:
    def __init__(self, err: BaseException):
        self.err = err


class ActorCollection:
    """Owns a set of background tasks; cancelling the collection cancels all.

    Mirrors REF:flow/genericactors.actor.h ActorCollection: errors in any
    child surface on ``wait_for_error()``.
    """

    def __init__(self) -> None:
        self._tasks: set[asyncio.Task] = set()
        self._error = Promise()

    def add(self, coro: Coroutine) -> asyncio.Task:
        t = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._done)
        return t

    def _done(self, t: asyncio.Task) -> None:
        self._tasks.discard(t)
        if t.cancelled():
            return
        e = t.exception()
        if e is not None:
            self._error.send_error(e)

    async def wait_for_error(self) -> None:
        await self._error.future

    def cancel_all(self) -> None:
        for t in list(self._tasks):
            t.cancel()

    async def aclose(self) -> None:
        self.cancel_all()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
