"""The C-ABI host: a thread-confined client runtime with blocking entry
points, driven by ``bindings/c/fdbtpu_c.cpp`` (in this package) through
the CPython API.  It is a client: it takes no device and never touches
the CUDA card.

Reference: the role of fdb_c's network thread (REF:bindings/c/fdb_c.cpp
runNetwork) — one background thread owns the event loop and every binding
call marshals onto it.  ``Host`` methods are called from arbitrary C
threads (under the GIL) and block on ``run_coroutine_threadsafe``;
``concurrent.futures.Future.result`` releases the GIL while waiting, so
callers never deadlock the loop thread.
"""

from __future__ import annotations

import asyncio
import itertools
import threading

from .client.transaction import Transaction
from .core.cluster_client import RecoveredClusterView, fetch_cluster_state
from .core.cluster_file import ClusterFile
from .rpc.stubs import CoordinatorClient
from .rpc.tcp_transport import TcpTransport
from .rpc.transport import NetworkAddress, WLTOKEN_COORDINATOR
from .runtime.errors import FdbError, error_from_code
from .runtime.knobs import Knobs

_C_CLIENT_PORT = itertools.count(1)


class Host:
    """One per process; owns the loop thread and the transaction table."""

    def __init__(self, cluster_file: str, connect_timeout: float = 30.0):
        self.knobs = Knobs()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fdbtpu-c-network")
        self._thread.start()
        self._txns: dict[int, Transaction] = {}
        self._txn_ids = itertools.count(1)
        self._view = self._call(self._open(cluster_file, connect_timeout))

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    async def _open(self, cluster_file: str, timeout: float):
        cf = ClusterFile.parse(cluster_file) if "@" in cluster_file \
            else ClusterFile.load(cluster_file)
        t = TcpTransport(NetworkAddress("127.0.0.1", 0))
        self._coords = [CoordinatorClient(t, a, WLTOKEN_COORDINATOR)
                        for a in cf.coordinators]
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            try:
                state = await fetch_cluster_state(self._coords)
                break
            except (FdbError, OSError):
                if asyncio.get_running_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.5)
        return RecoveredClusterView(self.knobs, t, state)

    # --- the C surface (each returns (err_code, payload...)) ---

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    def create_transaction(self) -> int:
        tid = next(self._txn_ids)
        self._txns[tid] = Transaction(self._view)
        return tid

    def destroy_transaction(self, tid: int) -> None:
        self._txns.pop(tid, None)

    @staticmethod
    def _code(e: BaseException) -> int:
        return e.code if isinstance(e, FdbError) else 4100  # internal_error

    def txn_get(self, tid: int, key: bytes):
        """-> (err, present, value|b'')"""
        tr = self._txns[tid]
        try:
            v = self._call(tr.get(key))
        except BaseException as e:  # noqa: BLE001 — code crosses the ABI
            return self._code(e), 0, b""
        return 0, (1 if v is not None else 0), v or b""

    def txn_set(self, tid: int, key: bytes, value: bytes) -> int:
        try:
            self._call(self._sync(self._txns[tid].set, key, value))
        except BaseException as e:  # noqa: BLE001
            return self._code(e)
        return 0

    def txn_clear(self, tid: int, key: bytes) -> int:
        try:
            self._call(self._sync(self._txns[tid].clear, key))
        except BaseException as e:  # noqa: BLE001
            return self._code(e)
        return 0

    @staticmethod
    async def _sync(fn, *args):
        return fn(*args)

    def txn_get_range(self, tid: int, begin: bytes, end: bytes,
                      limit: int, reverse: int):
        """-> (err, packed, count); packed = ([u32 klen][key][u32 vlen]
        [value]) * count, little-endian — one flat buffer crossing the
        ABI (the fdb_c FDBKeyValue array analog)."""
        import struct
        tr = self._txns[tid]
        try:
            rows = self._call(tr.get_range(begin, end, limit=limit,
                                           reverse=bool(reverse)))
        except BaseException as e:  # noqa: BLE001 — code crosses the ABI
            return self._code(e), b"", 0
        out = bytearray()
        for k, v in rows:
            k, v = bytes(k), bytes(v)
            out += struct.pack("<I", len(k)) + k
            out += struct.pack("<I", len(v)) + v
        return 0, bytes(out), len(rows)

    def txn_atomic_op(self, tid: int, op: int, key: bytes,
                      operand: bytes) -> int:
        from .core.data import ATOMIC_TYPES, MutationType
        try:
            mt = MutationType(op)
        except ValueError:
            return 2007  # invalid_option (unknown mutation opcode)
        if mt not in ATOMIC_TYPES:
            # SET_VALUE/CLEAR_RANGE ride their own entry points, and
            # private opcodes (shard drops) must never cross the ABI —
            # a forged one would be client-triggered data loss
            return 2007
        try:
            self._call(self._sync(self._txns[tid].atomic_op, mt, key,
                                  operand))
        except BaseException as e:  # noqa: BLE001
            return self._code(e)
        return 0

    def txn_get_read_version(self, tid: int):
        """-> (err, version)"""
        try:
            v = self._call(self._txns[tid].get_read_version())
        except BaseException as e:  # noqa: BLE001
            return self._code(e), -1
        return 0, v

    def txn_set_option(self, tid: int, option: str) -> int:
        """fdb_transaction_set_option analog (named, no packed ints)."""
        if option == "lock_aware":
            self._txns[tid].lock_aware = True
            return 0
        return 2007  # invalid_option

    def txn_commit(self, tid: int):
        """-> (err, committed_version)"""
        tr = self._txns[tid]
        try:
            self._call(tr.commit())
            return 0, tr.get_committed_version()
        except BaseException as e:  # noqa: BLE001
            return self._code(e), -1

    def txn_on_error(self, tid: int, code: int) -> int:
        tr = self._txns[tid]
        try:
            self._call(tr.on_error(error_from_code(code)))
            return 0
        except BaseException as e:  # noqa: BLE001
            return self._code(e)

    def txn_reset(self, tid: int) -> int:
        self._txns[tid].reset()
        return 0


_HOST: Host | None = None


def init(cluster_file: str) -> int:
    """C entry: start the runtime.  Returns an error code (0 ok)."""
    global _HOST
    if _HOST is not None:
        return 2201  # network_already_setup
    try:
        _HOST = Host(cluster_file)
    except BaseException as e:  # noqa: BLE001
        return e.code if isinstance(e, FdbError) else 4100
    return 0


def stop() -> int:
    global _HOST
    if _HOST is not None:
        _HOST.stop()
        _HOST = None
    return 0


def host() -> Host:
    assert _HOST is not None, "fdbtpu_init() not called"
    return _HOST


def error_message(code: int) -> str:
    try:
        return error_from_code(code).name
    except Exception:  # noqa: BLE001
        return f"error_{code}"
