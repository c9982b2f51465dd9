"""Async file abstraction with a kill-lossy, fault-injecting sim twin.

Reference: REF:fdbrpc/IAsyncFile.h — all durable state flows through
IAsyncFile; in simulation AsyncFileNonDurable
(REF:fdbrpc/AsyncFileNonDurable.actor.h) doesn't just *lose* writes that
were not sync()ed when the process is killed — it tears them at sector
granularity (a random subset of the dirty sectors persists), corrupts
bytes inside the torn region, and injects IO errors and latency into
live operations.  That hostile-disk model is how FDB's simulation proves
recovery against real crash semantics ("we have not lost committed data
in simulation in years", SIGMOD'21).  SimFile buffers unsynced writes
separately; a machine kill routes them through the machine's
``DiskFaultProfile`` (default: the all-or-nothing drop).

Two always-on observability pieces ride the same layer:

- ``DiskHealth`` — decayed per-op disk latency (the DecayingRate
  discipline of core/shard_load.py) per filesystem, the signal the
  gray-failure detection (a slow-but-alive disk, Huang et al. HotOS'17)
  publishes through role metrics and the FailureMonitor's ``degraded``
  state;
- ``DiskFaultInjected`` trace events for every injected fault, so a
  chaos run's fault activity is auditable from the trace file alone.

Determinism: the profile draws from its OWN seeded rng (never the
global sim stream) and a disarmed profile draws nothing at all, so
same-seed sims with every fault knob at its default stay bit-identical.

RealFile uses blocking os I/O directly: individual operations are small
and the event loop stall is bounded; an io-thread pool (the reference's
eio) can slot in behind the same interface later without changing callers.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Protocol


class IAsyncFile(Protocol):
    async def read(self, offset: int, length: int) -> bytes: ...
    async def write(self, offset: int, data: bytes) -> None: ...
    async def sync(self) -> None: ...
    async def truncate(self, size: int) -> None: ...
    def size(self) -> int: ...
    async def close(self) -> None: ...


def _now() -> float:
    """Loop time inside a running loop (VIRTUAL under simulation), wall
    monotonic outside — the shard_load._monotonic_now discipline."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


class DiskHealth:
    """Exponentially-decayed mean per-op disk latency + a degraded flag.

    Two decayed counters (ops, busy-seconds) share one timestamp; their
    ratio is the decayed mean seconds-per-op, so one historic slow op
    fades while a *sustained* stall (the gray-failure signature) holds
    the mean above ``degraded_ms``.  ``min_ops`` keeps an idle disk's
    single outlier from flagging a machine that does no disk work.
    Pure arithmetic — no RNG, no tasks — so observing health perturbs
    no same-seed trace."""

    __slots__ = ("halflife_s", "degraded_ms", "min_ops", "_ops", "_busy",
                 "_ts")

    def __init__(self, halflife_s: float = 5.0,
                 degraded_ms: float = 25.0, min_ops: float = 4.0) -> None:
        self.configure(halflife_s, degraded_ms)
        self.min_ops = min_ops
        self._ops = 0.0
        self._busy = 0.0
        self._ts: float | None = None

    def configure(self, halflife_s: float, degraded_ms: float) -> None:
        self.halflife_s = max(halflife_s, 1e-6)
        self.degraded_ms = degraded_ms

    def _decayed(self, now: float) -> tuple[float, float]:
        if self._ts is None:
            return 0.0, 0.0
        f = 0.5 ** (max(0.0, now - self._ts) / self.halflife_s)
        return self._ops * f, self._busy * f

    def observe(self, seconds: float) -> None:
        now = _now()
        self._ops, self._busy = self._decayed(now)
        self._ts = now
        self._ops += 1.0
        self._busy += max(0.0, seconds)

    def latency_ms(self) -> float:
        ops, busy = self._decayed(_now())
        return (busy / ops) * 1e3 if ops > 0 else 0.0

    @property
    def degraded(self) -> bool:
        ops, busy = self._decayed(_now())
        return ops >= self.min_ops and \
            (busy / ops) * 1e3 >= self.degraded_ms

    def snapshot(self) -> dict:
        """The metrics payload every disk-bearing role publishes."""
        return {"disk_latency_ms": round(self.latency_ms(), 3),
                "disk_degraded": self.degraded}


class DiskFaultProfile:
    """Deterministic hostile-disk model for one simulated machine.

    Armed per-machine (seeded from the sim rng when knob
    ``SIM_DISK_FAULTS`` is on, or by DiskFaultWorkload mid-run) and
    consulted by every SimFile operation plus the kill path:

    - live ops: IO errors (``io_error_p`` per op, raised as IoError so
      each role's retry loop absorbs them) and latency stalls
      (``stall_p``/``stall_max_s`` random, ``stall_floor_s`` a fixed
      per-op stall — THE slow-disk gray failure);
    - kill time: with probability ``torn_p`` the unsynced writes TEAR at
      sector granularity — each dirty sector independently persists or
      drops, and a persisted sector is garbage with ``corrupt_p`` — the
      AsyncFileNonDurable crash model (default: all-or-nothing drop).

    Synced bytes are never touched: committed data survives every
    injected fault, which is what makes "zero acked-write loss under
    chaos" a provable acceptance instead of a hope.  A disarmed profile
    draws no randomness and awaits nothing.
    """

    __slots__ = ("rng", "armed", "io_error_p", "stall_p", "stall_max_s",
                 "stall_floor_s", "torn_p", "corrupt_p", "sector",
                 "io_errors", "stalls", "torn_kills", "dropped_sectors",
                 "corrupt_sectors")

    def __init__(self) -> None:
        self.rng = None
        self.armed = False
        self.io_error_p = 0.0
        self.stall_p = 0.0
        self.stall_max_s = 0.0
        self.stall_floor_s = 0.0
        self.torn_p = 0.0
        self.corrupt_p = 0.0
        self.sector = 512
        self.io_errors = 0
        self.stalls = 0
        self.torn_kills = 0
        self.dropped_sectors = 0
        self.corrupt_sectors = 0

    def arm(self, rng, io_error_p: float = 0.0, stall_p: float = 0.0,
            stall_max_s: float = 0.0, stall_floor_s: float = 0.0,
            torn_p: float = 0.0, corrupt_p: float = 0.0,
            sector: int = 512) -> None:
        self.rng = rng
        self.io_error_p = io_error_p
        self.stall_p = stall_p
        self.stall_max_s = stall_max_s
        self.stall_floor_s = stall_floor_s
        self.torn_p = torn_p
        self.corrupt_p = corrupt_p
        self.sector = max(1, sector)
        self.armed = True

    def arm_from_knobs(self, knobs, rng) -> None:
        self.arm(rng, io_error_p=knobs.SIM_DISK_IO_ERROR_P,
                 stall_p=knobs.SIM_DISK_STALL_P,
                 stall_max_s=knobs.SIM_DISK_STALL_MAX_S,
                 torn_p=knobs.SIM_DISK_TORN_P,
                 corrupt_p=knobs.SIM_DISK_CORRUPT_P,
                 sector=knobs.SIM_DISK_SECTOR)

    def quiesce(self) -> None:
        """Stop injecting into LIVE ops (workload wind-down so the final
        consistency checks run on a quiet disk); kill-time torn/corrupt
        semantics stay armed — they model the crash itself."""
        self.io_error_p = 0.0
        self.stall_p = 0.0
        self.stall_floor_s = 0.0

    def disarm(self) -> None:
        self.armed = False

    async def before_op(self, op: str, path: str) -> None:
        """Live-op injection hook: stall, then maybe fail."""
        from .trace import TraceEvent
        stall = self.stall_floor_s
        if self.stall_p and self.rng.coinflip(self.stall_p):
            stall += self.rng.random() * self.stall_max_s
        if stall > 0.0:
            self.stalls += 1
            TraceEvent("DiskFaultInjected").detail("Kind", "stall") \
                .detail("Op", op).detail("Path", path) \
                .detail("StallMs", round(stall * 1e3, 3)).log()
            await asyncio.sleep(stall)
        if self.io_error_p and self.rng.coinflip(self.io_error_p):
            self.io_errors += 1
            from .errors import IoError
            TraceEvent("DiskFaultInjected").detail("Kind", "io_error") \
                .detail("Op", op).detail("Path", path).log()
            raise IoError(f"injected {op} error on {path}")

    def tear(self, synced: bytearray, pending: list, path: str) -> None:
        """Kill-time torn write: apply a random sector-granular subset
        of the unsynced ops to the synced image, corrupting some of the
        surviving sectors.  Mutates ``synced`` in place.  Only sectors
        the pending ops actually dirtied can change — synced-clean
        sectors always survive byte-identical."""
        from .trace import TraceEvent
        old = bytes(synced)
        new = bytearray(old)
        SimFile._replay(new, pending)
        if bytes(new) == old:
            return
        sec = self.sector
        length = max(len(old), len(new))
        oldp = old.ljust(length, b"\x00")
        newp = bytes(new).ljust(length, b"\x00")
        out = bytearray(oldp)
        rng = self.rng
        dropped = corrupted = kept = 0
        for s in range(0, length, sec):
            oc, nc = oldp[s:s + sec], newp[s:s + sec]
            if oc == nc:
                continue
            if rng.coinflip(0.5):       # this dirty sector made it to disk
                kept += 1
                if self.corrupt_p and rng.coinflip(self.corrupt_p):
                    out[s:s + sec] = rng.random_bytes(len(nc))
                    corrupted += 1
                else:
                    out[s:s + sec] = nc
            else:
                dropped += 1
        # file length is metadata with its own torn fate: either the
        # pending ops' final length or the synced one (never below both,
        # so no synced byte is ever silently shortened)
        end = len(new) if rng.coinflip(0.5) else len(old)
        synced[:] = out[:end]
        self.torn_kills += 1
        self.dropped_sectors += dropped
        self.corrupt_sectors += corrupted
        TraceEvent("DiskFaultInjected").detail("Kind", "torn_write") \
            .detail("Path", path).detail("KeptSectors", kept) \
            .detail("DroppedSectors", dropped) \
            .detail("CorruptSectors", corrupted).log()

    def stats(self) -> dict:
        return {"io_errors": self.io_errors, "stalls": self.stalls,
                "torn_kills": self.torn_kills,
                "dropped_sectors": self.dropped_sectors,
                "corrupt_sectors": self.corrupt_sectors}


class RealFile:
    def __init__(self, path: str, health: DiskHealth | None = None) -> None:
        self.path = path
        self.health = health
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)

    def _observe(self, t0: float) -> None:
        if self.health is not None:
            self.health.observe(time.monotonic() - t0)

    async def read(self, offset: int, length: int) -> bytes:
        t0 = time.monotonic()
        out = os.pread(self._fd, length, offset)
        self._observe(t0)
        return out

    def read_sync(self, offset: int, length: int) -> bytes:
        """Synchronous block read — the LSM engine's page-cache path
        (bounded block-sized stalls, same caveat as the class docstring)."""
        return os.pread(self._fd, length, offset)

    async def write(self, offset: int, data: bytes) -> None:
        t0 = time.monotonic()
        os.pwrite(self._fd, data, offset)
        self._observe(t0)

    async def sync(self) -> None:
        t0 = time.monotonic()
        os.fsync(self._fd)
        self._observe(t0)

    async def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    async def close(self) -> None:
        os.close(self._fd)


class SimFile:
    """In-memory file whose unsynced writes vanish (or TEAR) on kill."""

    def __init__(self, fs: "SimFileSystem", path: str) -> None:
        self.fs = fs
        self.path = path
        # synced: survives kill.  _pending: ordered op log since last sync
        # — ("w", offset, data) and ("t", size, b"") must interleave in
        # program order or a truncate could chop later appends.
        if path not in fs.disks:
            fs.disks[path] = bytearray()
        self._pending: list[tuple[str, int, bytes]] = []

    @property
    def health(self) -> DiskHealth:
        return self.fs.health

    @staticmethod
    def _replay(buf: bytearray, ops) -> None:
        for kind, arg, data in ops:
            if kind == "w":
                if len(buf) < arg + len(data):
                    buf.extend(b"\x00" * (arg + len(data) - len(buf)))
                buf[arg:arg + len(data)] = data
            else:
                del buf[arg:]

    def _view(self) -> bytes:
        """Content as a reader would see it (synced + pending)."""
        buf = bytearray(self.fs.disks[self.path])
        self._replay(buf, self._pending)
        return bytes(buf)

    def read_sync(self, offset: int, length: int) -> bytes:
        # the page-cache path: no fault injection (it cannot await a
        # stall) — the async surfaces carry the whole fault model
        v = self._view()
        return bytes(v[offset:offset + length])

    async def read(self, offset: int, length: int) -> bytes:
        await self.fs._disk_op("read", self.path)
        v = self._view()
        return v[offset:offset + length]

    async def write(self, offset: int, data: bytes) -> None:
        await self.fs._disk_op("write", self.path)
        self._pending.append(("w", offset, bytes(data)))

    async def sync(self) -> None:
        await self.fs._disk_op("sync", self.path)
        self._replay(self.fs.disks[self.path], self._pending)
        self._pending.clear()

    async def truncate(self, size: int) -> None:
        await self.fs._disk_op("truncate", self.path)
        self._pending.append(("t", size, b""))

    def size(self) -> int:
        return len(self._view())

    async def close(self) -> None:
        pass  # unsynced writes remain pending-lost, like a closed-then-killed fd


class SimFileSystem:
    """Shared simulated disk: path → synced bytes.  kill_unsynced()
    models machine loss (AsyncFileNonDurable semantics, optionally torn
    and corrupted through the attached DiskFaultProfile)."""

    def __init__(self, profile: DiskFaultProfile | None = None) -> None:
        self.disks: dict[str, bytearray] = {}
        self._open: list[SimFile] = []
        self.profile = profile
        self.health = DiskHealth()

    async def _disk_op(self, op: str, path: str) -> None:
        """Per-op hook: fault injection + latency accounting.  With no
        armed profile this awaits nothing and draws nothing — the
        default-off path is schedule-identical to the pre-fault layer."""
        prof = self.profile
        if prof is None or not prof.armed:
            self.health.observe(0.0)
            return
        t0 = _now()
        try:
            await prof.before_op(op, path)
        finally:
            self.health.observe(_now() - t0)

    def open(self, path: str) -> SimFile:
        f = SimFile(self, path)
        self._open.append(f)
        return f

    def kill_unsynced(self) -> None:
        """The machine died: every open file's unsynced writes are gone —
        or, with a fault profile armed, torn at sector granularity with
        possible bit corruption of the dirty region (never of synced
        bytes)."""
        prof = self.profile
        for f in self._open:
            if f._pending and prof is not None and prof.armed \
                    and prof.rng is not None and prof.torn_p > 0 \
                    and prof.rng.coinflip(prof.torn_p):
                prof.tear(self.disks[f.path], f._pending, f.path)
            f._pending.clear()

    def listdir(self, prefix: str) -> list[str]:
        return sorted(p for p in self.disks if p.startswith(prefix))

    def remove(self, path: str) -> None:
        self.disks.pop(path, None)
        self._open = [f for f in self._open if f.path != path]


class RealFileSystem:
    """Real-disk twin of SimFileSystem (RealFile-backed, rooted)."""

    def __init__(self, root: str = ".") -> None:
        self.root = root
        self.health = DiskHealth()

    def open(self, path: str) -> RealFile:
        return RealFile(os.path.join(self.root, path), health=self.health)

    def listdir(self, prefix: str) -> list[str]:
        base = os.path.join(self.root, prefix)
        d = base if os.path.isdir(base) else os.path.dirname(base)
        if not os.path.isdir(d):
            return []
        rel = os.path.relpath(d, self.root)
        out = []
        for name in os.listdir(d):
            p = name if rel == "." else os.path.join(rel, name)
            if p.startswith(prefix):
                out.append(p)
        return sorted(out)

    def remove(self, path: str) -> None:
        try:
            os.remove(os.path.join(self.root, path))
        except FileNotFoundError:
            pass
