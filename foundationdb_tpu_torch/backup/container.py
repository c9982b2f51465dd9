"""BackupContainer — the versioned on-disk layout of a feed-native backup.

Reference: REF:fdbclient/BackupContainer.actor.cpp — a backup is a
directory of *range files* (a consistent key-value cut, each file read
at one pinned version) plus *mutation-log files*, described by
manifests; restore chooses the newest snapshot at or below the target
version and replays the log window above it.

Layout (format 2, the feed-native container):

- ``snap-<version>-<idx>.kvr`` — one packed snapshot page: rows stored
  COLUMNAR as a sorted key blob + little-endian cumulative u32 bounds
  and a value blob + bounds (the ``MutationBatch``/``GetValuesReply``
  shape), never a per-row tuple list;
- ``snap-<version>.manifest`` — one snapshot's file list + row/byte
  counts (a container holds MANY snapshots; periodic backups append);
- ``log-<first>-<last>-<seq>.mlog`` — one flush of whole-db change-feed
  entries: ``[(version, types, bounds, blob), ...]`` packed triples,
  exactly the retained ``MutationBatch`` columns;
- ``logs.manifest`` — the mutation log's state: the feed id, ``begin``
  (the feed registration version — mutations strictly above it are
  captured), ``through`` (the durably-logged frontier, THE agent resume
  token), and the file list;
- ``container.manifest`` — the layout format version.

Every file is a crc32-stamped frame (u32 length + u32 crc + payload):
a torn write from a killed agent fails the checksum instead of decoding
into garbage rows.  Manifests are written AFTER the files they name are
synced, so a manifest never names a file whose bytes could be lost.
"""

from __future__ import annotations

import struct
import zlib

from ..core.data import MutationBatch, Version
from ..rpc.wire import decode, encode
from ..runtime.errors import FdbError

__all__ = ["BackupContainer", "ContainerError", "pack_rows", "unpack_rows",
           "keyspace_digest"]

CONTAINER_FORMAT = 2
_FRAME_HDR = struct.Struct("<II")      # payload length, crc32(payload)


class ContainerError(FdbError):
    code = 2382
    name = "backup_container_error"


def keyspace_digest(rows) -> str:
    """Canonical sha256 of a keyspace — THE byte-identity definition the
    restore-to-version acceptance keys on, shared by the tests, the
    bench's backup_restore stage, and the perf smoke so they can never
    verify three different identities: length-prefixed key and value
    bytes in key order."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted((bytes(k), bytes(v)) for k, v in rows):
        h.update(len(k).to_bytes(4, "little") + k)
        h.update(len(v).to_bytes(4, "little") + v)
    return h.hexdigest()


def pack_rows(rows) -> tuple[bytes, bytes, bytes, bytes]:
    """[(key, value), ...] (sorted by key — snapshot pages arrive sorted
    from the range read) -> (key_bounds, key_blob, val_bounds, val_blob).

    A ``PackedRows`` page (the packed range replies' columns)
    passes its columns through VERBATIM — the zero-copy path the backup
    snapshot writer rides; a tuple list packs here (PackedRows.from_rows
    is the ONE home of the column layout, so the two paths can never
    produce different bytes)."""
    from ..core.data import PackedRows
    if isinstance(rows, PackedRows):
        return (rows.key_bounds, rows.key_blob,
                rows.val_bounds, rows.val_blob)
    p = PackedRows.from_rows(rows)
    return p.key_bounds, p.key_blob, p.val_bounds, p.val_blob


def unpack_rows(ko: bytes, kblob: bytes, vo: bytes,
                vblob: bytes) -> list[tuple[bytes, bytes]]:
    """Inverse of ``pack_rows`` — PackedRows owns BOTH halves of the
    column layout, so the .kvr reader can never diverge from the
    writer."""
    from ..core.data import PackedRows
    return PackedRows(ko, kblob, vo, vblob).rows()


class BackupContainer:
    """One backup directory over an async filesystem (Sim or Real)."""

    def __init__(self, fs, directory: str) -> None:
        self.fs = fs
        self.dir = directory.rstrip("/")
        self._log_sb = None     # lazily-armed SlottedBlob (resume token)

    def _path(self, name: str) -> str:
        return f"{self.dir}/{name}"

    # --- crc-framed file IO ---

    async def _write_file(self, name: str, payload: bytes) -> int:
        """Truncate-write one frame and fsync; returns bytes written."""
        f = self.fs.open(self._path(name))
        await f.truncate(0)
        frame = _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload
        await f.write(0, frame)
        await f.sync()
        return len(frame)

    async def _read_file(self, name: str) -> bytes:
        f = self.fs.open(self._path(name))
        raw = await f.read(0, f.size())
        if len(raw) < _FRAME_HDR.size:
            raise ContainerError(f"truncated frame in {name}")
        length, crc = _FRAME_HDR.unpack_from(raw)
        payload = raw[_FRAME_HDR.size:_FRAME_HDR.size + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            raise ContainerError(f"crc mismatch in {name}")
        return payload

    async def init(self) -> None:
        """Stamp the container's layout format (idempotent)."""
        f = self.fs.open(self._path("container.manifest"))
        if f.size() > 0:
            meta = decode(await self._read_file("container.manifest"))
            if meta.get("format", 0) > CONTAINER_FORMAT:
                raise ContainerError(
                    f"container format {meta['format']} is newer than "
                    f"this binary's {CONTAINER_FORMAT}")
            return
        await self._write_file("container.manifest",
                               encode({"format": CONTAINER_FORMAT}))

    # --- snapshots ---

    async def write_snapshot_page(self, version: Version, idx: int,
                                  rows: list) -> tuple[str, int]:
        """One pinned-version page as a packed columnar file; returns
        (file name, payload bytes)."""
        ko, kb, vo, vb = pack_rows(rows)
        name = f"snap-{version:020d}-{idx:06d}.kvr"
        n = await self._write_file(name, encode(
            {"v": int(version), "n": len(rows),
             "ko": ko, "kb": kb, "vo": vo, "vb": vb}))
        return name, n

    async def read_snapshot_page(self, name: str
                                 ) -> tuple[Version, list]:
        rec = decode(await self._read_file(name))
        rows = unpack_rows(bytes(rec["ko"]), bytes(rec["kb"]),
                           bytes(rec["vo"]), bytes(rec["vb"]))
        if len(rows) != rec["n"]:
            raise ContainerError(f"row count mismatch in {name}")
        return rec["v"], rows

    async def finish_snapshot(self, version: Version, files: list[str],
                              rows: int, nbytes: int) -> dict:
        """Write the snapshot's manifest (the snapshot becomes visible to
        restore only now — files first, manifest last)."""
        meta = {"version": int(version), "files": list(files),
                "rows": int(rows), "bytes": int(nbytes)}
        await self._write_file(f"snap-{version:020d}.manifest", encode(meta))
        return meta

    async def list_snapshots(self) -> list[dict]:
        """Every completed snapshot's manifest, oldest first."""
        out: list[dict] = []
        prefix = self._path("snap-")
        for p in self.fs.listdir(prefix):
            if not p.endswith(".manifest"):
                continue
            name = p[len(self.dir) + 1:]
            try:
                out.append(decode(await self._read_file(name)))
            except Exception:  # noqa: BLE001 — torn manifest: not a snapshot
                continue
        out.sort(key=lambda m: m["version"])
        return out

    async def latest_snapshot_at_or_below(self, target: Version
                                          ) -> dict | None:
        best = None
        for m in await self.list_snapshots():
            if m["version"] <= target:
                best = m
        return best

    # --- mutation log ---

    async def write_log_file(self, first: Version, last: Version, seq: int,
                             entries: list) -> tuple[str, int]:
        """One flush of cursor entries [(version, MutationBatch)] as one
        crc frame of packed triples; returns (name, payload bytes)."""
        name = f"log-{first:020d}-{last:020d}-{seq:06d}.mlog"
        n = await self._write_file(name, encode(
            {"e": [(int(v), b.types, b.bounds, b.blob)
                   for v, b in entries]}))
        return name, n

    async def read_log_file(self, name: str
                            ) -> list[tuple[Version, MutationBatch]]:
        rec = decode(await self._read_file(name))
        return [(v, MutationBatch(bytes(t), bytes(bo), bytes(bl)))
                for v, t, bo, bl in rec["e"]]

    def _log_slots(self):
        """The resume token's dual-slot persist — the shared
        rpc/wire.py ``SlottedBlob`` helper,
        built lazily so a read-only container never arms a writer."""
        from ..rpc.wire import SlottedBlob
        if self._log_sb is None:
            self._log_sb = SlottedBlob(self.fs, self._path("logs.manifest"))
        return self._log_sb

    async def save_log_manifest(self, meta: dict) -> None:
        """THE resume token write.  Alternating crc-framed slots: the
        manifest used to be rewritten in place, so an agent killed
        mid-write tore the ONLY copy and the container became
        unresumable after a legitimate crash.  The slot-turn / seq
        discipline is the shared SlottedBlob's."""
        sb = self._log_slots()
        if sb._seq is None:
            # arm the alternation from whatever format is on disk
            # (load always leaves _seq armed, legacy slots included —
            # _load_log_manifest_any seeds it from their embedded seq)
            await self._load_log_manifest_any()
        await sb.save(encode(dict(meta)))

    async def _load_log_manifest_any(self) -> dict | None:
        """Newest valid slot (or a pre-helper format); raises
        ContainerError when slots exist but NONE decodes — a completed
        save always leaves the older slot intact through any kill, so
        that state is corruption of the committed resume token, and
        guessing a frontier would break exactly-once."""
        sb = self._log_slots()
        payload, found = await sb.load()
        if payload is not None:
            return decode(payload)
        best = None
        for name in ("logs.manifest.a", "logs.manifest.b"):
            # pre-helper slot format: crc-framed dict with embedded seq
            if self.fs.open(self._path(name)).size() == 0:
                continue
            try:
                meta = decode(await self._read_file(name))
            except Exception:  # noqa: BLE001 — torn slot: other one wins
                continue
            if best is None or meta.get("seq", 0) > best.get("seq", 0):
                best = meta
        if best is not None:
            # keep the alternation continuous across the envelope
            # migration (never clobber the only valid slot)
            sb.seed(best.get("seq", 0))
            return best
        if self.fs.open(self._path("logs.manifest")).size() > 0:
            found += 1
            try:
                return decode(await self._read_file("logs.manifest"))
            except ContainerError:
                pass
        if found:
            raise ContainerError(
                f"no readable logs.manifest among {found} slots in "
                f"{self.dir} — the mutation log's resume token is "
                f"damaged; refusing to guess a frontier")
        return None

    async def load_log_manifest(self) -> dict | None:
        return await self._load_log_manifest_any()

    # --- expiration / GC (the expireData discipline of
    # REF:fdbclient/BackupContainer.actor.cpp) ---

    async def expire_data_before(self, version: Version) -> dict:
        """Drop snapshots and mutation-log file prefixes that NO restore
        target at or after ``version`` can need, and rewrite the
        manifests so nothing ever names a deleted file.

        A target ``t >= version`` restores from the newest snapshot at
        or below ``t`` and replays ``(snapshot, t]`` — so the newest
        snapshot at or below ``version`` (the KEEP snapshot) is the
        oldest state any such target can touch: every older snapshot,
        and every ``.mlog`` file whose span ends at or below the keep
        version, is garbage.  Later snapshots and the log's resume
        token (``through``) are untouched, so a live continuous backup
        keeps resuming exactly-once.

        REFUSES (ContainerError, nothing deleted) when no snapshot
        exists at or below ``version``: there is then no restore point
        anchoring the log window, and cutting the log prefix anyway
        would orphan the container's only resumable frontier — the
        caller believes targets >= ``version`` are safe while nothing
        below the NEXT snapshot (which may never come) could ever be
        restored again.

        Deletion order mirrors the write discipline in reverse:
        manifests stop naming the files FIRST (snapshot manifests
        removed, logs.manifest rewritten), then the data files go — a
        crash in between leaves unreferenced files (harmless orphans),
        never a manifest pointing at missing bytes.

        While a continuous backup is LIVE, expire through
        ``BackupAgent.expire_data_before`` — the agent is the
        manifest's only writer while tailing and serializes its
        in-memory file list on every flush, so a container-level
        expire alone would be undone by the next flush re-naming the
        deleted files."""
        snaps = await self.list_snapshots()
        keep = None
        for m in snaps:
            if m["version"] <= version:
                keep = m
        if keep is None:
            raise ContainerError(
                f"refusing to expire before {version}: no snapshot at or "
                f"below it — dropping the log prefix would orphan the "
                f"container's only resumable frontier")
        keep_v = keep["version"]
        dead_snaps = [m for m in snaps if m["version"] < keep_v]
        log = await self.load_log_manifest()
        dead_logs: list[tuple] = []
        if log is not None:
            kept_files = []
            for first, last, name in log["files"]:
                (dead_logs if last <= keep_v else kept_files).append(
                    (first, last, name))
            if dead_logs:
                log["files"] = [[f, l, n] for f, l, n in kept_files]
                log["expired_before"] = int(keep_v)
                await self.save_log_manifest(log)
        # manifests no longer name anything below: delete the bytes
        for m in dead_snaps:
            self.fs.remove(self._path(f"snap-{m['version']:020d}.manifest"))
            for name in m["files"]:
                self.fs.remove(self._path(str(name)))
        for _f, _l, name in dead_logs:
            self.fs.remove(self._path(str(name)))
        return {
            "expired_before": int(version),
            "kept_snapshot": int(keep_v),
            "dropped_snapshots": len(dead_snaps),
            "dropped_log_files": len(dead_logs),
        }

    # --- observability / tools ---

    async def describe(self) -> dict:
        snaps = await self.list_snapshots()
        log = await self.load_log_manifest()
        return {
            "format": CONTAINER_FORMAT,
            "snapshots": [{"version": m["version"], "rows": m["rows"],
                           "bytes": m["bytes"], "files": len(m["files"])}
                          for m in snaps],
            "log_begin": log and log.get("begin"),
            "log_through": log and log.get("through"),
            "log_files": len(log["files"]) if log else 0,
            "log_bytes": (log or {}).get("bytes", 0),
        }
